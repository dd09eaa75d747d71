"""qtpu_torch.bench.scaling (the port of qtpu/bench/scaling.py) on the CPU,
as qtpu's tests/test_scaling.py runs qtpu's: the sweep over data x model
meshes of 1, 2 and 4 gloo ranks on TINY_TEST, RTN W4 g64, with qtpu's
schema; and (1, 4), tp 4 over TINY_TEST's 2 KV heads, which the port runs
by holding each rank's KV head whole. The efficiency of ranks sharing the
CPU means nothing (qtpu says the same of its virtual mesh); what is held is
the decode: every shape's greedy tokens equal the one-rank run's, and its
logits are within rtol = atol = 2e-2 (qtpu's TP bound, tests/test_torch_
sharding.py) of qtpu's unsharded prefill and decode_step on the same bytes,
fed the same tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qtpu.models.config import TINY_TEST as J_TINY
from qtpu.serve import init_cache as jinit_cache
from qtpu.serve.decode import decode_step as jdecode_step
from qtpu.serve.decode import prefill as jprefill
from qtpu_torch.bench.scaling import scaling_sweep
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models import llama
from qtpu_torch.models.config import TINY_TEST
from qtpu_torch.quant.apply import pack_model
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

SHAPES = ((1, 1), (2, 1), (2, 2), (1, 4))
B, PROMPT, STEPS = 2, 16, 4  # qtpu's test: batch_per_data_shard 2, prompt 16, 4 steps
TP_TOL = 2e-2


@pytest.fixture(scope="module")
def sweep():
    params = llama.init_params(TINY_TEST, seed=0, device="cpu")
    packed, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64})
    records = {}
    rows = scaling_sweep(packed, TINY_TEST, qmeta, mesh_shapes=SHAPES, records=records,
                         batch_per_data_shard=B, prompt_len=PROMPT, n_steps=STEPS)
    return rows, records, packed, qmeta


def test_rows_have_qtpus_schema(sweep):
    rows, *_ = sweep
    assert len(rows) == len(SHAPES)
    for row, (dp, tp) in zip(rows, SHAPES):
        assert set(row) == {"mesh", "devices", "tokens_per_second", "scaling_efficiency"}
        assert row["mesh"] == {"data": dp, "model": tp} and row["devices"] == dp * tp
        assert row["tokens_per_second"] > 0 and row["scaling_efficiency"] > 0
    assert rows[0]["scaling_efficiency"] == 1.0


def _qtpu_logits(jp, qmeta, rows, tokens):
    """qtpu's unsharded prefill of rows and decode steps fed `tokens`:
    the logits [B, STEPS + 3, V] each token was drawn from."""
    cache = jinit_cache(J_TINY, B, PROMPT + STEPS + 8, quantized=True)
    logits, cache = jprefill(jp, jnp.asarray(rows), cache, J_TINY, qmeta)
    want = [np.asarray(logits)]
    for i in range(STEPS + 2):
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        logits, cache = jdecode_step(jp, jnp.asarray(tokens[:, i]), pos, cache, J_TINY, qmeta)
        want.append(np.asarray(logits))
    return np.stack(want, 1)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_sharded_decode_tokens_and_logits(sweep, shape):
    """Each data shard's rows: the model ranks give the same tokens, data
    shard 0's are the one-rank run's (the prompt's first rows are the same
    draw), and the logits are within TP_TOL of qtpu's unsharded decode fed
    the same tokens."""
    _, records, packed, qmeta = sweep
    dp, tp = shape
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(packed))
    prompt = np.random.default_rng(0).integers(0, TINY_TEST.vocab_size, (B * dp, PROMPT))
    for d in range(dp):
        first = records[shape][d * tp]
        for m in range(1, tp):
            np.testing.assert_array_equal(records[shape][d * tp + m]["tokens"], first["tokens"])
        if d == 0:
            np.testing.assert_array_equal(first["tokens"], records[(1, 1)][0]["tokens"])
        want = _qtpu_logits(jp, qmeta, prompt[d * B:(d + 1) * B], first["tokens"].numpy())
        for m in range(tp):
            np.testing.assert_allclose(records[shape][d * tp + m]["logits"].numpy(), want,
                                       rtol=TP_TOL, atol=TP_TOL)


def test_a_shape_above_the_world_raises():
    import torch.distributed as dist

    from qtpu_torch.bench.scaling import _sweep_here

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _sweep_here({}, TINY_TEST, None, ((2, 1),), 1, {})
