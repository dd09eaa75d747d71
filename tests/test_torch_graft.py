"""qtpu_torch.bench.graft (the port of __graft_entry__.py) on the CPU:
entry()'s forward step on a TINY_TEST packing against qtpu's forward on
the same bytes, and dryrun_multichip on 4 and 8 gloo ranks:
rank 0 prints qtpu's ok line, and the tensor-parallel logits of the data
shards are held to qtpu's unsharded forward on the same packed params.

Tolerances: the forward's f32 logits within 2e-2 relative Frobenius
(tests/test_torch_synth.py), the TP logits within rtol = atol = 2e-2
(qtpu's tests/test_sharding.py bound, tests/test_torch_sharding.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import llama as jllama
from qtpu.models.config import TINY_TEST as J_TINY
from qtpu_torch.bench import graft
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models.config import TINY_TEST, TINYLLAMA_1_1B
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

LOGIT_TOL = 2e-2
TP_TOL = 2e-2


def test_entry_forward_equals_qtpus_on_the_same_bytes():
    """fn on TINY_TEST's packing (fused W4 g128 sites, the qmeta qtpu's
    synth gives, tests/test_torch_synth.py) against qtpu's forward on the
    same bytes moved through numpy."""
    fn, (packed, ids) = graft.entry(TINY_TEST, device="cpu")
    assert tuple(ids.shape) == (1, graft.ENTRY_TOKENS) and not ids.any()
    assert {s for s, _ in fn.qmeta} >= {"qkv_proj", "gateup_proj"}
    assert all(m[:2] == (4, 128) for _, m in fn.qmeta)
    got = fn(packed, ids).numpy()
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(packed))
    want = np.asarray(jllama.forward(jp, jnp.asarray(ids.numpy()), J_TINY, qmeta=fn.qmeta))
    assert got.shape == (1, graft.ENTRY_TOKENS, TINY_TEST.vocab_size)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < LOGIT_TOL


def test_entry_defaults_to_tinyllama_on_the_card(monkeypatch):
    seen = {}

    def fake(cfg, w_bit, group, device):
        seen.update(cfg=cfg, w_bit=w_bit, group=group, device=device)
        return {}, ()

    monkeypatch.setattr("qtpu_torch.bench.synth.tiled_packed_llama", fake)
    monkeypatch.setattr(torch, "zeros", lambda shape, dtype, device: (shape, dtype, device))
    fn, (_, ids) = graft.entry()
    assert seen == {"cfg": TINYLLAMA_1_1B, "w_bit": 4, "group": 128, "device": "cuda"}
    assert ids == ((1, 128), torch.int32, "cuda") and fn.cfg is TINYLLAMA_1_1B


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_prints_ok_and_tp_logits_match_qtpu(n, capsys):
    """qtpu's seven steps over n ranks (data n/2 x model 2; the 3-axis
    pipeline at 8): rank 0 prints the ok line; the data shards' TP logits
    (model rank 0 of each) within TP_TOL of qtpu's forward on the same
    RTN W4 g64 bytes, the model ranks equal."""
    from qtpu_torch.models import llama
    from qtpu_torch.quant.apply import pack_model

    res = graft.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    dp = n // 2
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip ok")]
    assert len(line) == 1 and line[0] == res[0]["line"]
    assert f"mesh data={dp} x model=2" in line[0] and "over seq=4" in line[0]
    assert ("data=2 x pipe=2 x model=2 nll ok" in line[0]) == (n >= 8)
    assert res[0]["pipe_nll"].shape == (2,) and bool(res[0]["pipe_nll"].isfinite().all())
    params = llama.init_params(TINY_TEST, seed=0, device="cpu")
    packed, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64})
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(packed))
    ids = res[0]["ids"].numpy()
    want = np.asarray(jllama.forward(jp, jnp.asarray(ids), J_TINY, qmeta=qmeta))
    got = np.concatenate([res[2 * d]["tp_logits"].numpy() for d in range(dp)])
    np.testing.assert_allclose(got, want, rtol=TP_TOL, atol=TP_TOL)
    for d in range(dp):
        np.testing.assert_array_equal(res[2 * d + 1]["tp_logits"], res[2 * d]["tp_logits"])
