"""Head dims that qtpu runs and the port's kernels do not all take: a
2-layer llama at head_dim 80 (hidden 640, 8 heads, as OPT-2.7B's 2560 / 32)
and 96 (hidden 768, 8 heads, 4 kv heads) against qtpu on the CPU, on the
same numpy-made weights and packed bytes.

qtpu runs XLA attention wherever its Pallas kernels do not take the shape
(qtpu/models/ops.py:133-157). The port asks each kernel from the shape
(`flash_attention.supported`: 64 or 128; `kv_attention.decode_supported`: a
multiple of 32 up to 128; `flash_supported`: 32, 64 or 128) and runs the
plain version of the ones that refuse, counted in
`ops.plain_attention.launches`: at hd 80 K5, K3's kernel and K12 all refuse,
at hd 96 only K5 and K12. The count is the same on the card
(tests/test_torch_gpu.py runs these shapes there).

Tolerance: 2e-2 relative Frobenius error of the f32 logits (bf16 layers,
other sum orders), each decode step fed qtpu's token and qtpu's cache as it
stood, so no step inherits the other package's roundings (the int8 codes
that differ by up to 2, ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qtpu.models import llama as jllama
from qtpu.models.config import ModelConfig as JCfg
from qtpu.quant import apply as japply
from qtpu.serve import kvcache as jkv
from qtpu_torch.convert import params_to_torch, to_torch
from qtpu_torch.kernels import flash_attention as k5
from qtpu_torch.kernels import kv_attention as k23
from qtpu_torch.models import llama as tllama
from qtpu_torch.models import ops
from qtpu_torch.models.config import ModelConfig as TCfg
from qtpu_torch.serve import kvcache as tkv
from test_torch_quant import _np_params, one_torch_thread  # noqa: F401  (a fixture)

LOGIT_TOL = 2e-2
SHAPES = {80: dict(hidden_size=640, num_heads=8, num_kv_heads=8, head_dim=80),
          96: dict(hidden_size=768, num_heads=8, num_kv_heads=4, head_dim=96)}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


@pytest.fixture(scope="module", params=list(SHAPES))
def model(request):
    """(hd, qtpu cfg, port cfg, qtpu raw params, port raw params, qtpu's
    fused RTN W4 g64 artifact and qmeta, the same artifact on the port)."""
    kw = dict(vocab_size=512, intermediate_size=1024, num_layers=2, max_seq_len=512,
              **SHAPES[request.param])
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    p = _np_params(tcfg, seed=4)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pkj, qj = japply.fuse_packed_sites(*japply.pack_model(pj, "rtn", {"w_bit": 4,
                                                                       "q_group_size": 64}))
    pkt = params_to_torch(jax.tree_util.tree_map(np.asarray, pkj), device="cpu")
    return request.param, jcfg, tcfg, pj, params_to_torch(p, device="cpu"), pkj, qj, pkt


def test_the_routes_name_the_kernels_that_take_the_head_dim():
    assert not k5.supported(80) and not k5.supported(96) and k5.supported(64)
    assert not k23.decode_supported(80, 1) and k23.decode_supported(96, 2)
    assert k23.decode_supported(128, 32) and not k23.decode_supported(128, 33)
    assert not k23.flash_supported(80) and not k23.flash_supported(96)
    assert k23.flash_supported(32)


def test_forward_matches_qtpu(model):
    """The cacheless forward (eval, calibration): K5's plain version on each
    of the 2 layers."""
    hd, jcfg, tcfg, pj, pt, *_ = model
    ids = np.random.default_rng(7).integers(0, 512, (2, 24)).astype(np.int32)
    want = jllama.forward(pj, jnp.asarray(ids), jcfg)
    n0 = ops.plain_attention.launches
    got = tllama.forward(pt, cpu(ids), tcfg)
    assert _rel(got.numpy(), want) < LOGIT_TOL
    assert ops.plain_attention.launches - n0 == tcfg.num_layers


def _port_cache(cj):
    """qtpu's cache as the port's, stacked or per-layer."""
    def t(a):
        if a is None:
            return None
        return tuple(cpu(np.asarray(x)) for x in a) if isinstance(a, tuple) else cpu(np.asarray(a))
    return tkv.KVCache(t(cj.k), t(cj.v), t(cj.k_scale), t(cj.v_scale), t(cj.length))


@pytest.mark.parametrize("kv,per_layer", [("int8", False), ("bfloat16", False),
                                          ("int8", True)])
def test_packed_prefill_and_decode_match_qtpu(model, kv, per_layer):
    """qtpu's artifact on both packages' forward_with_cache: a prefill of 12
    and 3 decode steps on the int8 and bf16 stacked caches and the per-layer
    int8 cache at S 2048 (K12's layout). Decode's plain-attention calls as
    reckoned from the shape: per step one a layer where the step's kernel
    refuses hd (K3's kernel on the stacked caches at hd 80, K12 at both)."""
    hd, jcfg, tcfg, _, _, pkj, qj, pkt = model
    B, P, S = 2, 12, 2048 if per_layer else 32
    ids = np.random.default_rng(8).integers(0, 512, (B, P)).astype(np.int32)
    pos = np.arange(P, dtype=np.int32)[None].repeat(B, 0)
    cj = jkv.init_cache(jcfg, B, S, quantized=kv == "int8", per_layer=per_layer)
    takes = (k23.flash_supported(hd) if per_layer
             else k23.decode_supported(hd, tcfg.num_heads // tcfg.num_kv_heads))
    for step in range(4):
        n0 = ops.plain_attention.launches
        lt, _ = tllama.forward_with_cache(pkt, cpu(ids), cpu(pos), _port_cache(cj), tcfg, qj)
        plain = ops.plain_attention.launches - n0
        lj, cj = jllama.forward_with_cache(pkj, jnp.asarray(ids), jnp.asarray(pos), cj, jcfg, qj)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL, step
        # prefill attends with the plain cached attention (no kernel: uncounted)
        assert plain == (0 if step == 0 or takes else tcfg.num_layers), (step, plain)
        ids = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
