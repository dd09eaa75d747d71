"""Head dims qtpu runs beside 64 and 128: a 2-layer llama at head_dim 80
(hidden 640, 8 heads, as OPT-2.7B's 2560 / 32) and 96 (hidden 768, 8 heads,
4 kv heads), and a 2-layer OPT at head_dim 80 (hidden 640, 8 heads),
against qtpu on the CPU, on the same numpy-made weights and packed bytes.

qtpu's Pallas kernels take any head dim that is a multiple of 8. The port
asks each kernel from the shape (`flash_attention.supported`,
`kv_attention.decode_supported` and `flash_supported`: a multiple of 16 from
32 to 128, K3's kernel at most 32 q heads a kv head) and runs the plain
version of one that refuses, counted in `ops.plain_attention.launches`. At
hd 80 and 96 every attention kernel takes the call (K5, K3's kernel, K8,
K11, the one-layer entry, K12), so the count stays 0; what still takes the
plain route is hd % 16 == 8, hd > 128 and G > 32. On the CPU every wrapper
runs its plain version uncounted; on the card the same shapes launch the
kernels (tests/test_torch_gpu.py).

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
from qtpu.models import opt as jopt
from qtpu.models.config import ModelConfig as JCfg
from qtpu.quant import apply as japply
from qtpu.serve import kvcache as jkv
from qtpu_torch.convert import params_to_torch, to_torch
from qtpu_torch.kernels import flash_attention as k5
from qtpu_torch.kernels import kv_attention as k23
from qtpu_torch.models import llama as tllama
from qtpu_torch.models import opt as topt
from qtpu_torch.models import ops
from qtpu_torch.models.config import ModelConfig as TCfg
from qtpu_torch.serve import kvcache as tkv
from test_torch_gpt2_opt import _np_params as _np_opt_params
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
    takes = [32, 48, 64, 80, 96, 112, 128]
    for hd in range(8, 264, 8):
        assert k5.supported(hd) == (hd in takes), hd
        assert k23.flash_supported(hd) == (hd in takes), hd
        for G in (1, 8, 32, 33):
            assert k23.decode_supported(hd, G) == (hd in takes and G <= 32), (hd, G)
    assert not k23.decode_supported(80, 0)


def test_forward_matches_qtpu(model):
    """The cacheless forward (eval, calibration): K5 takes hd 80 and 96, so
    no call takes the plain route (on the CPU K5's wrapper runs its plain
    version uncounted)."""
    hd, jcfg, tcfg, pj, pt, *_ = model
    ids = np.random.default_rng(7).integers(0, 512, (2, 24)).astype(np.int32)
    want = jllama.forward(pj, jnp.asarray(ids), jcfg)
    n0 = ops.plain_attention.launches
    got = tllama.forward(pt, cpu(ids), tcfg)
    assert _rel(got.numpy(), want) < LOGIT_TOL
    assert ops.plain_attention.launches - n0 == 0


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
    int8 cache at S 2048 (K12's layout). Every decode kernel takes hd 80
    and 96 (K3's kernel on the stacked caches, K12 on the per-layer one), so
    no call takes the plain route."""
    hd, jcfg, tcfg, _, _, pkj, qj, pkt = model
    B, P, S = 2, 12, 2048 if per_layer else 32
    ids = np.random.default_rng(8).integers(0, 512, (B, P)).astype(np.int32)
    pos = np.arange(P, dtype=np.int32)[None].repeat(B, 0)
    cj = jkv.init_cache(jcfg, B, S, quantized=kv == "int8", per_layer=per_layer)
    for step in range(4):
        n0 = ops.plain_attention.launches
        lt, _ = tllama.forward_with_cache(pkt, cpu(ids), cpu(pos), _port_cache(cj), tcfg, qj)
        plain = ops.plain_attention.launches - n0
        lj, cj = jllama.forward_with_cache(pkj, jnp.asarray(ids), jnp.asarray(pos), cj, jcfg, qj)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL, step
        # prefill attends with the plain cached attention (no kernel: uncounted)
        assert plain == 0, (step, plain)
        ids = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1


# OPT-2.7B's head dim at 2 layers: MHA (8 heads of 80), pre-LN, ReLU, tied
# embeddings, learned positions with HF's offset 2
OPT_KW = dict(arch="opt", vocab_size=512, hidden_size=640, intermediate_size=1024,
              num_layers=2, num_heads=8, num_kv_heads=8, head_dim=80, max_seq_len=512,
              tie_embeddings=True)


@pytest.fixture(scope="module")
def opt_model():
    """(qtpu cfg, port cfg, qtpu raw params, port raw params, qtpu's fused
    RTN W4 g64 artifact and qmeta, the same artifact on the port)."""
    jcfg, tcfg = JCfg(**OPT_KW), TCfg(**OPT_KW)
    p = _np_opt_params("opt", tcfg, seed=5)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    rtn = {"w_bit": 4, "q_group_size": 64}
    pkj, qj = japply.fuse_packed_sites(*japply.pack_model(pj, "rtn", rtn, arch="opt"),
                                       arch="opt")
    pkt = params_to_torch(jax.tree_util.tree_map(np.asarray, pkj), device="cpu")
    return jcfg, tcfg, pj, params_to_torch(p, device="cpu"), pkj, qj, pkt


def test_opt_forward_matches_qtpu(opt_model):
    """The cacheless OPT forward at hd 80 (eval): no plain-route call."""
    jcfg, tcfg, pj, pt, *_ = opt_model
    ids = np.random.default_rng(9).integers(0, 512, (2, 24)).astype(np.int32)
    want = jopt.forward(pj, jnp.asarray(ids), jcfg)
    n0 = ops.plain_attention.launches
    got = topt.forward(pt, cpu(ids).long(), tcfg)
    assert _rel(got.numpy(), want) < LOGIT_TOL
    assert ops.plain_attention.launches - n0 == 0


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_opt_packed_prefill_and_decode_match_qtpu(opt_model, kv):
    """qtpu's fused OPT artifact at hd 80 on both packages'
    forward_with_cache: a prefill of 12 (sequences at offsets 0 and 3) and 3
    decode steps on the int8 cache (K2 and the one-layer entry on the card)
    and the bf16 cache (K8), each step fed qtpu's token and cache; no call
    takes the plain route."""
    jcfg, tcfg, _, _, pkj, qj, pkt = opt_model
    B, P, S = 2, 12, 32
    ids = np.random.default_rng(10).integers(0, 512, (B, P)).astype(np.int32)
    pos = np.array([0, 3], np.int32)[:, None] + np.arange(P, dtype=np.int32)[None]
    cj = jkv.init_cache(jcfg, B, S, quantized=kv == "int8")
    for step in range(4):
        n0 = ops.plain_attention.launches
        lt, _ = topt.forward_with_cache(pkt, cpu(ids), cpu(pos), _port_cache(cj), tcfg, qj)
        plain = ops.plain_attention.launches - n0
        lj, cj = jopt.forward_with_cache(pkj, jnp.asarray(ids), jnp.asarray(pos), cj, jcfg, qj)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL, step
        assert plain == 0, (step, plain)
        ids = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
