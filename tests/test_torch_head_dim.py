"""Head dims qtpu runs beside 64 and 128: a 2-layer llama at head_dim 80
(hidden 640, 8 heads, as OPT-2.7B's 2560 / 32), 96 (hidden 768, 8 heads, 4
kv heads), 256 (hidden 512, 2 heads, 1 kv head: Falcon3's head dim), 40
(hidden 320, 8 heads, 2 kv heads: hd % 16 == 8) and 16 at 48 q heads a kv
head (hidden 768, 48 heads, 1 kv head: G 48), and a 2-layer OPT at head_dim
80 (hidden 640, 8 heads), against qtpu on the CPU, on the same numpy-made
weights and packed bytes; and qtpu's Pallas kernels (flash attention, the
stacked decode attention) in interpret mode against the port's plain
versions at hd 256, hd 40 and G 48.

qtpu's Pallas kernels take any head dim that is a multiple of 8, at any G.
The port asks each kernel from the shape (`flash_attention.supported`,
`kv_attention.decode_supported` and `flash_supported`: a multiple of 8 from
8 to 256, any G) and runs the plain version of one that refuses, counted in
`ops.plain_attention.launches`. Every attention kernel takes the shapes
here (K5, K3's kernel, K8, K11, the one-layer entry, K12), so the count
stays 0; what still takes the plain route is hd % 8 != 0 and hd > 256. On
the CPU every wrapper runs its plain version uncounted; on the card the
same shapes launch the kernels (tests/test_torch_gpu.py).

Tolerance: 2e-2 relative Frobenius error of the f32 logits (bf16 layers,
other sum orders), each decode step fed qtpu's token and qtpu's cache as it
stood, so no step inherits the other package's roundings (the int8 codes
that differ by up to 2, ROADMAP section 3). The kernel cases: the Pallas
tests' own tolerances (tests/test_pallas_kernels.py): rtol = atol = 2e-2 for
flash attention, max |diff| / max |out| < 3e-2 for the decode attention
(bf16 outputs: a few ulps at |out| ~ 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.kernels.pallas_flash_attention import pallas_flash_attention
from qtpu.kernels.pallas_kv_attention import pallas_decode_attention_stacked
from qtpu.models import llama as jllama
from qtpu.models import opt as jopt
from qtpu.models.config import ModelConfig as JCfg
from qtpu.quant import apply as japply
from qtpu.serve import kvcache as jkv
from qtpu_torch.convert import params_to_numpy, params_to_torch, to_torch
from qtpu_torch.kernels import flash_attention as k5
from qtpu_torch.kernels import kv_attention as k23
from qtpu_torch.models import llama as tllama
from qtpu_torch.models import opt as topt
from qtpu_torch.models import ops
from qtpu_torch.models.config import ModelConfig as TCfg
from qtpu_torch.quant import apply as tapply
from qtpu_torch.serve import kvcache as tkv
from test_torch_gpt2_opt import _np_params as _np_opt_params
from test_torch_quant import _np_params, one_torch_thread  # noqa: F401  (a fixture)

LOGIT_TOL = 2e-2
SHAPES = {80: dict(hidden_size=640, num_heads=8, num_kv_heads=8, head_dim=80),
          96: dict(hidden_size=768, num_heads=8, num_kv_heads=4, head_dim=96),
          256: dict(hidden_size=512, num_heads=2, num_kv_heads=1, head_dim=256),
          40: dict(hidden_size=320, num_heads=8, num_kv_heads=2, head_dim=40),
          16: dict(hidden_size=768, num_heads=48, num_kv_heads=1, head_dim=16)}  # G 48


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


@pytest.fixture(scope="module", params=list(SHAPES))
def model(request):
    """(hd, qtpu cfg, port cfg, qtpu raw params, port raw params, the fused
    RTN W4 g64 artifact and qmeta on qtpu, the same artifact on the port).
    The port packs it (its pack_model and fuse_packed_sites give qtpu's
    bytes and metas, tests/test_torch_quant.py) and qtpu gets those bytes:
    qtpu's pack compiles anew for each shape, some 10 s a model."""
    kw = dict(vocab_size=512, intermediate_size=1024, num_layers=2, max_seq_len=512,
              **SHAPES[request.param])
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    p = _np_params(tcfg, seed=4)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = params_to_torch(p, device="cpu")
    pkt, qj = tapply.fuse_packed_sites(*tapply.pack_model(pt, "rtn", {"w_bit": 4,
                                                                      "q_group_size": 64}))
    pkj = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(pkt))
    return request.param, jcfg, tcfg, pj, pt, pkj, qj, pkt


def test_the_routes_name_the_kernels_that_take_the_head_dim():
    """Every multiple of 8 from 8 to 256 at any G up to 64 (and past it):
    qtpu's Pallas domain; hd % 8 != 0 and hd > 256 refused. A block takes
    32 q heads; more split into even head groups."""
    for hd in range(8, 264, 8):
        assert k5.supported(hd) and k23.flash_supported(hd), hd
        for G in (1, 3, 8, 17, 32, 33, 48, 64, 100):
            assert k23.decode_supported(hd, G), (hd, G)
    for hd in [h for h in range(1, 300) if h % 8] + [264, 272, 512]:
        assert not (k5.supported(hd) or k23.flash_supported(hd)
                    or k23.decode_supported(hd, 1)), hd
    assert not k23.decode_supported(80, 0)
    assert k23.head_groups(32) == (1, 32) and k23.head_groups(48) == (2, 24)
    assert k23.head_groups(100) == (4, 25) and k23.head_groups(3) == (1, 3)
    assert not k23.simt_supported(40, 4) and not k23.simt_supported(64, 48)


def test_forward_matches_qtpu(model):
    """The cacheless forward (eval, calibration): K5 takes every head dim
    here, so no call takes the plain route (on the CPU K5's wrapper runs its
    plain version uncounted)."""
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
    int8 cache at S 2048 (K12's layout). Every decode kernel takes these
    shapes (K3's kernel on the stacked caches, K12 on the per-layer one), so
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


# the kernel cases: (B, H, KV, hd) at hd 256, hd 40 and G 48
KERNEL_SHAPES = {"hd256": (1, 2, 1, 256), "hd40": (2, 8, 2, 40), "g48": (1, 48, 1, 16)}


@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
@pytest.mark.parametrize("window", [0, 100])
def test_flash_plain_matches_pallas_interpret(shape, window):
    """K5's plain version against pallas_flash_attention in interpret mode
    at S 256 (its S % 128 granule), causal and windowed."""
    B, H, KV, hd = KERNEL_SHAPES[shape]
    rng = np.random.default_rng(11)
    q, k, v = ((rng.standard_normal((B, n, 256, hd)) * sc).astype(np.float32)
               for n, sc in ((H, 0.5), (KV, 0.5), (KV, 1.0)))
    want = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, interpret=True)
    got = k5.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
@pytest.mark.parametrize("window", [0, 16])
def test_decode_plain_matches_pallas_stacked_interpret(shape, window):
    """K3's plain version (`decode_attention` on layer 1 of a stacked int8
    cache of 2, read-only) against pallas_decode_attention_stacked in
    interpret mode at S 64, one sequence at pos 40 and one at S - 1."""
    B, H, KV, hd = KERNEL_SHAPES[shape]
    B, S = 2, 64
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, H, hd)).astype(np.float32).astype(jnp.bfloat16)
    k, v = (rng.integers(-127, 128, (2, B, KV, S, hd)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.06, (2, B, KV, S)).astype(np.float32) for _ in range(2))
    pos = np.array([40, S - 1], np.int32)
    want = pallas_decode_attention_stacked(jnp.asarray(q), *map(jnp.asarray, (k, v, ks, vs)),
                                           jnp.asarray(pos), 1, window=window, interpret=True)
    cache = [cpu(a) for a in (k, v, ks, vs)]
    n0 = k23.decode_attention.launches
    got = k23.decode_attention(cpu(np.asarray(q)), *cache, cpu(pos), 1, window=window)
    for t, orig in zip(cache, (k, v, ks, vs)):  # read-only
        np.testing.assert_array_equal(t.numpy(), orig)
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() / np.abs(want).max() < 3e-2
    assert k23.decode_attention.launches == n0
