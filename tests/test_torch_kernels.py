"""The plain versions of the port's kernels (what a CPU tensor runs) against
the JAX package's functions on the same inputs, made with numpy:

  K1 quantized_matmul   vs qtpu _quantized_matmul_ref / quantized_matmul_stacked
  K2 cache_band_write   vs qtpu cache_layer_write at T = 1 (bytes and scales equal)
  K3 decode_attention   vs qtpu _cached_attention at T = 1, with and without a window
  K4 fused_mlp          vs qtpu's composed _mlp_block

Both sides compute in bf16 with f32 accumulation, but XLA and PyTorch round
and sum in other orders; the tolerances below say how far that may go.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.core.packing import quantize_pack as jax_quantize_pack
from qtpu.kernels.dequant_matmul import _quantized_matmul_ref, quantized_matmul_stacked
from qtpu.models.config import TINY_TEST
from qtpu.models.llama import _cached_attention, _mlp_block
from qtpu.serve.kvcache import cache_layer_write as jax_cache_layer_write
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.kernels.dequant_matmul import quantized_matmul
from qtpu_torch.kernels.fused_mlp import fused_mlp
from qtpu_torch.kernels.kv_attention import cache_band_write, decode_attention


def cpu(a):
    """numpy -> a tensor on the CPU (the port's entry points default to cuda)."""
    return to_torch(a, device="cpu")


BF16 = ml_dtypes.bfloat16
REL_TOL = 1e-2  # relative Frobenius error: bf16 outputs rounded in another order


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _packed_np(seed, L, K, N, bits, group, sym=False):
    """L layers of a numpy-random weight packed by qtpu, as numpy arrays."""
    parts = [
        jax_quantize_pack(jnp.asarray(_normal(seed + l, (K, N), 0.05).astype(BF16)),
                          bits, group, symmetric=sym)
        for l in range(L)
    ]
    data = np.stack([np.asarray(p.data) for p in parts])
    scales = np.stack([np.asarray(p.scales) for p in parts])
    zeros = None if sym else np.stack([np.asarray(p.zeros) for p in parts])
    return data, scales, zeros


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("sym", [False, True])
def test_k1_plain_matches_xla_ref(bits, sym):
    M, K, N, g = 5, 256, 192, 64
    data, scales, zeros = _packed_np(bits, 1, K, N, bits, g, sym)
    x = _normal(100 + bits, (M, K)).astype(BF16)
    meta = (bits, g, K, N)
    z = None if zeros is None else zeros[0]
    want = _quantized_matmul_ref(
        jnp.asarray(x), jnp.asarray(data[0]), jnp.asarray(scales[0]),
        None if z is None else jnp.asarray(z), meta,
    )
    before = quantized_matmul.launches
    got = quantized_matmul(cpu(x), cpu(data[0]), cpu(scales[0]),
                           None if z is None else cpu(z), meta)
    assert quantized_matmul.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert _rel(to_numpy(got), want) < REL_TOL


def test_k1_plain_matches_stacked_layers():
    L, M, K, N, g = 3, 8, 256, 128, 128
    data, scales, zeros = _packed_np(7, L, K, N, 4, g)
    x = _normal(8, (M, K)).astype(BF16)
    meta = (4, g, K, N)
    td, ts, tz = cpu(data), cpu(scales), cpu(zeros)
    for l in range(L):
        want = quantized_matmul_stacked(
            jnp.asarray(x), jnp.asarray(data), jnp.asarray(scales), jnp.asarray(zeros),
            meta, jnp.int32(l),
        )
        got = quantized_matmul(cpu(x), td[l], ts[l], tz[l], meta)
        assert _rel(to_numpy(got), want) < REL_TOL


def _cache_np(seed, L, B, KV, S, hd):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (L, B, KV, S, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (L, B, KV, S, hd), dtype=np.int8)
    ks = (rng.random((L, B, KV, S)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((L, B, KV, S)) * 0.05 + 0.01).astype(np.float32)
    return k, v, ks, vs


def test_k2_plain_matches_cache_layer_write():
    L, B, KV, S, hd, l = 2, 4, 2, 16, 64, 1
    cache = _cache_np(3, L, B, KV, S, hd)
    kn = _normal(4, (B, 1, KV, hd)).astype(BF16)
    vn = _normal(5, (B, 1, KV, hd)).astype(BF16)
    pos = np.array([0, 7, S - 1, S], np.int32)  # the last row is inactive: no write
    jk, jv, jks, jvs = jax_cache_layer_write(
        tuple(jnp.asarray(c[l]) for c in cache), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), True,
    )
    tc = [cpu(c) for c in cache]
    before = cache_band_write.launches
    cache_band_write(cpu(kn), cpu(vn), *tc, cpu(pos), l)
    assert cache_band_write.launches == before
    for got, want in zip(tc, (jk, jv, jks, jvs)):
        np.testing.assert_array_equal(to_numpy(got[l]), np.asarray(want))
    for got, orig in zip(tc, cache):  # other layers untouched
        np.testing.assert_array_equal(to_numpy(got[0]), orig[0])
    np.testing.assert_array_equal(to_numpy(tc[0][l, 3]), cache[0][l, 3])


@pytest.mark.parametrize("window", [0, 5])
def test_k3_plain_matches_cached_attention(window):
    L, B, H, KV, S, hd, l = 2, 4, 4, 2, 24, 64, 1
    cache = _cache_np(6, L, B, KV, S, hd)
    q = _normal(7, (B, H, hd)).astype(BF16)
    pos = np.array([0, 9, 17, S - 1], np.int32)
    kpos = np.arange(S)
    mask = kpos[None, :] <= pos[:, None]
    if window:
        mask &= kpos[None, :] > pos[:, None] - window
    want = _cached_attention(
        jnp.asarray(q)[:, None], tuple(jnp.asarray(c[l]) for c in cache),
        jnp.asarray(mask[:, None, :]), TINY_TEST, pos=jnp.asarray(pos),
    ).reshape(B, H, hd)
    got = decode_attention(cpu(q), *(cpu(c) for c in cache), cpu(pos), l,
                           window=window)
    assert _rel(to_numpy(got), want) < REL_TOL


def test_k4_plain_matches_composed_mlp():
    L, B, D, F, g, l = 2, 4, 256, 512, 128, 1
    gu = _packed_np(20, L, D, 2 * F, 4, g)
    dn = _packed_np(30, L, F, D, 4, g)
    nw = (1.0 + 0.1 * _normal(9, (L, D))).astype(BF16)
    x = _normal(10, (B, 1, D)).astype(BF16)
    mgu, md = (4, g, D, 2 * F), (4, g, F, D)
    cfg = TINY_TEST.replace(hidden_size=D, intermediate_size=F)
    layers = {
        "mlp_norm": jnp.asarray(nw),
        "gateup_proj": dict(zip(("data", "scales", "zeros"), map(jnp.asarray, gu))),
        "down_proj": dict(zip(("data", "scales", "zeros"), map(jnp.asarray, dn))),
    }
    qm = {"gateup_proj": mgu, "down_proj": md}.get
    want = _mlp_block(jnp.asarray(x), layers, jnp.int32(l), layers["mlp_norm"][l], cfg, qm)
    t = [cpu(a[l]) for a in (*gu, *dn)]
    got = fused_mlp(cpu(x), cpu(nw[l]), *t, mgu, md, eps=cfg.norm_eps)
    assert _rel(to_numpy(got), want) < REL_TOL
    # the MLP's own contribution (output minus the residual) agrees too
    assert _rel(to_numpy(got).astype(np.float32) - x.astype(np.float32),
                np.asarray(want, np.float32) - x.astype(np.float32)) < 2 * REL_TOL
