"""K6's plain version against qtpu on the CPU: the per-token activation
quantization bit for bit with qtpu's jitted XLA reference (the rounding
qtpu's serving path runs), the W8A8 product against `_w8a8_matmul_ref`
and the Pallas kernel in interpret mode, and the linear op's W8A8 and
codebook dispatch.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.core.packing import pack_int4 as jax_pack_int4
from qtpu.core.packing import quantize_pack as jax_quantize_pack
from qtpu.kernels import int8_matmul as jint8
from qtpu.kernels.pallas_int8_matmul import pallas_w8a8_matmul
from qtpu.models import ops as jops
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import int8_matmul as k6
from qtpu_torch.models import ops
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

BF16 = ml_dtypes.bfloat16
TOL = 2e-2  # the Pallas kernel's own test: max |err| / max |ref|


def cpu(a):
    return to_torch(a, device="cpu")


def _x(seed, shape, dtype=BF16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.random(shape[:-1] + (1,)) * 3
    x[..., 0, :] = 0.0  # an all-zero token: the 1e-8 floor of sx binds
    return x.astype(np.float32).astype(dtype)


def _w8(seed, K, N):
    """Per-channel asymmetric W8 (one group spanning K), packed by qtpu."""
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.05).astype(np.float32)
    qt = jax_quantize_pack(jnp.asarray(w.astype(BF16)), 8, K)
    return (np.asarray(qt.data), np.asarray(qt.scales), np.asarray(qt.zeros)), (8, K, K, N)


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 384), (1, 4, 2048)])
@pytest.mark.parametrize("dtype", [BF16, np.float32])
def test_quantize_activations_equals_jitted_qtpu(shape, dtype):
    """x_q and sx bit for bit with jax.jit(quantize_activations): XLA turns
    absmax / 127 into a multiply by the f32 reciprocal (qtpu's eager call
    divides, and differs in a few percent of sx), x / sx stays a division."""
    x = _x(sum(shape), shape, dtype)
    xq_j, sx_j = jax.jit(jint8.quantize_activations)(jnp.asarray(x))
    xq, sx = k6.quantize_activations(cpu(x))
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j))


@pytest.mark.parametrize("M,K,N", [(1, 256, 256), (8, 256, 128), (77, 512, 384),
                                   (300, 384, 256)])
def test_w8a8_plain_matches_qtpu(M, K, N):
    x = _x(M + K, (M, K))
    (d, s, z), meta = _w8(N, K, N)
    want = jint8._w8a8_matmul_ref(jnp.asarray(x), jnp.asarray(d), jnp.asarray(s),
                                  jnp.asarray(z), meta)
    got = k6.w8a8_matmul_plain(cpu(x), cpu(d), cpu(s), cpu(z), meta)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert _err(to_numpy(got), want) < TOL
    # the wrapper takes the plain version for a CPU tensor, also with a 5-tuple meta
    assert torch.equal(k6.w8a8_matmul(cpu(x), cpu(d), cpu(s), cpu(z), meta + ("a8",)), got)


@pytest.mark.parametrize("M", [8, 64, 1, 3])
def test_w8a8_plain_matches_pallas_interpret(M):
    """M 1 and 3: decode rows at TinyLlama's widest K (the down site's 5632)."""
    K, N = (256, 256) if M >= 8 else (5632, 256)
    x = _x(M, (M, K))
    (d, s, z), meta = _w8(M + 1, K, N)
    want = pallas_w8a8_matmul(jnp.asarray(x), jnp.asarray(d), jnp.asarray(s), jnp.asarray(z),
                              meta, interpret=True)
    got = k6.w8a8_matmul_plain(cpu(x), cpu(d), cpu(s), cpu(z), meta)
    assert _err(to_numpy(got), want) < TOL


def test_w8a8_plain_integer_product_is_exact():
    """The float64 product of the codes equals the int64 one, at the
    largest magnitudes TinyLlama's widest site (K = 5632) can give."""
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (16, 5632)).astype(np.int8)
    w = rng.integers(-128, 128, (5632, 64)).astype(np.int8)
    xq[0], w[:, 0] = 127, 127  # |acc| = 127 * 255 * 5632 in one element
    acc = torch.from_numpy(xq).double() @ (torch.from_numpy(w).double() + 128)
    ref = torch.from_numpy(xq).long() @ (torch.from_numpy(w).long() + 128)
    assert torch.equal(acc.long(), ref) and int(ref.abs().max()) == 127 * 255 * 5632


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("K,N", [(2048, 2048), (5632, 2048), (2048, 32000), (4100, 135168),
                                 (65536, 256), (1000, 388)])
def test_gemv_slices_cover_k_and_fit_the_stage(M, K, N):
    """The GEMV's K slices (132 SMs, an H100's): multiples of 4 that cover
    K, and each block's xq rows fit its shared-memory stage."""
    rows = k6.gemv_rows(M, K, N, 132)
    slices = -(-K // rows)
    assert rows % 4 == 0 and (slices - 1) * rows < K <= slices * rows
    assert M * rows <= k6.GEMV_STAGE
    assert slices > 1 or K <= 64 or -(-N // k6.GEMV_COLS) >= 4 * 132


def test_w8a8_refuses_other_packings():
    qt = quantize_pack(torch.randn(256, 128) * 0.05, 8, 64)
    with pytest.raises(ValueError, match="per-channel"):
        k6.w8a8_matmul_plain(torch.randn(2, 256), qt.data, qt.scales, qt.zeros, (8, 64, 256, 128))


@pytest.mark.parametrize("smooth", [False, True])
def test_linear_a8_site_matches_qtpu(smooth):
    """ops.linear on a W8A8 site ("a8" meta, optional input smooth vector)
    against qtpu's ops.linear."""
    K, N = 256, 384
    x = _x(1, (2, 6, K))
    (d, s, z), meta = _w8(2, K, N)
    p = {"data": d, "scales": s, "zeros": z}
    if smooth:
        p["smooth"] = (0.5 + np.random.default_rng(4).random(K)).astype(np.float32)
    meta5 = meta + ("a8",)
    want = jops.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, meta5)
    got = ops.linear(cpu(x), {k: cpu(v) for k, v in p.items()}, meta5)
    assert _err(to_numpy(got), want) < TOL


def test_linear_perm_site_matches_qtpu():
    """An actorder "perm" gathers the activations before K1's plain version."""
    K, N = 256, 128
    x = _x(5, (3, K))
    w = (np.random.default_rng(6).standard_normal((K, N)) * 0.05).astype(np.float32)
    qt = jax_quantize_pack(jnp.asarray(w), 4, 64)
    perm = np.random.default_rng(7).permutation(K).astype(np.int32)
    p = {"data": np.asarray(qt.data), "scales": np.asarray(qt.scales),
         "zeros": np.asarray(qt.zeros), "perm": perm}
    meta = (4, 64, K, N)
    want = jops.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, meta)
    got = ops.linear(cpu(x), {k: cpu(v) for k, v in p.items()}, meta)
    assert _err(to_numpy(got), want) < TOL


def test_linear_codebook_site_raises_naming_its_slice():
    """A POT codebook site no longer raises: ops.linear runs K7's plain
    version and equals qtpu's ops.linear on the same packed bytes."""
    from qtpu.quant.pot import pot_codebook, pot_quantize_codes

    K, N, g = 256, 96, 64
    x = _x(9, (3, K))
    w = (np.random.default_rng(10).standard_normal((K, N)) * 0.05).astype(np.float32)
    codes, sc = pot_quantize_codes(jnp.asarray(w), 4, g, grid=(0.01, 2.01, 0.1))
    p = {"data": np.asarray(jax_pack_int4(codes, g)),
         "scales": np.asarray(sc.astype(jnp.bfloat16)), "codebook": np.asarray(pot_codebook(4))}
    meta = (4, g, K, N)
    want = jops.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, meta)
    got = ops.linear(cpu(x), {k: cpu(v) for k, v in p.items()}, meta)
    assert _err(to_numpy(got), want) < TOL


# ------------------------------------------- tensor parallelism's two modes
@pytest.mark.parametrize("shape", [(1, 1024), (8, 2816), (3, 5, 384), (32, 1024)])
def test_absmax_out_plain_is_quantize_activations_absmax(shape):
    """absmax out's plain version is the absmax quantize_activations scales
    by; fed back (absmax in), x_q and sx are bit for bit the usual ones."""
    x = cpu(_x(7 + len(shape), shape))
    amax = k6.absmax_plain(x)
    assert amax.dtype == torch.float32 and tuple(amax.shape) == (*shape[:-1], 1)
    xq, sx = k6.quantize_activations(x)
    assert torch.equal(sx, torch.clamp(amax * (1.0 / 127.0), min=1e-8))
    assert torch.equal(k6.w8a8_absmax(x), amax)  # the wrapper's CPU route
    xq2, sx2 = k6.quantize_activations(x, amax)
    assert torch.equal(xq2, xq) and torch.equal(sx2, sx)


@pytest.mark.parametrize("M,K,N", [(1, 1024, 2048), (8, 2816, 256), (32, 1024, 384)])
def test_absmax_in_plain_with_the_own_absmax_is_the_usual_path(M, K, N):
    """w8a8_matmul_plain (and the wrapper on the CPU) with x's own absmax:
    int32 sums whose rescale (w8a8_epilogue) is the usual path bit for
    bit."""
    x = cpu(_x(M + K, (M, K)))
    (d, s, z), meta = _w8(N, K, N)
    d, s, z = cpu(d), cpu(s), cpu(z)
    want = k6.w8a8_matmul_plain(x, d, s, z, meta)
    amax = k6.absmax_plain(x)
    total = k6.w8a8_matmul_plain(x, d, s, z, meta, absmax=amax)
    assert total.dtype == torch.int32
    assert torch.equal(k6.w8a8_matmul(x, d, s, z, meta + ("a8",), absmax=amax), total)
    assert torch.equal(k6.w8a8_epilogue(total, amax, s), want)


@pytest.mark.parametrize("parts", [(512, 512), (1024, 768, 1024)])
def test_k_slices_on_the_all_reduced_absmax_sum_to_the_whole(parts):
    """A row-parallel W8A8 site's K cut in uneven slices: the max of the
    slices' absmax is the whole row's, the slices' int32 sums on it (the
    absmax-in mode) add up to the whole K's exactly (the zero correction is
    linear in K), and the rescale of that sum is the unsharded product."""
    K, N, M = sum(parts), 256, 4
    x = cpu(_x(K, (M, K)))
    (d, s, z), meta = _w8(K + 1, K, N)
    d, s, z = cpu(d), cpu(s), cpu(z)
    cuts = np.cumsum((0,) + parts)
    xs = [x[:, a:b].contiguous() for a, b in zip(cuts, cuts[1:])]
    amax = torch.stack([k6.absmax_plain(t) for t in xs]).amax(0)
    assert torch.equal(amax, k6.absmax_plain(x))
    total = sum(k6.w8a8_matmul(t, d[a:b], s, z, (8, b - a, b - a, N), absmax=amax)
                for t, a, b in zip(xs, cuts, cuts[1:]))
    whole = k6.w8a8_matmul_plain(x, d, s, z, meta, absmax=amax)
    assert total.dtype == torch.int32 and torch.equal(total, whole)
    got = k6.w8a8_epilogue(total, amax, s)
    want = k6.w8a8_matmul_plain(x, d, s, z, meta)
    assert got.dtype == torch.bfloat16 and _err(to_numpy(got), to_numpy(want)) < 1e-2
