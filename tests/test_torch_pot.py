"""The port's POT and APOT quantizers against qtpu on the CPU, on the same
numpy-made weights: the frozen tables, fake quantization, the packed codes
and scales, and the APOT levels, bit for bit.

Two differences from qtpu are allowed, each counted (ROADMAP section 3):
  * the base scale's exponent floor(log2(max|w|)). The port reads it from
    the exponent field (exact on every device); qtpu takes
    jnp.floor(jnp.log2(.)) under jit, which XLA's CPU log2 rounds up to k for
    a group max a few ulps below 2^k. A group whose max lies in that window
    may get another scale; the tests find the window's groups with qtpu's
    own expression;
  * ties of the scale race. XLA-CPU contracts multiplies and adds of the
    race's loop body into fused multiply-adds, so qtpu's group SSEs can
    move by an ulp from the written order of rounded ops, which the port
    keeps. Where two candidates tie or nearly tie, the two packages may
    keep different ones. The tests check that each such group is a tie
    (the f64 SSEs of both results within 1e-6 relative) and bound them to
    2% of the groups.
Every other group is equal bit for bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.quant import apot as japot
from qtpu.quant import parity_grids as jgrids
from qtpu.quant import pot as jpot
from qtpu.quant import pot_log2_table as jtable
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.quant import apot, parity_grids, pot, pot_log2_table

BF16 = ml_dtypes.bfloat16
GRIDS = {"parity": None, "step0.07": (0.01, 2.01, 0.07)}


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


def _u32(a):
    """The bits of a float array (codes pass as they are)."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@jax.jit
def _xla_floor_log2(x):
    return jnp.floor(jnp.log2(jnp.clip(x, 1e-12, None)))


def _window_groups(groups: np.ndarray) -> np.ndarray:
    """Groups [R, g] whose max|w| qtpu's jitted floor(log2) puts one
    exponent above the exponent field."""
    mx = np.abs(groups.astype(np.float32)).max(axis=1)
    exact = np.floor(np.log2(np.maximum(mx, np.float32(1e-12)).astype(np.float64)))
    return np.asarray(_xla_floor_log2(jnp.asarray(mx))) != exact


def _grid_kw(grid, default_step):
    if grid is None:
        return {"grid_values": jgrids.PARITY_GRIDS[default_step]}
    return {"grid": grid}


def _weight(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[1, :32] = 0.0  # a zero run: sign(0) and the ratio clamp
    w[2] *= 30.0  # an outlier row
    return w.astype(dtype)


def _check_groups(w, got, want, window, equal_bits=None):
    """w, got, want: [R, g] groups of the weight and of the two packages'
    dequantized results. Groups that differ (in `equal_bits`' groups when
    given, else in got/want) must lie in `window` or be ties of the race:
    the f64 SSEs of got and want within 1e-6 relative, at most 2% of the
    groups. Returns (groups in the window that differ, tie groups)."""
    diff = (_u32(got) != _u32(want)).any(axis=1) if equal_bits is None else ~equal_bits
    w64 = w.astype(np.float64)
    e_got = ((w64 - got.astype(np.float64)) ** 2).sum(axis=1)
    e_want = ((w64 - want.astype(np.float64)) ** 2).sum(axis=1)
    ties = diff & ~window
    rel = np.abs(e_got - e_want) / np.maximum(e_want, 1e-30)
    assert (rel[ties] < 1e-6).all(), f"non-tie groups differ: rel {rel[ties].max()}"
    assert ties.sum() <= 0.02 * w.shape[0], f"{int(ties.sum())} tie groups of {w.shape[0]}"
    return int((diff & window).sum()), int(ties.sum())


def _pot_dequant(codes, scales, group):
    """[K, N] POT codes and [K/g, N] scales -> the [K, N] f32 weight."""
    K, N = codes.shape
    c = codes.astype(np.int64)
    level = np.where(c >= 8, -1.0, 1.0) * 2.0 ** (c & 7)
    s = np.repeat(scales.astype(np.float64), group, axis=0)
    return (s * level).astype(np.float32)


def _check_codes(w, port, ref, group, dequant):
    """_check_groups on packed results: port/ref = (codes [K, N], scales
    [K/g, N]); a (group, column) is equal when its codes and scale are."""
    (ct, st), (cj, sj) = port, ref
    K, N = w.shape
    same = ((_cols(ct, group) == _cols(cj, group)).all(axis=1)
            & (_u32(st).T.reshape(-1) == _u32(sj).T.reshape(-1)).reshape(N, K // group)
            .T.reshape(-1))
    wg = _cols(w, group)
    return _check_groups(wg, _cols(dequant(ct, st).astype(np.float32), group),
                         _cols(dequant(cj, sj).astype(np.float32), group), _window_groups(wg),
                         same)


def _cols(a, group):
    """[K, N] -> one row per (group of K, column): [K/g * N, g]."""
    K, N = a.shape
    return a.reshape(K // group, group, N).transpose(0, 2, 1).reshape(-1, group)


# ------------------------------------------------------------- tables
def test_tables_equal_qtpu_bit_for_bit():
    assert parity_grids.PARITY_RANGE == jgrids.PARITY_RANGE
    assert parity_grids._TABLES_U32 == jgrids._TABLES_U32
    assert set(parity_grids.PARITY_GRIDS) == set(jgrids.PARITY_GRIDS)
    for step, vals in jgrids.PARITY_GRIDS.items():
        np.testing.assert_array_equal(np.array(parity_grids.PARITY_GRIDS[step], np.float32)
                                      .view(np.uint32), np.array(vals, np.float32).view(np.uint32))
    assert pot_log2_table.LOG2_ROUND_UP_BITS.dtype == jtable.LOG2_ROUND_UP_BITS.dtype
    np.testing.assert_array_equal(pot_log2_table.LOG2_ROUND_UP_BITS, jtable.LOG2_ROUND_UP_BITS)


@pytest.mark.parametrize("n,k", [(1, 1), (2, 2), (4, 2), (2, 4), (3, 3)])
def test_apot_levels_equal_qtpu(n, k):
    np.testing.assert_array_equal(apot.generate_apot_levels(n, k), japot.generate_apot_levels(n, k))
    for n_bit in (2, 3, 4, 8):
        for cap in (16, 32):
            np.testing.assert_array_equal(apot.full_apot_codebook(n_bit, k, cap),
                                          japot.full_apot_codebook(n_bit, k, cap))


@pytest.mark.parametrize("n_bit", [4, 8])
def test_pot_codebook_equals_qtpu(n_bit):
    np.testing.assert_array_equal(pot.pot_codebook(n_bit).numpy(),
                                  np.asarray(jpot.pot_codebook(n_bit)))


# ----------------------------------------------------- fake quantization
@pytest.mark.parametrize("shape,group", [((64, 256), 64), ((96, 128), 128), ((256, 128), 32),
                                         ((64, 192), 48), ((16, 96), 12), ((8, 64), -1)])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_pot_quantize_tensor_equals_qtpu(shape, group, grid):
    """Groups of 8k elements race in torch-CPU's summation order, others
    (12) in the double-float order; q_group_size -1 quantizes whole rows."""
    w = _weight(shape[0] + max(group, 0), shape)
    kw = _grid_kw(GRIDS[grid], 0.01)
    want = np.asarray(jpot.pot_quantize_tensor(jnp.asarray(w), 4, group, **kw))
    got = to_numpy(pot.pot_quantize_tensor(cpu(w), 4, group, **kw))
    g = group if group > 0 else shape[1]
    wg = w.reshape(-1, g)
    n_win, _ = _check_groups(wg, got.reshape(-1, g), want.reshape(-1, g), _window_groups(wg))
    assert n_win == 0  # random weights: no group max sits in the log2 window


@pytest.mark.parametrize("n_bit", [3, 8])
def test_pot_quantize_tensor_other_widths_equal_qtpu(n_bit):
    w = _weight(n_bit, (64, 256), BF16)
    kw = _grid_kw(None, 0.01)
    want = np.asarray(jpot.pot_quantize_tensor(jnp.asarray(w), n_bit, 64, **kw))
    got = to_numpy(pot.pot_quantize_tensor(cpu(w), n_bit, 64, **kw))
    assert got.dtype == want.dtype == BF16
    wg = w.astype(np.float32).reshape(-1, 64)
    _check_groups(wg, got.astype(np.float32).reshape(-1, 64),
                  want.astype(np.float32).reshape(-1, 64), _window_groups(wg))


@pytest.mark.parametrize("shape,group", [((64, 256), 64), ((96, 128), 128), ((16, 96), 12),
                                         ((8, 64), -1)])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_apot_quantize_tensor_equals_qtpu(shape, group, grid):
    w = _weight(7 + shape[0], shape)
    kw = _grid_kw(GRIDS[grid], 0.05)
    want = np.asarray(japot.apot_quantize_tensor(jnp.asarray(w), 4, group, **kw))
    got = to_numpy(apot.apot_quantize_tensor(cpu(w), 4, group, **kw))
    g = group if group > 0 else shape[1]
    wg = w.reshape(-1, g)
    _check_groups(wg, got.reshape(-1, g), want.reshape(-1, g), np.zeros(len(wg), bool))


# --------------------------------------------------------- packed codes
@pytest.mark.parametrize("K,N,group", [(256, 64, 64), (256, 96, 128), (128, 80, 32)])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_pot_quantize_codes_equal_qtpu(K, N, group, grid):
    w = _weight(K + N, (K, N))
    kw = _grid_kw(GRIDS[grid], 0.01)
    cj, sj = jpot.pot_quantize_codes(jnp.asarray(w), 4, group, **kw)
    ct, st = pot.pot_quantize_codes(cpu(w), 4, group, **kw)
    assert ct.dtype == torch.uint8 and st.dtype == torch.float32
    n_win, _ = _check_codes(w, (ct.numpy(), st.numpy()), (np.asarray(cj), np.asarray(sj)),
                            group, lambda c, sc: _pot_dequant(c, sc, group))
    assert n_win == 0


@pytest.mark.parametrize("K,N,group", [(256, 64, 64), (256, 96, 128), (128, 80, 32)])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_apot_quantize_codes_equal_qtpu(K, N, group, grid):
    w = _weight(3 * K + N, (K, N))
    kw = _grid_kw(GRIDS[grid], 0.05)
    cj, sj, lj = japot.apot_quantize_codes(jnp.asarray(w), 4, group, **kw)
    ct, st, lt = apot.apot_quantize_codes(cpu(w), 4, group, **kw)
    assert lt.numel() == 16  # the 4-bit cap
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    _check_codes(w, (ct.numpy(), st.numpy()), (np.asarray(cj), np.asarray(sj)), group,
                 lambda c, sc: np.repeat(sc, group, axis=0) * np.asarray(lj)[c.astype(np.int64)])


# ------------------------------------------------------ built edge cases
def _edge_groups(g=64):
    """Groups built to sit on ties and near powers of two: all zeros, one
    constant value, exact powers of two (several candidates reach SSE 0,
    the first must win), mantissas on the round-up thresholds of the
    E decision, and group maxima 0-6 ulps below 2^-3 .. 2^-6."""
    rng = np.random.default_rng(5)
    rows = [np.zeros(g, np.float32), np.full(g, 0.0123, np.float32)]
    rows.append((2.0 ** -rng.integers(3, 10, g) * rng.choice([-1, 1], g)).astype(np.float32))
    thr = pot_log2_table.LOG2_ROUND_UP_BITS[:4].astype(np.int64)
    base = np.float32(2.0 ** -9)
    for e in range(4):  # |w| / base = m * 2^e with the mantissa on or just below the threshold
        bits = np.array([((127 + e) << 23) | int(thr[e]) - d for d in (0, 1)], np.int64)
        vals = bits.astype(np.uint32).view(np.float32) * base
        row = (rng.standard_normal(g) * 1e-3).astype(np.float32)
        row[:2], row[-1] = vals, np.float32(2.0 ** -6)
        rows.append(row)
    for k in (-3, -4, -5, -6):
        for ulps in range(7):
            row = (rng.standard_normal(g) * 2.0 ** (k - 3)).astype(np.float32)
            top = np.array([2.0**k], np.float32).view(np.int32) - ulps
            row[rng.integers(g)] = top.view(np.float32)[0]
            rows.append(row)
    return np.stack(rows)


def test_pot_edge_cases_equal_qtpu_outside_the_log2_window():
    w = _edge_groups()
    window = _window_groups(w)
    # qtpu's jitted log2 rounds up 1-4 ulps below 2^-3 .. 2^-6 on the CPU
    assert 4 <= int(window.sum()) <= 16
    kw = _grid_kw(None, 0.01)
    want = np.asarray(jpot.pot_quantize_tensor(jnp.asarray(w), 4, 64, **kw))
    got = to_numpy(pot.pot_quantize_tensor(cpu(w), 4, 64, **kw))
    n_win, _ = _check_groups(w, got, want, window)
    assert n_win <= int(window.sum())
    # inside the window the port takes the exact floor: one exponent below
    s0 = pot._base_scale(cpu(np.abs(w).max(axis=1, keepdims=True)), 7).numpy()[:, 0]
    mx = np.abs(w).max(axis=1)
    e = np.floor(np.log2(np.maximum(mx, 1e-12).astype(np.float64)))
    np.testing.assert_array_equal(s0, np.where(e - 7 >= -126, 2.0 ** (e - 7),
                                               np.finfo(np.float32).tiny).astype(np.float32))


def test_pot_edge_codes_equal_qtpu_outside_the_log2_window():
    w = _edge_groups().T.copy()  # [K = 64, N = groups]: one group per column
    kw = _grid_kw(None, 0.01)
    cj, sj = jpot.pot_quantize_codes(jnp.asarray(w), 4, 64, **kw)
    ct, st = pot.pot_quantize_codes(cpu(w), 4, 64, **kw)
    _check_codes(w, (ct.numpy(), st.numpy()), (np.asarray(cj), np.asarray(sj)), 64,
                 lambda c, sc: _pot_dequant(c, sc, 64))


def test_apot_edge_cases_equal_qtpu():
    w = _edge_groups()
    kw = _grid_kw(None, 0.05)
    want = np.asarray(japot.apot_quantize_tensor(jnp.asarray(w), 4, 64, **kw))
    got = to_numpy(apot.apot_quantize_tensor(cpu(w), 4, 64, **kw))
    _check_groups(w, got, want, np.zeros(len(w), bool))


def test_nearest_index_keeps_the_first_of_tied_levels():
    levels = apot.full_apot_codebook(4, 2, 16)
    mids = ((levels[:-1].astype(np.float64) + levels[1:]) / 2).astype(np.float32)
    x = np.concatenate([levels, mids, np.nextafter(mids, np.float32(2)),
                        np.array([-2.0, 2.0, 0.0], np.float32)]).astype(np.float32)
    got = apot._nearest_index(cpu(x), levels).numpy()
    want = np.asarray(japot._nearest_index(jnp.asarray(x), jnp.asarray(levels)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: levels.size], np.arange(levels.size))
    # an exact tie (both distances equal in f32) goes to the lower index
    d_lo = np.abs(mids - levels[:-1])
    d_hi = np.abs(mids - levels[1:])
    tie = d_lo == d_hi
    assert tie.any()
    np.testing.assert_array_equal(got[levels.size: levels.size + mids.size][tie],
                                  np.arange(mids.size)[tie])
    np.testing.assert_array_equal(apot._nearest_level(cpu(x), levels).numpy(), levels[got])
