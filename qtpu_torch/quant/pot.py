"""Power-of-two (POT) quantization (port of qtpu/quant/pot.py).

Per group of `q_group_size` weights, w ~ s * sign(w) * 2^E with E in
[0, 2^(b-1) - 1]. The base scale s0 = 2^(floor(log2 max|w|) - (2^(b-1) - 1))
is refined by a search over s = s0 * c for the grid's candidates c, keeping
the first candidate of least group SSE (strict <).

Every decision is elementwise IEEE arithmetic in a fixed order, so the
same inputs give the same bits on the CPU and on the card:
  * E = round(log2(|w| / s)) comes from the exponent and mantissa fields
    and the frozen threshold table (`pot_log2_table`), not from a log2;
  * 2^E is built from its exponent bits (`_exact_pow2`);
  * floor(log2(max|w|)) is the exponent field of max|w|. qtpu takes
    jnp.floor(jnp.log2(...)) under jit, which XLA's CPU log2 rounds up to k
    for a max a few ulps below 2^k (ROADMAP section 3; the parity tests
    count such groups);
  * the group SSE replays torch-CPU's f32 summation order with explicit
    adds (`_sse_torch_cpu`) when the group length divides by 8, else the
    double-float halving tree (`_sse_df`).
qtpu's program chunking (a TPU workaround) has no counterpart; the callers
in quant.apply go one layer at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.quant.pot_log2_table import LOG2_ROUND_UP_BITS

_TINY = float(np.finfo(np.float32).tiny)
_MANT = 0x7FFFFF


def _sse_df(d: torch.Tensor, axis: int):
    """Near-exact sum over `axis` of the f32 squares of d, as (hi, lo):
    a two-sum compensated halving tree. qtpu's `_sse_df`, op for op."""
    hi = d * d
    lo = torch.zeros_like(hi)
    while hi.shape[axis] > 1:
        n = hi.shape[axis]
        half = n // 2
        a_h, b_h = hi.narrow(axis, 0, half), hi.narrow(axis, half, half)
        a_l, b_l = lo.narrow(axis, 0, half), lo.narrow(axis, half, half)
        s = a_h + b_h
        t = s - a_h
        e = (a_h - (s - t)) + (b_h - t)  # two-sum rounding error
        l2 = (a_l + b_l) + e
        if n % 2:
            s = torch.cat([s, hi.narrow(axis, n - 1, 1)], dim=axis)
            l2 = torch.cat([l2, lo.narrow(axis, n - 1, 1)], dim=axis)
        hi, lo = s, l2
    return hi, lo


def _df_less(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _sse_torch_cpu(d: torch.Tensor, axis: int) -> torch.Tensor:
    """f32 sum over `axis` of d * d in torch-CPU's order (qtpu's
    `_sse_torch_cpu`): 8-wide lanes, four interleaved accumulators (chunk i
    into accumulator i mod 4), combined ((a0 + a1) + a2) + a3, then the 8
    lanes added in turn. The reduced length must divide by 8. Returns the
    sums with `axis` kept as length 1."""
    sq = d * d
    g = sq.shape[axis]
    n = g // 8
    x = sq.unflatten(axis, (n, 8))  # chunk axis at `axis`, lanes after it

    def chunk(i):
        return x.select(axis, i)

    if n >= 4:
        accs = [chunk(i) for i in range(4)]
        for i in range(4, n):
            accs[i % 4] = accs[i % 4] + chunk(i)
        a = ((accs[0] + accs[1]) + accs[2]) + accs[3]
    else:
        a = chunk(0)
        for i in range(1, n):
            a = a + chunk(i)
    s = a.select(axis, 0)
    for lane in range(1, 8):
        s = s + a.select(axis, lane)
    return s.unsqueeze(axis)


def _exact_pow2(E: torch.Tensor) -> torch.Tensor:
    """Exact f32 2^E for integer-valued E in [-126, 127], from the
    exponent field (an int32 view)."""
    Ei = E.to(torch.int32).clamp(-126, 127)
    return ((Ei + 127) << 23).view(torch.float32)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive normal f32 x, exactly: its exponent field."""
    return (x.view(torch.int32) >> 23) - 127


def _pot_round_log2(ratio: torch.Tensor, e_max_idx: int) -> torch.Tensor:
    """E = clamp(round(log2(ratio)), 0, e_max_idx) with torch-CPU's
    boundaries, from the bits: E = e + (mantissa >= LOG2_ROUND_UP_BITS[e])
    for ratio = m * 2^e. ratio must be positive and normal."""
    bits = ratio.view(torch.int32)
    e = (bits >> 23) - 127
    mant = bits & _MANT
    table = torch.from_numpy(LOG2_ROUND_UP_BITS.view(np.int32)).to(ratio.device)
    up = table[e.clamp(0, 126)]
    E = e + (mant >= up).to(torch.int32)
    return E.clamp(0, e_max_idx)


def _pot_reconstruct(w, s, e_max_idx, sign=None):
    """w_q = s * sign(w) * 2^clamp(round(log2(|w| / s)), 0, e_max_idx)."""
    ratio = (w.abs() / s).clamp_min(1e-10)
    E = _pot_round_log2(ratio, e_max_idx)
    sign = torch.sign(w) if sign is None else sign
    return s * sign * _exact_pow2(E)


def _base_scale(max_val: torch.Tensor, e_max_idx: int) -> torch.Tensor:
    """s0 = 2^(floor(log2 max|w|) - e_max_idx), TINY below the normal range."""
    e_min = _floor_log2(max_val.clamp_min(1e-12)) - e_max_idx
    return torch.where(e_min >= -126, _exact_pow2(e_min), torch.full_like(max_val, _TINY))


def _candidates(grid, grid_values) -> list[float]:
    if grid_values is not None:
        vals = np.array(grid_values, dtype=np.float32)
    else:
        start, stop, step = grid
        vals = np.arange(start, stop, step, dtype=np.float32)
    return [float(v) for v in vals]


def _scale_search(w, s0, candidates, e_max_idx, axis):
    """The best scale s0 * c per group: least SSE, strict <, the first
    candidate wins ties. torch-CPU's summation order when the group length
    divides by 8, else the double-float order."""
    sign = torch.sign(w)
    best_s = s0
    if w.shape[axis] % 8 == 0:
        best_e = torch.full_like(s0, float("inf"))
        for c in candidates:
            s_c = (s0 * c).clamp_min(_TINY)
            e = _sse_torch_cpu(w - _pot_reconstruct(w, s_c, e_max_idx, sign), axis)
            take = e < best_e
            best_e = torch.where(take, e, best_e)
            best_s = torch.where(take, s_c, best_s)
        return best_s
    bh = torch.full_like(s0, float("inf"))
    bl = torch.zeros_like(s0)
    for c in candidates:
        s_c = (s0 * c).clamp_min(_TINY)
        eh, el = _sse_df(w - _pot_reconstruct(w, s_c, e_max_idx, sign), axis)
        take = _df_less(eh, el, bh, bl)
        bh = torch.where(take, eh, bh)
        bl = torch.where(take, el, bl)
        best_s = torch.where(take, s_c, best_s)
    return best_s


def pot_quantize_tensor(w: torch.Tensor, n_bit: int = 4, q_group_size: int = -1,
                        grid: tuple = (0.01, 2.01, 0.01), grid_values=None) -> torch.Tensor:
    """POT fake-quantize w (groups along the last axis, or whole rows for
    q_group_size <= 0); returns w's shape and dtype. grid = (start, stop,
    step) of the scale multipliers; grid_values (explicit f32 values, e.g.
    the frozen parity grids) overrides it."""
    orig_shape, orig_dtype = w.shape, w.dtype
    if q_group_size > 0:
        if orig_shape[-1] % q_group_size != 0:
            raise ValueError(f"last dim {orig_shape[-1]} % group {q_group_size} != 0")
        w = w.reshape(-1, q_group_size)
    w = w.to(torch.float32)
    e_max_idx = 2 ** (n_bit - 1) - 1
    s0 = _base_scale(w.abs().amax(dim=1, keepdim=True), e_max_idx)
    best = _scale_search(w, s0, _candidates(grid, grid_values), e_max_idx, 1)
    w_q = _pot_reconstruct(w, best.clamp_min(_TINY), e_max_idx)
    return w_q.reshape(orig_shape).to(orig_dtype)


def pot_codebook(n_bit: int, device="cpu") -> torch.Tensor:
    """Level table of POT codes: code = signbit << (b-1) | E decodes to
    (1 - 2 * signbit) * 2^E. f32 [2^b]."""
    pos = _exact_pow2(torch.arange(2 ** (n_bit - 1), dtype=torch.int32, device=device))
    return torch.cat([pos, -pos])


def pot_quantize_codes(w_kn: torch.Tensor, n_bit: int = 4, group_size: int = 128,
                       grid: tuple = (0.01, 2.01, 0.01), grid_values=None):
    """Quantize a [K, N] weight (groups tiling K) to POT codes for packed
    serving. Returns (codes uint8 [K, N] = signbit << (b-1) | E, scales f32
    [K/g, N]); w = scale * (1 - 2 * signbit) * 2^E. An exact zero decodes
    to +scale (the smallest positive level)."""
    K, N = w_kn.shape
    g = group_size
    w = w_kn.to(torch.float32).reshape(K // g, g, N)
    e_max_idx = 2 ** (n_bit - 1) - 1
    s0 = _base_scale(w.abs().amax(dim=1, keepdim=True), e_max_idx)
    s = _scale_search(w, s0, _candidates(grid, grid_values), e_max_idx, 1).clamp_min(_TINY)
    E = _pot_round_log2((w.abs() / s).clamp_min(1e-10), e_max_idx)
    signbit = (w < 0).to(torch.int32)
    codes = (signbit << (n_bit - 1)) | E
    return codes.reshape(K, N).to(torch.uint8), s.reshape(K // g, N)
