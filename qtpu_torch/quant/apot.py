"""Additive power-of-two (APOT) quantization (port of qtpu/quant/apot.py).

The codebook's levels are sums of n = max(1, n_bit // k) power-of-two
terms, normalized to max 1, made symmetric and cut to `max_levels` by a
linspace subsample (host numpy, as in qtpu). Per group of weights the
scale s = s0 * c (s0 = clamp(max|w|, 1e-5)) of least SSE over the grid's
candidates is kept (double-float sums, strict <, the first candidate wins
ties), each weight taking its nearest level. The nearest level is a
strict-< select chain over the levels, so the lower index wins a tie, as
qtpu's (no searchsorted). Normalized APOT levels are not all exact in bf16
(at W4, k = 2 they are sums of powers of two divided by 1.5), so the
codebook is kept in f32.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from qtpu_torch.quant.pot import _candidates, _df_less, _sse_df


def generate_apot_levels(n: int, k: int) -> np.ndarray:
    """All (2^k)^n additive power-of-two sums, deduplicated and sorted
    ascending (unsigned), f32."""
    num_choices = 2**k
    per_term = []
    for i in range(n):
        vals = [0.0]
        for j in range(1, num_choices):
            vals.append(2.0 ** (-(i + (j - 1) * n)))
        per_term.append(vals)
    sums = {float(sum(combo)) for combo in itertools.product(*per_term)}
    return np.array(sorted(sums), dtype=np.float32)


def full_apot_codebook(n_bit: int, k: int, max_levels: int = 32) -> np.ndarray:
    """Signed, normalized, capped codebook: {-L reversed, 0, +L}, max |v| = 1,
    subsampled by linspace if longer than max_levels."""
    n = max(1, n_bit // k)
    levels = generate_apot_levels(n, k)
    mx = levels.max()
    if mx > 0:
        levels = levels / mx
    pos = levels[levels > 0]
    full = np.concatenate([-pos[::-1], [0.0], pos]).astype(np.float32)
    if full.size > max_levels:
        idx = np.linspace(0, full.size - 1, max_levels).astype(np.int64)
        full = full[idx]
    return full


def _nearest(x: torch.Tensor, levels: np.ndarray, index: bool) -> torch.Tensor:
    """The nearest level (or with index=True its index) of each element of
    x: a running minimum of |x - level| over the levels in order, strict <,
    so the lower index wins a tie."""
    lv = [float(v) for v in levels]
    best_d = (x - lv[0]).abs()
    best = (torch.zeros(x.shape, dtype=torch.int32, device=x.device) if index
            else torch.full_like(x, lv[0]))
    for i in range(1, len(lv)):
        d = (x - lv[i]).abs()
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best = torch.where(take, i if index else lv[i], best)
    return best


def _nearest_level(x: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    return _nearest(x, levels, index=False)


def _nearest_index(x: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    return _nearest(x, levels, index=True)


def _scale_search(w, s0, candidates, levels, axis):
    """The scale s0 * c of least double-float SSE (strict <, first wins)."""
    bh = torch.full_like(s0, float("inf"))
    bl = torch.zeros_like(s0)
    best = s0
    for c in candidates:
        s_c = s0 * c
        w_q = s_c * _nearest_level(w / s_c, levels)
        eh, el = _sse_df(w - w_q, axis)
        take = _df_less(eh, el, bh, bl)
        bh = torch.where(take, eh, bh)
        bl = torch.where(take, el, bl)
        best = torch.where(take, s_c, best)
    return best


def apot_quantize_tensor(w: torch.Tensor, n_bit: int = 4, q_group_size: int = -1, k: int = 2,
                         grid: tuple = (0.01, 2.01, 0.05), grid_values=None) -> torch.Tensor:
    """APOT fake-quantize w (groups along the last axis, or whole rows for
    q_group_size <= 0) on the 32-level codebook; returns w's shape and
    dtype."""
    orig_shape, orig_dtype = w.shape, w.dtype
    if q_group_size > 0:
        if orig_shape[-1] % q_group_size != 0:
            raise ValueError(f"last dim {orig_shape[-1]} % group {q_group_size} != 0")
        w = w.reshape(-1, q_group_size)
    w = w.to(torch.float32)
    levels = full_apot_codebook(n_bit, k)
    s0 = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-5)
    best = _scale_search(w, s0, _candidates(grid, grid_values), levels, 1)
    w_q = best * _nearest_level(w / best, levels)
    return w_q.reshape(orig_shape).to(orig_dtype)


def apot_quantize_codes(w_kn: torch.Tensor, n_bit: int = 4, group_size: int = 128, k: int = 2,
                        grid: tuple = (0.01, 2.01, 0.05), grid_values=None):
    """Quantize a [K, N] weight (groups tiling K) to codebook indices for
    packed serving, on the codebook capped at 2^n_bit levels (16 at W4) so
    an index fits n_bit bits. Returns (codes uint8 [K, N], scales f32
    [K/g, N], codebook f32 [<= 2^n_bit]); w = scale * codebook[code]."""
    K, N = w_kn.shape
    g = group_size
    levels = full_apot_codebook(n_bit, k, max_levels=2**n_bit)
    w = w_kn.to(torch.float32).reshape(K // g, g, N)
    s0 = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-5)
    s = _scale_search(w, s0, _candidates(grid, grid_values), levels, 1)
    codes = _nearest_index(w / s, levels)
    return (codes.reshape(K, N).to(torch.uint8), s.reshape(K // g, N),
            torch.from_numpy(levels).to(w_kn.device))
