"""K13: o-proj -> residual -> MLP -> residual -> next qkv in one launch
(csrc/layer_boundary.cu).

(y2, qkv) = layer_boundary(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv,
metas) with
    y   = x + attn @ Wo                       (f32)
    h   = bf16(rms_norm(y) * mlp_norm)
    act = bf16(silu(h @ Wg)) * bf16(h @ Wu)
    y2  = y + act @ Wd                        (returned as bf16)
    qkv = bf16(rms_norm(y2) * attn_norm_next) @ Wqkv
Replaces pallas_layer_boundary_stacked (qtpu/kernels/pallas_layer_boundary.py:139),
which reads layers l and l_next of the stacked weights by scalar prefetch;
here the caller passes the views W[l] of the o, gateup and down sites and
W[l_next] of the fused qkv site, each a dict {"data", "scales", "zeros"};
metas = (meta_o, meta_gu, meta_d, meta_qkv). A CUDA tensor launches the
cooperative kernel (one launch in the count; `supported` says beforehand
which packings it takes, and anything else raises); a CPU tensor takes
`layer_boundary_plain`, the f32 composition of qtpu's own test of the TPU
kernel (tests/test_pallas_kernels.py:504-576), weights dequantized in f32.

Which tiles the matmul phases run is `boundary_route`, the kernel's own
rule: the tensor-core step of the decode GEMV ("gemv_tc",
`layer_boundary.gemv_tc_launches`) or the first version's dq_core tiles
("gemv", `.gemv_launches`) for the calls it does not take.
`layer_boundary_dq` runs the dq_core tiles whatever the rule says: the
earlier body on the same bytes, for chip_smoke.py's "was" times; no
serving or eval path calls it.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as Fn

from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import F, I, P, require
from qtpu_torch.kernels.dequant_matmul import (GEMV_TC_BITS, GEMV_TC_COLS, GEMV_TC_GROUPS,
                                               check_packed, count_gemv)

_SIG = {
    "qtpu_layer_boundary_grid": [I, I, I],
    "qtpu_layer_boundary": [P] * 16 + [P] * 10 + [I] * 6 + [I] * 7 + [F, P],
}

MAX_M = 32  # decode rows, as the TPU kernel
SITE_KEYS = {"data", "scales", "zeros"}
TILE_ROWS = 8  # rows of a tile: M is cut into ceil(M / 8) row tiles
DQ_COLS = 32  # output columns of a dq_core tile
# the tensor-core tiles (csrc/layer_boundary.cu's lb_tc_fits; the GEMV's
# bits, groups and 128 columns): the most K values of a slice, and a tile's
# fixed cost (its first loads, the reduction, the partials' write) in steps
# of a warp
TC_SLICE = 1024
TC_TILE_COST = 4
ROW_CHUNK = 128  # columns of a row-phase item of the tensor-core build (its threads)


def supported(metas, sites) -> bool:
    """Whether K13 takes these four packed sites (o, gateup, down, qkv) and
    metas: affine asymmetric W4/W8 with one bits and group, metas that chain
    (o [Q, D], gateup [D, 2F], down [F, D], qkv [D, Nq]), the raises of
    pallas_layer_boundary_stacked; and N % 4 == 0 for qkv's columns."""
    if len(metas) != 4 or any(m is None or len(m) != 4 for m in metas):
        return False
    if any(not isinstance(s, dict) or set(s) != SITE_KEYS or s["zeros"] is None for s in sites):
        return False
    (bits, group, Q, D), (b2, g2, K2, N2), (b3, g3, F_, D3), (b4, g4, K4, Nq) = metas
    return (
        len({bits, b2, b3, b4}) == 1 and len({group, g2, g3, g4}) == 1
        and K2 == D and D3 == D and K4 == D and N2 == 2 * F_
        and bits in (4, 8) and group > 0 and group % 4 == 0
        and Q % group == 0 and D % group == 0 and F_ % group == 0 and Nq % 4 == 0
    )


def _rms32(v, w, eps):
    return v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps) * w.float()


def layer_boundary_plain(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps=1e-5):
    mo, mgu, md, mq = metas
    F_ = md[2]

    def dq(site, meta):
        return dequantize_parts(site["data"], site["scales"], site["zeros"], meta[0], meta[1],
                                torch.float32)

    y = x.float() + attn.float() @ dq(o, mo)
    h = _rms32(y, mlp_norm, eps).to(torch.bfloat16).float()
    g_u = h @ dq(gu, mgu)
    gate, up = g_u[..., :F_], g_u[..., F_:]
    act = (Fn.silu(gate).to(torch.bfloat16) * up.to(torch.bfloat16)).float()
    y2 = y + act @ dq(d, md)
    h2 = _rms32(y2, attn_norm_next, eps).to(torch.bfloat16).float()
    return y2.to(x.dtype), (h2 @ dq(qkv, mq)).to(x.dtype)


def boundary_route(metas, ptrs) -> str:
    """The tiles K13's matmul phases run for these (supported) metas; ptrs:
    the pointers of attn and of every site's codes, scales and zeros (the
    wrapper's scratch is 16-byte aligned when D is). "gemv_tc"
    (csrc/layer_boundary.cu's lb_tc_fits: W4/W8, group 64 or 128, D, 2F and
    Nq multiples of 16, every pointer 16-byte aligned), else "gemv" (the
    dq_core tiles)."""
    (bits, group, _, D), (_, _, _, N2), _, (_, _, _, Nq) = metas
    ok = (bits in GEMV_TC_BITS and group in GEMV_TC_GROUPS
          and all(n % 16 == 0 for n in (D, N2, Nq)) and all(p % 16 == 0 for p in ptrs))
    return "gemv_tc" if ok else "gemv"


@lru_cache(maxsize=None)
def _grid(index: int, bits: int, group: int, tc: bool) -> int:
    lib = _build.load("layer_boundary", _SIG)
    with torch.cuda.device(index):
        blocks = lib.qtpu_layer_boundary_grid(bits, group, int(tc))
    if blocks <= 0:
        raise RuntimeError(f"layer_boundary: no cooperative grid on this card ({blocks})")
    return blocks


def _slices(K: int, group: int, tiles: int, blocks: int, tc: bool = False):
    """How a phase of `tiles` output tiles splits K over a grid of `blocks`:
    the slice count (of whole groups) whose busiest block has the least
    work, counted as its rounds of tiles times a tile's cost; the fewest
    slices among equals. dq_core tiles: slices of at least 256 K values, a
    tile's cost its groups + 1 (its own staging and reduction). Tensor-core
    tiles: slices of at most TC_SLICE K values, a tile's cost its steps of 16
    K values a warp (4 warps) + TC_TILE_COST. Returns (groups per slice,
    slices)."""
    groups = K // group
    if tc:
        first = -(-groups // max(1, TC_SLICE // group))
        counts = range(first, groups + 1)
    else:
        counts = range(1, max(1, min(groups, K // 256)) + 1)
    best = None
    for n in counts:
        per = -(-groups // n)
        slices = -(-groups // per)
        work = -(-per * group // 64) + TC_TILE_COST if tc else per + 1
        cost = -(-tiles * slices // blocks) * work
        if best is None or cost < best[0]:
            best = (cost, per, slices)
    return best[1], best[2]


def plan(metas, M: int, blocks: int, tc: bool):
    """((groups per slice, slices) of the o, gateup, down and qkv phases) for
    M rows on a grid of `blocks`, with the tiles of the route."""
    cols = GEMV_TC_COLS if tc else DQ_COLS
    mt = -(-M // TILE_ROWS)
    return tuple(_slices(K, g, -(-N // cols) * mt, blocks, tc) for _, g, K, N in metas)


def _launch(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps, dq: bool):
    """One launch of the cooperative kernel on card tensors; returns (y2, qkv,
    the tiles it ran). dq: the dq_core tiles whatever boundary_route says."""
    require(x.is_cuda, f"unsupported device {x.device}")
    sites = (o, gu, d, qkv)
    require(supported(metas, sites), f"layer_boundary takes chained asymmetric W4/W8 sites "
                                     f"of one bits and group, got {metas}")
    mo, mgu, md, mq = metas
    bits, group, Q, D = mo
    F_, Nq = md[2], mq[3]
    lead = x.shape[:-1]
    M = x.numel() // D
    require(x.dtype == torch.bfloat16 and attn.dtype == torch.bfloat16,
            "attn and x must be bf16")
    require(x.shape[-1] == D and tuple(attn.shape) == (*lead, Q)
            and x.is_contiguous() and attn.is_contiguous() and attn.device == x.device,
            f"attn [..., {Q}] and x [..., {D}] must be contiguous with the same rows")
    require(0 < M <= MAX_M, f"layer_boundary is decode-only: M={M} > {MAX_M}")
    for w in (mlp_norm, attn_norm_next):
        require(w.dtype == torch.bfloat16 and tuple(w.shape) == (D,) and w.device == x.device,
                "the norm rows must be bf16 [D]")
    for s, m in zip(sites, metas):
        check_packed(s["data"], s["scales"], s["zeros"], m, x.device)
    require(x.data_ptr() % 8 == 0 and attn.data_ptr() % 8 == 0, "x and attn must be 8-byte aligned")
    ptrs = [attn.data_ptr()] + [s[k].data_ptr() for s in sites for k in ("data", "scales", "zeros")]
    route = "gemv" if dq else boundary_route(metas, ptrs)
    tc = route == "gemv_tc"
    dev = x.device
    blocks = _grid(dev.index or 0, bits, group, tc)
    (per_o, so), (per_gu, sgu), (per_d, sd), (per_q, sq) = plan(metas, M, blocks, tc)
    # f32 scratch: y and the row sums of 128-column chunks, part_o, part_gu,
    # part_d, part_q; bf16: h, h2, act
    n_y = M * D + M * -(-D // ROW_CHUNK)
    n_o, n_gu, n_d = so * M * D, sgu * M * 2 * F_, sd * M * D
    f32 = torch.empty(n_y + n_o + n_gu + n_d + (sq * M * Nq if sq > 1 else 0),
                      dtype=torch.float32, device=dev)
    b16 = torch.empty(2 * M * D + M * F_, dtype=torch.bfloat16, device=dev)
    y2 = torch.empty_like(x)
    out = torch.empty(*lead, Nq, dtype=torch.bfloat16, device=dev)
    fp, bp = f32.data_ptr(), b16.data_ptr()
    lib = _build.load("layer_boundary", _SIG)
    rc = lib.qtpu_layer_boundary(
        attn.data_ptr(), x.data_ptr(), mlp_norm.data_ptr(), attn_norm_next.data_ptr(),
        *(s[k].data_ptr() for s in sites for k in ("data", "scales", "zeros")),
        y2.data_ptr(), out.data_ptr(),
        fp, bp, bp + 4 * M * D, bp + 2 * M * D,  # y; h, act, h2
        fp + 4 * n_y, fp + 4 * (n_y + n_o), fp + 4 * (n_y + n_o + n_gu),
        fp + 4 * (n_y + n_o + n_gu + n_d) if sq > 1 else None,
        per_o, per_gu, per_d, per_q, int(tc), blocks,
        M, Q, D, F_, Nq, bits, group, float(eps), _build.stream_of(x),
    )
    _build.check(rc, "layer_boundary")
    return y2, out, route


def layer_boundary(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps=1e-5):
    """attn [..., Q], x [..., D] bf16 with at most 32 rows -> (y2 [..., D],
    qkv [..., Nq])."""
    if x.device.type == "cpu":
        return layer_boundary_plain(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps)
    y2, out, route = _launch(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps,
                             dq=False)
    layer_boundary.launches += 1
    count_gemv(layer_boundary, route)
    return y2, out


def layer_boundary_dq(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps=1e-5):
    """layer_boundary on the dq_core tiles whatever boundary_route says: the
    tensor-core phases' earlier body on the same bytes, for chip_smoke.py's
    "was" times. Card tensors only; counted in its own `.launches`."""
    require(x.is_cuda, "layer_boundary_dq runs on the card only")
    y2, out, _ = _launch(attn, x, mlp_norm, attn_norm_next, o, gu, d, qkv, metas, eps, dq=True)
    layer_boundary_dq.launches += 1
    return y2, out


layer_boundary.launches = 0
layer_boundary.gemv_tc_launches = 0
layer_boundary.gemv_launches = 0
layer_boundary_dq.launches = 0
