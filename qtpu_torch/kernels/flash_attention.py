"""K5: causal / sliding-window GQA flash attention (csrc/flash_attention.cu).

`flash_attention` replaces pallas_flash_attention
(qtpu/kernels/pallas_flash_attention.py:86) at its signature: q [B, H, S,
hd], k/v [B, KV, S, hd] bf16, window 0 (causal) or > 0 (key k attends to
query q when q - window < k <= q); returns [B, H, S, hd] in q's dtype. A
CUDA tensor launches the kernel at any S (the kernel masks its ragged last
tile); it takes strided views with a contiguous head dim, and its output is
a [B, H, S, hd] view of a contiguous [B, S, H, hd] tensor, so a caller
holding [B, S, H, hd] projections passes `.transpose(1, 2)` views and gets
[B, S, H * hd] back with no copy. Its limits, H % KV == 0 and a head_dim
that is a multiple of 8 from 8 to 256 (`supported`, which a model's route
asks before the call: qtpu's Pallas kernel takes those and more, its K2 stops
at 256), raise ValueError. A CPU tensor takes
`flash_attention_plain`, the f32 math of the Pallas kernel.

Which body a launch runs is `flash_route`, the kernel's own rule
(flash_wgmma_fits): "wgmma", the Hopper body (wgmma fed by TMA), where q,
k and v are 16-byte aligned with strides of whole 16-byte units; "mma", the
mma.sync body, for the rest (a q at 4-byte alignment or odd multiples of 2
elements). `flash_attention.wgmma_launches` and `.mma_launches` count them.
The Hopper body's key tiles are 128 keys, 64 above hd 128.
`flash_attention_mma` runs the mma.sync body whatever the rule says: the
earlier body on the same bytes, for chip_smoke.py's "was" times; no eval
path calls it.
"""

from __future__ import annotations

import math

import torch

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, L64, P, require

_SIG = {"qtpu_flash_attention": [P, P, P, P] + [L64] * 12 + [I] * 6 + [P],
        "qtpu_flash_attention_mma": [P, P, P, P] + [L64] * 12 + [I] * 6 + [P]}
MASKED = -1e30
HEAD_DIMS = tuple(range(8, 264, 8))  # both bodies (csrc: head_dim_ok, QTPU_HEAD_DIMS)


def supported(hd: int) -> bool:
    """Whether the kernel takes this head dim (its check in `_launch`): a
    multiple of 8 from 8 to 256."""
    return hd in HEAD_DIMS


def attention_mask(S: int, window: int, device) -> torch.Tensor:
    """[S, S] True where query i attends to key j: j <= i, and j > i -
    window when window > 0."""
    i = torch.arange(S, device=device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    return mask


def flash_attention_plain(q, k, v, window: int = 0):
    """The kernel's function in f32: q / sqrt(hd), f32 scores, -1e30 for
    masked keys, softmax, probabilities times v; output in q's dtype."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = (q.float() / math.sqrt(hd)) @ kf.transpose(-1, -2)
    scores = scores.masked_fill(~attention_mask(S, window, q.device), MASKED)
    return (torch.softmax(scores, dim=-1) @ vf).to(q.dtype)


def _check(name, t, shape, device):
    require(t.dtype == torch.bfloat16, f"{name} must be bf16, got {t.dtype}")
    require(t.dim() == 4 and tuple(t.shape) == shape, f"{name} must be {shape}, got {tuple(t.shape)}")
    require(t.device == device, f"{name} lies on {t.device}, q on {device}")
    require(t.stride(3) == 1, f"{name}'s head dim must be contiguous")


WGMMA_BQ = 128  # query rows a block of the Hopper body (two warpgroups of 64)
WGMMA_BK = 128  # keys a tile of the Hopper body up to hd 128 (64 above: FaLayout::BK)


def flash_tiles(q0: int, S: int, window: int, bq: int = WGMMA_BQ, bk: int = WGMMA_BK):
    """The key tiles a block of query rows q0 .. q0 + bq - 1 visits (the
    kernels' kt_begin .. kt_end): from the window's first tile (0 when
    causal) to the diagonal's."""
    begin = max(q0 - window + 1, 0) // bk if window > 0 else 0
    return range(begin, (min(q0 + bq, S) - 1) // bk + 1)


def flash_tile_masked(k0: int, q0w: int, window: int, rows: int = 64,
                      bk: int = WGMMA_BK) -> bool:
    """Whether the rows q0w .. q0w + rows - 1 (a warpgroup of the Hopper
    body) mask the tile of keys k0 .. k0 + bk - 1: it crosses the diagonal
    or the window's edge; every other tile is taken whole."""
    return k0 + bk - 1 > q0w or (window > 0 and k0 <= q0w + rows - 1 - window)


def flash_route(hd: int, ptrs, strides) -> str:
    """The body qtpu_flash_attention runs for a call the wrapper takes: ptrs
    the data pointers of q, k and v, strides their batch, head and position
    strides in elements. "wgmma" where every pointer is 16-byte aligned and
    every stride a positive multiple of 8 below 2^39 (TMA's tensor maps), at
    a head_dim the kernel takes; else "mma"."""
    ok = (supported(hd) and all(p % 16 == 0 for p in ptrs)
          and all(s % 8 == 0 and 0 < s < 1 << 39 for s in strides))
    return "wgmma" if ok else "mma"


def flash_attention(q, k, v, window: int = 0):
    """Causal (window 0) or sliding-window attention, GQA read in place."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    out, route = _launch(q, k, v, window, "qtpu_flash_attention")
    if route is not None:
        flash_attention.launches += 1
        if route == "wgmma":
            flash_attention.wgmma_launches += 1
        else:
            flash_attention.mma_launches += 1
    return out


def flash_attention_mma(q, k, v, window: int = 0):
    """flash_attention on the mma.sync body whatever flash_route says: the
    Hopper body's earlier body on the same bytes, for chip_smoke.py's "was"
    times. Card tensors only; counted in its own `.launches`."""
    out, _ = _launch(q, k, v, window, "qtpu_flash_attention_mma")
    flash_attention_mma.launches += 1
    return out


def _launch(q, k, v, window, entry):
    """One launch of the C entry on card tensors; returns (out, the body
    flash_route names, None for an empty call)."""
    require(q.is_cuda, f"unsupported device {q.device}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    require(KV > 0 and H % KV == 0, f"H={H} must be a multiple of KV={KV}")
    require(supported(hd), f"head_dim {hd} must be a multiple of 8, 8 <= hd <= 256")
    _check("q", q, (B, H, S, hd), q.device)
    _check("k", k, (B, KV, S, hd), q.device)
    _check("v", v, (B, KV, S, hd), q.device)
    for name, t in (("k", k), ("v", v)):
        require(all(s % 8 == 0 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0,
                f"{name} rows must be 16-byte aligned (strides multiples of 8)")
    require(all(s % 2 == 0 for s in q.stride()[:3]) and q.data_ptr() % 4 == 0,
            "q rows must be 4-byte aligned (even strides)")
    out = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    if S == 0 or B == 0:
        return out, None
    lib = _build.load("flash_attention", _SIG)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    if KV == 1:  # one KV head (a TP rank's): its stride is any, so k and v
        # get the batch's and their tensor maps sort their dims alike
        strides[4], strides[7] = strides[3], strides[6]
    route = flash_route(hd, [t.data_ptr() for t in (q, k, v)], strides[:9])
    rc = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, H, KV, S, hd, int(window), _build.stream_of(q),
    )
    _build.check(rc, "flash_attention")
    return out, route


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.mma_launches = 0
flash_attention_mma.launches = 0
