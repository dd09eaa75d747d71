"""K6: W8A8 matmul with dynamic per-token int8 activations (SmoothQuant
W8A8 serving; port of qtpu/kernels/int8_matmul.py and
pallas_int8_matmul.py).

  x_q = clamp(round(x / sx), -127, 127),  sx = max(max|x| per token / 127, 1e-8)
  y   = (x_q @ w_q - sum(x_q) * z_w) * s_w * sx

with per-channel asymmetric int8 weights (one group spanning K: meta
(8, K, K, N)), stored as qtpu stores W8: data = w_q - 128, int8 [K, N];
scales bf16 [1, N]; zeros uint8 [1, N].

`w8a8_matmul` launches the kernel of csrc/w8a8_matmul.cu on a CUDA tensor
(it replaces pallas_w8a8_matmul) and takes `w8a8_matmul_plain`, the math of
qtpu's XLA reference `_w8a8_matmul_ref`, on a CPU tensor. The rounding of
`quantize_activations` is that of qtpu's jitted reference: XLA folds the
division by 127 into a multiply by its f32 reciprocal, while x / sx stays
a true division (tests/test_torch_w8a8.py holds both bit for bit).

Which body the product runs is `w8a8_route`, the kernel's own rule: the
GEMV (M <= 8), the Hopper route (int8 wgmma fed by TMA) or the mma.sync
body for the M > 8 calls the route does not take.
`w8a8_matmul.wgmma_launches` and `.mma_launches` count the launches of
those two (all are in `.launches`). `w8a8_matmul_mma` runs the mma.sync body
on any M > 8 call: the route's earlier body, kept so that chip_smoke.py can
time and compare both on the same bytes; no serving or eval path calls it.
At M <= 8 `w8a8_gemv_route` picks between the tensor-core GEMV (one launch:
int8 mma.sync fed by a cp.async ring, x quantized inside, K split over a
thread-block cluster by `w8a8_gemv_split`; `.gemv_tc_launches`) and the
dp4a GEMV for the calls it does not take (quantize, GEMV and, with K split
by `gemv_split`, a finishing launch; `.gemv_launches`).
`w8a8_matmul_dp4a` runs the dp4a GEMV whatever `w8a8_gemv_route` says: the
earlier body on the same bytes, for chip_smoke.py's "was" times and bit
checks; no serving or eval path calls it.

Two modes serve a row-parallel site under tensor parallelism, whose
per-token scale spans the whole K while a rank holds a slice of it (the
TPU kernel takes the absmax inside its body, pallas_int8_matmul.py:40-43):
`w8a8_absmax` (*absmax out*: the quantize kernel writes each token's |x|
max of the rank's slice and nothing else; counted in its `.launches`), and
`w8a8_matmul(..., absmax=)` (*absmax in*: every body quantizes x with the
given per-token absmax, the all-reduced one, in place of its own, and
writes in place of y the rank's int32 sums acc + Σxq (128 - z) over its K
slice; counted in `.absmax_in_launches` and by route in
`.absmax_in_<route>_launches`). The group sums them exactly and
`w8a8_epilogue` (K6's rescale in a launch of its own, `.launches`) gives
every rank one rank's whole product, bit for bit, as qtpu's GSPMD reduces
before the rescale; with the rank's own absmax fed back, the rescaled sums
are the usual mode's bits. Their plain versions are `absmax_plain`,
`w8a8_matmul_plain` with a given absmax, and `w8a8_epilogue_plain`.
"""

from __future__ import annotations

import torch

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require
from qtpu_torch.kernels.dequant_matmul import GEMV_TC_COLS, _sm_count, count_gemv
from qtpu_torch.kernels.dequant_matmul import gemv_split as _cluster_split

_SIG = {"qtpu_w8a8_matmul": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        "qtpu_w8a8_matmul_mma": [P, P, P, P, P, P, P, P, P, I, I, I, P],
        "qtpu_w8a8_absmax": [P, P, I, I, P],
        "qtpu_w8a8_epilogue": [P, P, P, P, I, I, P]}

GEMV_ROWS = 8  # M <= 8 runs the GEMV kernel, larger M the tensor-core one
GEMV_COLS = 256  # output columns per GEMV block (4 warps)
GEMV_STAGE = 32768  # bytes of xq a GEMV block stages: M x its K rows at most
K_ALIGN = 64  # the activation scratch's row length is K rounded up to this
GEMV_TC_STEP = 32  # the tensor-core GEMV's K rows a step (one mma.sync m16n8k32)


def w8a8_route(M: int, N: int, ptrs) -> str:
    """The body qtpu_w8a8_matmul runs for an [M, K] x [K, N] call; ptrs:
    the pointers of the weight and its scales. "wgmma" (csrc/w8a8_matmul.cu's
    w8a8_wgmma_fits: M > 8, N % 16 == 0 so TMA can stride the N-byte rows,
    both pointers 16-byte aligned), "mma" (the other M > 8 calls) or "gemv"
    (M <= 8)."""
    if M <= GEMV_ROWS:
        return "gemv"
    return "wgmma" if N % 16 == 0 and all(p % 16 == 0 for p in ptrs) else "mma"


def w8a8_gemv_split(sms: int, N: int, K: int):
    """How the tensor-core GEMV splits K: (cluster, K rows a slice), K1's
    rule (dequant_matmul.gemv_split) over steps of 32 K rows in place of
    groups: the smallest cluster of 1, 2, 4 or 8 whose ceil(N / 128) x
    cluster blocks reach one an SM with slices of at most 2048 rows, else
    the largest cluster (at most 8, the portable size) that covers K with
    slices of at most 4096 rows, no slice empty. None where none fits. One
    block an SM, not K1's two: a block holds x's slice twice (bf16, then
    int8) beside its 48 KB ring, so two fit an SM at TinyLlama's lm_head,
    where K1's rule would take a cluster of 2 and two waves of blocks (54.3
    µs on an H100 against 48.8 for a cluster of 1, tools/exp_w8a8_k13.py)."""
    split = _cluster_split(sms, -(-N // GEMV_TC_COLS), K // GEMV_TC_STEP, GEMV_TC_STEP,
                           per_sm=1)
    return None if split is None else (split[0], split[1] * GEMV_TC_STEP)


def w8a8_gemv_route(M: int, K: int, N: int, ptrs) -> str:
    """The GEMV an M <= 8 call runs (csrc/w8a8_matmul.cu's w8a8_gemv_tc_fits);
    ptrs: the pointers of x and the weight. "gemv_tc", the tensor-core GEMV,
    at N % 16 == 0, K % 32 == 0, both pointers 16-byte aligned and a split of
    K that w8a8_gemv_split finds; else "gemv", the dp4a body."""
    ok = (0 < M <= GEMV_ROWS and N % 16 == 0 and K % GEMV_TC_STEP == 0
          and all(p % 16 == 0 for p in ptrs) and w8a8_gemv_split(1, N, K) is not None)
    return "gemv_tc" if ok else "gemv"


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Each token's max |x| over the last axis, f32 [..., 1]: w8a8_absmax's
    plain version."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_activations(x: torch.Tensor, absmax=None):
    """Per-token (last-axis) symmetric int8: returns (x_q int8, sx f32
    [..., 1]); absmax (f32 [..., 1]) in place of x's own, as under
    tensor parallelism."""
    xf = x.float()
    if absmax is None:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(absmax.reshape(*xf.shape[:-1], 1) * (1.0 / 127.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / sx), -127, 127)
    return x_q.to(torch.int8), sx


def w8a8_matmul_plain(x, data, scales, zeros, meta, absmax=None):
    """qtpu's `_w8a8_matmul_ref`: the integer product exact in float64
    (torch.matmul has no int32 path on the card and a slow one on the CPU;
    every partial sum is an integer below 2^53), the rescale in f32. With
    absmax (each token's |x| max to quantize with, quantize_activations)
    the int32 sums before the rescale (w8a8_epilogue_plain's input)."""
    bits, group, K, N = meta[:4]
    if bits != 8 or group != K:
        raise ValueError("w8a8 path needs per-channel (group=K) int8 weights")
    x_q, sx = quantize_activations(x, absmax)
    acc = x_q.double() @ (data.double() + 128)
    zw = zeros.to(torch.int32).reshape(1, N)
    if absmax is not None:
        sum_q = x_q.to(torch.int64).sum(dim=-1, keepdim=True)
        return (acc.to(torch.int64) - sum_q * zw).to(torch.int32)
    acc = acc.float()
    sum_xq = x_q.to(torch.int32).sum(dim=-1, keepdim=True).float()
    sw = scales.float().reshape(1, N)
    return ((acc - sum_xq * zw.float()) * sw * sx).to(x.dtype)


def w8a8_epilogue_plain(total, absmax, scales, dtype=torch.bfloat16):
    """The absmax-in mode's rescale: (float(total) s) sx in f32, sx from the
    per-token absmax as quantize_activations takes it, cast to dtype."""
    sx = torch.clamp(absmax.reshape(*total.shape[:-1], 1) * (1.0 / 127.0), min=1e-8)
    return ((total.float() * scales.float().reshape(-1)) * sx).to(dtype)


def gemv_rows(M: int, K: int, N: int, sms: int) -> int:
    """K rows of one GEMV block's slice (M <= 8): at least 64 (a multiple of
    4), enough slices for about four blocks per SM, and at most what the
    block stages in shared memory (M x rows <= GEMV_STAGE bytes of xq)."""
    tiles = -(-N // GEMV_COLS)
    slices = max(1, min(K // 64, -(-4 * sms // tiles)))
    rows = -(-K // slices)
    return min(rows + -rows % 4, GEMV_STAGE // M // 4 * 4)


def gemv_split(device, M: int, K: int, N: int):
    """gemv_rows on this card. Returns (rows per slice, the int32 scratch
    of slices x M x N partial sums, or None for one slice)."""
    rows = gemv_rows(M, K, N, _sm_count(device.index or 0))
    slices = -(-K // rows)
    part = (torch.empty(slices * M * N, dtype=torch.int32, device=device)
            if slices > 1 else None)
    return rows, part


def _check_absmax(x, absmax, M):
    require(absmax.dtype == torch.float32 and absmax.numel() == M and absmax.is_contiguous()
            and absmax.device == x.device, "absmax must be contiguous f32 [..., 1] on x's card")


def _check(x, data, scales, zeros, meta):
    """The wrapper's checks of a card call: what the kernels take."""
    bits, group, K, N = meta[:4]
    require(x.is_cuda, f"unsupported device {x.device}")
    require(bits == 8 and group == K, f"w8a8 takes per-channel int8 weights, got meta {meta}")
    require(zeros is not None, "w8a8 takes asymmetric weights (zeros)")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(x.shape[-1] == K and x.is_contiguous(), "x must be contiguous [..., K]")
    require(K % 4 == 0 and N % 4 == 0, f"K={K} and N={N} must be multiples of 4")
    require(data.dtype == torch.int8 and tuple(data.shape) == (K, N),
            f"data must be int8 [{K}, {N}], got {data.dtype} {tuple(data.shape)}")
    require(scales.dtype == torch.bfloat16 and scales.numel() == N, "scales must be bf16 [1, N]")
    require(zeros.dtype == torch.uint8 and zeros.numel() == N, "zeros must be uint8 [1, N]")
    for t in (data, scales, zeros):
        require(t.device == x.device, f"weights on {t.device}, activations on {x.device}")
        require(t.is_contiguous(), "packed weights must be contiguous")
    require(data.data_ptr() % 4 == 0, "data must be 4-byte aligned")


def _scratch(x, M, K):
    """The activation quantization's scratch of the launches that quantize
    x first: xq int8 [M, Kp], sx f32 [M], sum(xq) int32 [M]."""
    Kp = -(-K // K_ALIGN) * K_ALIGN
    return (torch.empty(M * Kp, dtype=torch.int8, device=x.device),
            torch.empty(M, dtype=torch.float32, device=x.device),
            torch.empty(M, dtype=torch.int32, device=x.device))


def _out(x, N, absmax):
    """y in bf16, or with a given absmax the int32 sums."""
    dtype = torch.bfloat16 if absmax is None else torch.int32
    return torch.empty(*x.shape[:-1], N, dtype=dtype, device=x.device)


def _launch(x, data, scales, zeros, meta, dp4a: bool, absmax=None):
    """One call of csrc/w8a8_matmul.cu on card tensors; returns (out, the
    body it ran). dp4a: the dp4a GEMV at M <= 8 whatever w8a8_gemv_route
    says; absmax: the per-token absmax to quantize with (absmax in: int32
    sums before the rescale in place of y)."""
    _check(x, data, scales, zeros, meta)
    K, N = meta[2:4]
    M = x.numel() // K
    out = _out(x, N, absmax)
    if M == 0:
        return out, None
    if absmax is not None:
        _check_absmax(x, absmax, M)
    amax = None if absmax is None else absmax.data_ptr()
    route = w8a8_route(M, N, (data.data_ptr(), scales.data_ptr()))
    if route == "gemv" and not dp4a:
        route = w8a8_gemv_route(M, K, N, (x.data_ptr(), data.data_ptr()))
    lib = _build.load("w8a8_matmul", _SIG)
    if route == "gemv_tc":
        # one launch: x quantized inside, K split over a thread-block cluster
        cluster, rows = w8a8_gemv_split(_sm_count(x.device.index or 0), N, K)
        rc = lib.qtpu_w8a8_matmul(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
            None, None, None, None, amax, rows, cluster, M, K, N, _build.stream_of(x),
        )
    else:
        xq, sx, sumq = _scratch(x, M, K)
        rows, part = gemv_split(x.device, M, K, N) if M <= GEMV_ROWS else (K, None)
        rc = lib.qtpu_w8a8_matmul(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), sumq.data_ptr(),
            None if part is None else part.data_ptr(), amax, rows, 0, M, K, N,
            _build.stream_of(x),
        )
    _build.check(rc, "w8a8_matmul")
    return out, route


def w8a8_matmul(x, data, scales, zeros, meta, absmax=None):
    """y = W8A8(x) for per-channel int8 weights; x [..., K] -> [..., N] in
    x's dtype (bf16 on the card). meta = (8, K, K, N), a 5-tuple's trailing
    "a8" tag allowed. absmax (f32 [..., 1]), the absmax-in mode: each
    token's |x| max to quantize with in place of x's own, and the result is
    the int32 sums before the rescale (w8a8_epilogue's input). One call is
    one launch in the count (on the tensor-core GEMV one CUDA launch; on the
    other bodies the activation quantization, the product and, at M <= 8
    with K split, the finishing pass)."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, data, scales, zeros, meta, absmax)
    out, route = _launch(x, data, scales, zeros, meta, dp4a=False, absmax=absmax)
    if route is None:
        return out
    w8a8_matmul.launches += 1
    count_gemv(w8a8_matmul, route)
    if absmax is not None:
        w8a8_matmul.absmax_in_launches += 1
        name = f"absmax_in_{route}_launches"
        setattr(w8a8_matmul, name, getattr(w8a8_matmul, name) + 1)
    return out


def w8a8_epilogue(total, absmax, scales, dtype=torch.bfloat16):
    """The rescale of the absmax-in mode's int32 sums, once a group has summed
    them: total [..., N] int32, absmax f32 [..., 1] (the all-reduced one),
    scales bf16 [1, N] -> [..., N] bf16 (K6's epilogue in a launch of its
    own); `w8a8_epilogue_plain` on a CPU tensor."""
    if total.device.type == "cpu":
        return w8a8_epilogue_plain(total, absmax, scales, dtype)
    require(dtype == torch.bfloat16, "K6's epilogue writes bf16")
    require(total.dtype == torch.int32 and total.is_contiguous(), "total must be int32")
    N = total.shape[-1]
    M = total.numel() // max(N, 1)
    _check_absmax(total, absmax, M)
    require(scales.dtype == torch.bfloat16 and scales.numel() == N and scales.is_contiguous(),
            "scales must be contiguous bf16 [1, N]")
    out = torch.empty(total.shape, dtype=torch.bfloat16, device=total.device)
    if M == 0:
        return out
    lib = _build.load("w8a8_matmul", _SIG)
    rc = lib.qtpu_w8a8_epilogue(total.data_ptr(), absmax.data_ptr(), scales.data_ptr(),
                                out.data_ptr(), M, N, _build.stream_of(total))
    _build.check(rc, "w8a8_epilogue")
    w8a8_epilogue.launches += 1
    return out


def w8a8_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each token's max |x| over the last axis, f32 [..., 1] (the absmax-out
    mode of K6's quantize kernel: one block a token row, nothing else
    written); `absmax_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return absmax_plain(x)
    require(x.is_cuda, f"unsupported device {x.device}")
    require(x.dtype == torch.bfloat16 and x.is_contiguous(), "x must be contiguous bf16")
    K = x.shape[-1]
    M = x.numel() // max(K, 1)
    out = torch.empty(*x.shape[:-1], 1, dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    require(K > 0, "w8a8_absmax takes K > 0")
    lib = _build.load("w8a8_matmul", _SIG)
    rc = lib.qtpu_w8a8_absmax(x.data_ptr(), out.data_ptr(), M, K, _build.stream_of(x))
    _build.check(rc, "w8a8_absmax")
    w8a8_absmax.launches += 1
    return out


def w8a8_matmul_dp4a(x, data, scales, zeros, meta, absmax=None):
    """w8a8_matmul with the dp4a GEMV at M <= 8 whatever w8a8_gemv_route
    says: the tensor-core GEMV's earlier body on the same bytes, for
    chip_smoke.py's "was" times and bit checks. Card tensors only; counted
    in its own `.launches`."""
    require(x.is_cuda, "w8a8_matmul_dp4a runs on the card only")
    out, _ = _launch(x, data, scales, zeros, meta, dp4a=True, absmax=absmax)
    w8a8_matmul_dp4a.launches += 1
    return out


def w8a8_matmul_mma(x, data, scales, zeros, meta, absmax=None):
    """w8a8_matmul on the mma.sync body at M > 8 whatever w8a8_route says:
    the Hopper route's earlier body on the same bytes, for chip_smoke.py's
    comparisons (its "was" times, the route's bits against these). Card
    tensors only; counted in its own `.launches`."""
    require(x.is_cuda, "w8a8_matmul_mma runs on the card only")
    _check(x, data, scales, zeros, meta)
    K, N = meta[2:4]
    M = x.numel() // K
    require(M > GEMV_ROWS, f"the mma.sync body takes M > {GEMV_ROWS}, got {M}")
    if absmax is not None:
        _check_absmax(x, absmax, M)
    out = _out(x, N, absmax)
    xq, sx, sumq = _scratch(x, M, K)
    lib = _build.load("w8a8_matmul", _SIG)
    rc = lib.qtpu_w8a8_matmul_mma(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), sumq.data_ptr(),
        None if absmax is None else absmax.data_ptr(), M, K, N, _build.stream_of(x),
    )
    _build.check(rc, "w8a8_matmul_mma")
    w8a8_matmul_mma.launches += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.wgmma_launches = 0
w8a8_matmul.mma_launches = 0
w8a8_matmul.gemv_tc_launches = 0
w8a8_matmul.gemv_launches = 0
w8a8_matmul.absmax_in_launches = 0
for _r in ("wgmma", "mma", "gemv_tc", "gemv"):
    setattr(w8a8_matmul, f"absmax_in_{_r}_launches", 0)
w8a8_absmax.launches = 0
w8a8_epilogue.launches = 0
w8a8_matmul_mma.launches = 0
w8a8_matmul_dp4a.launches = 0
