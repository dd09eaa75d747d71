"""K1: fused dequantize + matmul for packed W2/W4/W8 weights.

`quantized_matmul` is the one entry point for the port's packed linears:
y = x @ dequant(data, scales, zeros), meta = (bits, group, K, N). A CUDA
tensor launches the kernel of csrc/dequant_matmul.cu (it replaces both
pallas_quantized_matmul_stacked and pallas_quantized_matmul: a layer of a
stacked weight is the zero-copy view W[l]); a CPU tensor takes
`quantized_matmul_plain`, the math of qtpu's XLA reference
`_quantized_matmul_ref` (dequantize to the activation dtype, then matmul).
The kernel applies scale and zero in f32 instead of rounding the weight to
bf16 first, a known source of small differences (PERF.md gives them). Any N
is taken: at N % 4 != 0 (GPT-2's 50257-wide lm_head), which qtpu's
dispatcher sends to XLA, the kernel masks the ragged column tail itself.

The options of pallas_quantized_matmul_stacked (qtpu's
`quantized_matmul_stacked(..., norm_w, resid, eps)`,
qtpu/kernels/dequant_matmul.py:69): `norm_w` [K], the layer's rms-norm row,
normalizes x inside the launch; `resid` [..., N] is added to the f32 sums
before the one cast. `options_supported` says from the shape which calls
take them, at any row count: at M <= 8 the GEMVs (N % 4 == 0), above it
the Hopper route (group 64 or 128, N % 16 == 0), where norm_w scales the
dequantized weight's K rows and the norm's row factor is applied in the
epilogue (bf16((q - z) * norm_w) where the plain version rounds
bf16(x * r * norm_w): within 2e-2 relative of it); a caller
composes where it says no (qtpu composes where its kernel cannot take the
call). Their plain version is qtpu's XLA composition (norm in f32, cast,
matmul, then `resid + y`). `quantized_matmul.norm_launches` and
`.resid_launches` count the launches with each option (all are in
`.launches`).

Which body a launch runs is `dq_route`, the kernel's own rule on the shape
and the weight's alignment: the GEMV (M <= 8), the Hopper route (wgmma fed
by TMA, csrc/dq_wgmma.cuh) or the mma.sync body (csrc/dq_mma.cuh) for the
M > 8 calls the Hopper route does not take. `quantized_matmul.wgmma_launches`
and `.mma_launches` count the launches of those two (all are in `.launches`).
At M <= 8 `gemv_route` picks between the tensor-core GEMV (mma.sync fed by a
cp.async ring, K split over a thread-block cluster by `gemv_split`,
csrc/dq_gemv_tc.cuh; `.gemv_tc_launches`) and dq_core's SIMT GEMV for the
calls it does not take (`.gemv_launches`); the options count there too.
`quantized_matmul_simt` runs dq_core's GEMV whatever `gemv_route` says: the
earlier body on the same bytes, for chip_smoke.py's "was" times; no serving
or eval path calls it.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import F, I, P, require

_SIG = {"qtpu_dq_matmul": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
        "qtpu_dq_matmul_opt": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P]}

WGMMA_GROUPS = (64, 128)  # one whole group a stage of the Hopper route
MMA_ROWS = 16  # packed rows a stage of the mma.sync body
# the tensor-core GEMV (csrc/dq_gemv_tc.cuh): its bits and groups, the
# output columns of a block, the K values of x a block may stage and the
# slice it aims at, the largest cluster
GEMV_TC_BITS = (4, 8)
GEMV_TC_GROUPS = (64, 128)
GEMV_TC_COLS = 128
GEMV_TC_X_CAP = 4096
GEMV_TC_X_WANT = 2048
GEMV_TC_CLUSTERS = tuple(range(1, 9))  # blocks a cluster (8: the portable most)


def dq_route(M: int, N: int, bits: int, group: int, ptrs) -> str:
    """The body qtpu_dq_matmul (and qtpu_cb_matmul, bits 4) runs for an
    [M, K] x [K, N] call without options, x 16-byte aligned as the wrappers
    require; ptrs: the pointers of the packed tensors (codes, scales and the
    zeros if any). "wgmma" (csrc/dq_wgmma.cuh's wgmma_fits: M > 8, group 64
    or 128, N % 16 == 0 so TMA and the bulk copies can stride the N-wide
    rows, every pointer 16-byte aligned), "mma" (csrc/dq_mma.cuh, the other
    M > 8 calls whose groups hold a multiple of 16 packed rows) or "gemv"
    (the rest)."""
    if M <= 8:
        return "gemv"
    if group in WGMMA_GROUPS and N % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma" if (group * bits // 8) % MMA_ROWS == 0 else "gemv"


def gemv_split(sms: int, tiles: int, groups: int, group: int, per_sm: int = 2):
    """How the tensor-core GEMV splits K: (cluster, groups a slice), the
    blocks of one column strip (a thread-block cluster of 1 to 8) each taking
    a slice of whole groups, every group in one slice and no slice empty,
    x's slice at most GEMV_TC_X_CAP K values. The smallest cluster of 1, 2, 4
    or 8 whose tiles x cluster blocks reach per_sm an SM with slices of at
    most GEMV_TC_X_WANT values (tools/exp_decode_gemv.py's sweep: more blocks
    or uneven slices cost more than they hide), else the largest cluster that
    fits; tiles: the column strips of all experts. None where none fits."""
    def fits(c):
        per = -(-groups // c)
        return per * (c - 1) < groups and per * group <= GEMV_TC_X_CAP, per

    for c in (1, 2, 4, 8):
        ok, per = fits(c)
        if ok and tiles * c >= per_sm * sms and per * group <= GEMV_TC_X_WANT:
            return c, per
    for c in reversed(GEMV_TC_CLUSTERS):
        ok, per = fits(c)
        if ok:
            return c, per
    return None


def gemv_route(M: int, K: int, N: int, bits: int, group: int, ptrs, ldw=None) -> str:
    """The GEMV a call of at most 8 rows runs (csrc/dq_gemv_tc.cuh's
    gemv_tc_fits; x 16-byte aligned as the wrappers require): "gemv_tc", the
    tensor-core GEMV, at W4 or W8, group 64 or 128, N and the row pitch ldw
    (N unless the weight holds two column sets) multiples of 16, every
    pointer in ptrs (codes, scales, zeros) 16-byte aligned and a split of K
    that gemv_split finds; else "gemv", dq_core's GEMV (W2, other groups,
    ragged N, unaligned tensors)."""
    ldw = N if ldw is None else ldw
    ok = (0 < M <= 8 and bits in GEMV_TC_BITS and group in GEMV_TC_GROUPS and N % 16 == 0
          and ldw % 16 == 0 and K % group == 0 and all(p % 16 == 0 for p in ptrs)
          and gemv_split(1, 1, K // group, group) is not None)
    return "gemv_tc" if ok else "gemv"


def count_route(wrapper, route: str) -> None:
    """Adds one to the wrapper's counter of the route's launches."""
    if route == "wgmma":
        wrapper.wgmma_launches += 1
    elif route == "mma":
        wrapper.mma_launches += 1


def count_gemv(wrapper, route: str) -> None:
    """count_route, and for K1, K7, K9 and K4 the GEMVs' counters too:
    `.gemv_tc_launches` (csrc/dq_gemv_tc.cuh) and `.gemv_launches` (dq_core)."""
    if route == "gemv_tc":
        wrapper.gemv_tc_launches += 1
    elif route == "gemv":
        wrapper.gemv_launches += 1
    else:
        count_route(wrapper, route)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_tc_split(device, K: int, N: int, group: int, tiles=None):
    """gemv_split on the device's SM count; tiles defaults to the call's
    column strips, ceil(N / 128)."""
    if tiles is None:
        tiles = -(-N // GEMV_TC_COLS)
    return gemv_split(_sm_count(device.index or 0), tiles, K // group, group)


def split_k(device, M: int, K: int, N: int, group: int, nset: int = 1, tiles=None):
    """How the GEMV kernel (8 rows x 32 columns per block, csrc/dq_core.cuh)
    splits K: slices of whole groups, at least 256 K values each, enough for
    about two blocks per SM. `tiles`: the blocks of one K slice when they are
    not ceil(N / 32) x ceil(M / 8). Returns (groups per slice, the f32 scratch
    of slices x nset x M x N partial sums, or None for one slice). The kernel
    takes the split as given."""
    groups = K // group
    if tiles is None:
        tiles = -(-N // 32) * -(-M // 8)
    want = -(-2 * _sm_count(device.index or 0) // tiles)
    per = -(-groups // max(1, min(groups, K // 256, want)))
    slices = -(-groups // per)
    part = (torch.empty(slices * nset * M * N, dtype=torch.float32, device=device)
            if slices > 1 else None)
    return per, part


def quantized_matmul_plain(x, data, scales, zeros, meta, norm_w=None, resid=None, eps=1e-5):
    bits, group, K, N = meta
    if norm_w is not None:  # qtpu/kernels/dequant_matmul.py:94-97
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        x = (xf * norm_w.float()).to(x.dtype)
    y = x @ dequantize_parts(data, scales, zeros, bits, group, x.dtype)
    return y if resid is None else resid + y


def check_packed(data, scales, zeros, meta, device, ragged_n: bool = False):
    """Shape, dtype, layout and device checks shared by K1, K4 and K9/K10;
    ragged_n: the kernel takes N % 4 != 0 (K1's)."""
    bits, group, K, N = meta
    require(bits in (2, 4, 8), f"bits must be 2, 4 or 8, got {bits}")
    require(group > 0 and group % 4 == 0 and K % group == 0,
            f"group {group} must be a multiple of 4 dividing K={K}")
    aligned = N % 4 == 0
    require(ragged_n or aligned, f"N={N} must be a multiple of 4")
    require(data.dtype == torch.int8 and tuple(data.shape) == (K * bits // 8, N),
            f"data must be int8 [{K * bits // 8}, {N}], got {data.dtype} {tuple(data.shape)}")
    require(scales.dtype == torch.bfloat16 and tuple(scales.shape) == (K // group, N),
            "scales must be bf16 [K/group, N]")
    parts = [data, scales]
    if zeros is not None:
        require(zeros.dtype == torch.uint8 and tuple(zeros.shape) == (K // group, N),
                "zeros must be uint8 [K/group, N]")
        parts.append(zeros)
    for t in parts:
        require(t.device == device, f"weights on {t.device}, activations on {device}")
        require(t.is_contiguous(), "packed weights must be contiguous")
        # rows of 4-column vector loads; a ragged N is read byte by byte
        require(not aligned or t.data_ptr() % 8 == 0, "packed weights must be 8-byte aligned")


def options_supported(meta, M: int) -> bool:
    """Whether the kernel takes norm_w / resid at this meta and row count:
    at M <= 8 the GEMVs (N % 4 == 0), above it the Hopper route (group 64
    or 128, N % 16 == 0; the tensors 16-byte aligned, as dq_route asks,
    which the launch checks). The mma.sync body takes no options."""
    if len(meta) != 4 or M <= 0:
        return False
    _, group, _, N = meta
    return N % 4 == 0 if M <= 8 else group in WGMMA_GROUPS and N % 16 == 0


def _launch(x, data, scales, zeros, meta, norm_w, resid, eps, simt: bool):
    """One launch of csrc/dequant_matmul.cu on card tensors; returns (out,
    the body it ran). simt: dq_core's GEMV at M <= 8 whatever gemv_route says."""
    bits, group, K, N = meta
    require(x.is_cuda, f"unsupported device {x.device}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(x.shape[-1] == K and x.is_contiguous(), "x must be contiguous [..., K]")
    check_packed(data, scales, zeros, meta, x.device, ragged_n=norm_w is None and resid is None)
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out, None
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    lib = _build.load("dequant_matmul", _SIG)
    ptrs = [t.data_ptr() for t in (data, scales, zeros) if t is not None]
    route = dq_route(M, N, bits, group, ptrs)
    if norm_w is not None or resid is not None:
        require(options_supported(meta, M),
                f"norm_w/resid take N % 4 == 0 at M <= 8, group 64 or 128 and N % 16 == 0 "
                f"above: M={M}, group={group}, N={N}")
        require(M <= 8 or route == "wgmma",
                "norm_w/resid at M > 8 take 16-byte aligned packed tensors (the Hopper route)")
        if norm_w is not None:
            require(norm_w.dtype == torch.bfloat16 and tuple(norm_w.shape) == (K,)
                    and norm_w.is_contiguous() and norm_w.device == x.device
                    and norm_w.data_ptr() % 8 == 0,
                    "norm_w must be contiguous 8-byte aligned bf16 [K]")
        if resid is not None:
            require(resid.dtype == torch.bfloat16 and resid.shape == out.shape
                    and resid.is_contiguous() and resid.device == x.device
                    and resid.data_ptr() % 4 == 0,
                    f"resid must be contiguous 4-byte aligned bf16 {tuple(out.shape)}")
    if route == "gemv" and not simt:
        route = gemv_route(M, K, N, bits, group, ptrs)
    cluster = 0
    if route == "gemv_tc":
        # one launch: K split over a thread-block cluster
        cluster, per = gemv_tc_split(x.device, K, N, group)
        part = None
    elif M <= 8:
        # dq_core's GEMV, split over K (with a second launch adding the splits)
        per, part = split_k(x.device, M, K, N, group)
    else:
        per, part = K // group, None  # a tensor-core body over all of K
    common = (None if zeros is None else zeros.data_ptr(),)
    if norm_w is None and resid is None:
        rc = lib.qtpu_dq_matmul(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(), *common, out.data_ptr(),
            None if part is None else part.data_ptr(), per, cluster,
            M, K, N, bits, group, _build.stream_of(x),
        )
    else:
        rc = lib.qtpu_dq_matmul_opt(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(), *common,
            None if norm_w is None else norm_w.data_ptr(),
            None if resid is None else resid.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), per, cluster,
            M, K, N, bits, group, float(eps), _build.stream_of(x),
        )
    _build.check(rc, "dequant_matmul")
    return out, route


def quantized_matmul(x, data, scales, zeros, meta, norm_w=None, resid=None, eps=1e-5):
    """y = [resid +] [rms_norm(x) * norm_w ->] x @ dequant(data, scales,
    zeros); x [..., K] -> [..., N]; norm_w [K], resid [..., N]."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, data, scales, zeros, meta, norm_w, resid, eps)
    out, route = _launch(x, data, scales, zeros, meta, norm_w, resid, eps, simt=False)
    if route is None:
        return out
    quantized_matmul.launches += 1
    count_gemv(quantized_matmul, route)
    if norm_w is not None:
        quantized_matmul.norm_launches += 1
    if resid is not None:
        quantized_matmul.resid_launches += 1
    return out


def quantized_matmul_simt(x, data, scales, zeros, meta, norm_w=None, resid=None, eps=1e-5):
    """quantized_matmul with dq_core's SIMT GEMV at M <= 8 whatever
    gemv_route says: the tensor-core GEMV's earlier body on the same bytes,
    for chip_smoke.py's "was" times. Card tensors only; counted in its own
    `.launches`."""
    out, _ = _launch(x, data, scales, zeros, meta, norm_w, resid, eps, simt=True)
    quantized_matmul_simt.launches += 1
    return out


quantized_matmul.launches = 0
quantized_matmul.norm_launches = 0
quantized_matmul.resid_launches = 0
quantized_matmul.wgmma_launches = 0
quantized_matmul.mma_launches = 0
quantized_matmul.gemv_tc_launches = 0
quantized_matmul.gemv_launches = 0
quantized_matmul_simt.launches = 0
