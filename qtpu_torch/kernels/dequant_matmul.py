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
before the one cast. They take decode shapes (at most 32 rows, N % 4 == 0);
their plain version is qtpu's XLA composition (norm in f32, cast, matmul,
then `resid + y`). `quantized_matmul.norm_launches` and `.resid_launches`
count the launches with each option (all are in `.launches`).

Which body a launch runs is `dq_route`, the kernel's own rule on the shape
and the weight's alignment: the GEMV (M <= 8), the Hopper route (wgmma fed
by TMA, csrc/dq_wgmma.cuh) or the mma.sync body (csrc/dq_mma.cuh) for the
M > 8 calls the Hopper route does not take. `quantized_matmul.wgmma_launches`
and `.mma_launches` count the launches of those two (all are in `.launches`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import F, I, P, require

_SIG = {"qtpu_dq_matmul": [P, P, P, P, P, P, I, I, I, I, I, I, P],
        "qtpu_dq_matmul_opt": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]}

OPTION_MAX_M = 32  # rows the options take (decode shapes: the GEMV kernel tiled by 8 rows)
WGMMA_GROUPS = (64, 128)  # one whole group a stage of the Hopper route
MMA_ROWS = 16  # packed rows a stage of the mma.sync body


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


def count_route(wrapper, route: str) -> None:
    """Adds one to the wrapper's counter of the route's launches."""
    if route == "wgmma":
        wrapper.wgmma_launches += 1
    elif route == "mma":
        wrapper.mma_launches += 1


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    """Whether the kernel takes norm_w / resid at this meta and row count."""
    return len(meta) == 4 and meta[3] % 4 == 0 and 0 < M <= OPTION_MAX_M


def quantized_matmul(x, data, scales, zeros, meta, norm_w=None, resid=None, eps=1e-5):
    """y = [resid +] [rms_norm(x) * norm_w ->] x @ dequant(data, scales,
    zeros); x [..., K] -> [..., N]; norm_w [K], resid [..., N]."""
    bits, group, K, N = meta
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, data, scales, zeros, meta, norm_w, resid, eps)
    require(x.is_cuda, f"unsupported device {x.device}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(x.shape[-1] == K and x.is_contiguous(), "x must be contiguous [..., K]")
    check_packed(data, scales, zeros, meta, x.device, ragged_n=norm_w is None and resid is None)
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    lib = _build.load("dequant_matmul", _SIG)
    if norm_w is None and resid is None:
        ptrs = [t.data_ptr() for t in (data, scales, zeros) if t is not None]
        route = dq_route(M, N, bits, group, ptrs)
        # M <= 8 runs the GEMV kernel, split over K; larger M a tensor-core one
        per, part = split_k(x.device, M, K, N, group) if M <= 8 else (K // group, None)
        rc = lib.qtpu_dq_matmul(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(),
            None if zeros is None else zeros.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), per,
            M, K, N, bits, group, _build.stream_of(x),
        )
    else:
        require(options_supported(meta, M),
                f"norm_w/resid take at most {OPTION_MAX_M} rows and N % 4 == 0: M={M}, N={N}")
        if norm_w is not None:
            require(norm_w.dtype == torch.bfloat16 and tuple(norm_w.shape) == (K,)
                    and norm_w.is_contiguous() and norm_w.device == x.device
                    and norm_w.data_ptr() % 8 == 0,
                    "norm_w must be contiguous 8-byte aligned bf16 [K]")
        if resid is not None:
            require(resid.dtype == torch.bfloat16 and resid.shape == out.shape
                    and resid.is_contiguous() and resid.device == x.device,
                    f"resid must be contiguous bf16 {tuple(out.shape)}")
        per, part = split_k(x.device, M, K, N, group)
        rc = lib.qtpu_dq_matmul_opt(
            x.data_ptr(), data.data_ptr(), scales.data_ptr(),
            None if zeros is None else zeros.data_ptr(),
            None if norm_w is None else norm_w.data_ptr(),
            None if resid is None else resid.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), per,
            M, K, N, bits, group, float(eps), _build.stream_of(x),
        )
    _build.check(rc, "dequant_matmul")
    quantized_matmul.launches += 1
    if norm_w is None and resid is None:
        count_route(quantized_matmul, route)
    if norm_w is not None:
        quantized_matmul.norm_launches += 1
    if resid is not None:
        quantized_matmul.resid_launches += 1
    return out


quantized_matmul.launches = 0
quantized_matmul.norm_launches = 0
quantized_matmul.resid_launches = 0
quantized_matmul.wgmma_launches = 0
quantized_matmul.mma_launches = 0
