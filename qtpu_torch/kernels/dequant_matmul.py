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
"""

from __future__ import annotations

from functools import lru_cache

import torch

from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require

_SIG = {"qtpu_dq_matmul": [P, P, P, P, P, P, I, I, I, I, I, I, P]}


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


def quantized_matmul_plain(x, data, scales, zeros, meta):
    bits, group, K, N = meta
    w = dequantize_parts(data, scales, zeros, bits, group, x.dtype)
    return x @ w


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


def quantized_matmul(x, data, scales, zeros, meta):
    """y = x @ dequant(data, scales, zeros); x [..., K] -> [..., N]."""
    bits, group, K, N = meta
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, data, scales, zeros, meta)
    require(x.is_cuda, f"unsupported device {x.device}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(x.shape[-1] == K and x.is_contiguous(), "x must be contiguous [..., K]")
    check_packed(data, scales, zeros, meta, x.device, ragged_n=True)
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    # M <= 8 runs the GEMV kernel, split over K; larger M the tensor-core one
    per, part = split_k(x.device, M, K, N, group) if M <= 8 else (K // group, None)
    lib = _build.load("dequant_matmul", _SIG)
    rc = lib.qtpu_dq_matmul(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), per,
        M, K, N, bits, group, _build.stream_of(x),
    )
    _build.check(rc, "dequant_matmul")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
