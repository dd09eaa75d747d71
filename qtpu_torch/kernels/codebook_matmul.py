"""K7: codebook matmul for POT/APOT W4 weights (csrc/codebook_matmul.cu).

`codebook_matmul(x, data, scales, codebook, meta)` computes
y = x @ (scales o codebook[codes]), meta = (4, group, K, N): codes int4 in
the W4 group-halves layout, scales bf16 [K/g, N], codebook f32 [<= 16].
It replaces pallas_codebook_matmul (qtpu/kernels/pallas_dequant_matmul.py:324);
a layer of a stacked weight is its W[l] view. A CUDA tensor launches the
kernel; a CPU tensor takes `codebook_matmul_plain`, the math of qtpu's XLA
reference `_codebook_matmul_ref` (gather the levels, times the f32 scale,
rounded to the activation dtype, then matmul). The kernel rounds the level
to bf16 on the tensor cores (M > 8) or keeps level * scale in f32 (M <= 8)
instead, a known source of small differences (PERF.md gives them).
The body a launch runs is `cb_route`, K1's rule (`dq_route`) at 4 bits;
`codebook_matmul.wgmma_launches` and `.mma_launches` count the launches of
the Hopper route (csrc/dq_wgmma.cuh) and the mma.sync body. At M <= 8 K1's
`gemv_route` picks the tensor-core GEMV (csrc/dq_gemv_tc.cuh, its codebook
mode: the level rounded to bf16, as on the Hopper route;
`.gemv_tc_launches`) or dq_core's GEMV (`.gemv_launches`);
`codebook_matmul_simt` runs dq_core's GEMV whatever the rule says, the
earlier body for chip_smoke.py's "was" times.
"""

from __future__ import annotations

import torch

from qtpu_torch.core.packing import unpack_int4
from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require
from qtpu_torch.kernels.dequant_matmul import (count_gemv, dq_route, gemv_route, gemv_tc_split,
                                               split_k)

_SIG = {"qtpu_cb_matmul": [P, P, P, P, P, P, I, I, I, I, I, I, P]}
MAX_LEVELS = 16


def cb_route(M: int, N: int, group: int, ptrs) -> str:
    """The body qtpu_cb_matmul runs: K1's rule (`dq_route`) at 4 bits, ptrs
    the pointers of the codes and the scales."""
    return dq_route(M, N, 4, group, ptrs)


def codebook_weight(data, scales, codebook, meta, dtype):
    """The dense [K, N] weight scales o codebook[codes], rounded to dtype."""
    _, group, K, N = meta
    codes = unpack_int4(data, group).long()
    w = codebook.float()[codes].reshape(K // group, group, N)
    w = w * scales.float().reshape(K // group, 1, N)
    return w.reshape(K, N).to(dtype)


def codebook_matmul_plain(x, data, scales, codebook, meta):
    return x @ codebook_weight(data, scales, codebook, meta, x.dtype)


def _launch(x, data, scales, codebook, meta, simt: bool):
    """One launch of csrc/codebook_matmul.cu on card tensors; returns (out,
    the body it ran). simt: dq_core's GEMV at M <= 8 whatever gemv_route says."""
    bits, group, K, N = meta
    require(x.is_cuda, f"unsupported device {x.device}")
    require(bits == 4, f"codebook sites hold 4-bit codes, got bits={bits}")
    require(group > 0 and group % 4 == 0 and K % group == 0,
            f"group {group} must be a multiple of 4 dividing K={K}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(x.shape[-1] == K and x.is_contiguous(), "x must be contiguous [..., K]")
    require(data.dtype == torch.int8 and tuple(data.shape) == (K // 2, N),
            f"data must be int8 [{K // 2}, {N}], got {data.dtype} {tuple(data.shape)}")
    require(scales.dtype == torch.bfloat16 and tuple(scales.shape) == (K // group, N),
            "scales must be bf16 [K/group, N]")
    require(codebook.dtype == torch.float32 and codebook.dim() == 1
            and 0 < codebook.numel() <= MAX_LEVELS, "codebook must be f32 [<= 16]")
    for t in (data, scales, codebook):
        require(t.device == x.device, f"weights on {t.device}, activations on {x.device}")
        require(t.is_contiguous(), "packed weights must be contiguous")
    require(N % 4 or (data.data_ptr() % 8 == 0 and scales.data_ptr() % 8 == 0),
            "packed weights must be 8-byte aligned")  # a ragged N is read byte by byte
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out, None
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    lut = codebook
    if codebook.numel() < MAX_LEVELS:  # codes index at most the table's levels
        lut = torch.zeros(MAX_LEVELS, dtype=torch.float32, device=x.device)
        lut[: codebook.numel()] = codebook
    ptrs = (data.data_ptr(), scales.data_ptr())
    route = cb_route(M, N, group, ptrs)
    if route == "gemv" and not simt:
        route = gemv_route(M, K, N, 4, group, ptrs)
    cluster = 0
    if route == "gemv_tc":  # one launch, K split over a thread-block cluster
        cluster, per = gemv_tc_split(x.device, K, N, group)
        part = None
    elif M <= 8:  # dq_core's GEMV, split over K
        per, part = split_k(x.device, M, K, N, group)
    else:  # a tensor-core body over all of K
        per, part = K // group, None
    lib = _build.load("codebook_matmul", _SIG)
    rc = lib.qtpu_cb_matmul(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(), lut.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), per, cluster, M, K, N, group,
        _build.stream_of(x),
    )
    _build.check(rc, "codebook_matmul")
    return out, route


def codebook_matmul(x, data, scales, codebook, meta):
    """y = x @ (scales o codebook[codes]); x [..., K] -> [..., N]."""
    if x.device.type == "cpu":
        return codebook_matmul_plain(x, data, scales, codebook, meta)
    out, route = _launch(x, data, scales, codebook, meta, simt=False)
    if route is not None:
        codebook_matmul.launches += 1
        count_gemv(codebook_matmul, route)
    return out


def codebook_matmul_simt(x, data, scales, codebook, meta):
    """codebook_matmul with dq_core's SIMT GEMV at M <= 8 whatever gemv_route
    says: the earlier body on the same bytes, for chip_smoke.py's "was"
    times. Card tensors only; counted in its own `.launches`."""
    out, _ = _launch(x, data, scales, codebook, meta, simt=True)
    codebook_matmul_simt.launches += 1
    return out


codebook_matmul.launches = 0
codebook_matmul.wgmma_launches = 0
codebook_matmul.mma_launches = 0
codebook_matmul.gemv_tc_launches = 0
codebook_matmul.gemv_launches = 0
codebook_matmul_simt.launches = 0
