"""K4: one call for a whole packed SwiGLU MLP block (csrc/fused_mlp.cu).

y = x + (silu(h @ Wg) * (h @ Wu)) @ Wd, h = rms_norm(x) * norm_w, with gate
and up taken from the fused gateup site ([Kp, 2F], columns [gate | up]);
with resid=False the no-residual mode, y = (silu(h @ Wg) * (h @ Wu)) @ Wd
(a tensor-parallel rank other than the group's first, whose partial sum is
all-reduced with the residual added once).
Replaces pallas_fused_mlp_stacked and pallas_fused_mlp
(qtpu/kernels/pallas_fused_mlp.py:221, :111): a layer of the stacked
weights is passed as its W[l] view. A CUDA tensor runs the kernel's two
phases under one call (one launch in the count); a CPU tensor takes the
plain version, qtpu's composed `_mlp_block` math. `mlp_route` names the
body: "gemv_tc" where K1's `gemv_route` takes both phases (the tensor-core
GEMV of csrc/dq_gemv_tc.cuh, one launch a phase, K split over a
thread-block cluster; `fused_mlp.gemv_tc_launches`), else "gemv" (dq_core's
GEMV, `.gemv_launches`); `fused_mlp_simt` runs dq_core's GEMV whatever the
rule says, the earlier body for chip_smoke.py's "was" times.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import F, I, P, require
from qtpu_torch.kernels.dequant_matmul import (check_packed, count_gemv, gemv_route,
                                               gemv_tc_split, quantized_matmul_plain, split_k)
from qtpu_torch.models.ops import rms_norm

_SIG = {"qtpu_fused_mlp": [P, P, P, P, P, P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, I, I, F,
                           P]}

MAX_M = 32


def chains(meta_gu, meta_d) -> bool:
    """Whether a gateup meta (bits, g, K, 2F) and a down meta (bits, g, F, K)
    form one MLP that K4 takes (W4 or W8)."""
    if len(meta_gu) != 4 or len(meta_d) != 4:
        return False
    bits, group, K, N2 = meta_gu
    bits_d, group_d, F_, D = meta_d
    return (
        bits == bits_d and group == group_d and N2 == 2 * F_ and D == K
        and bits in (4, 8) and group > 0 and K % group == 0 and F_ % group == 0
    )


def supported(meta_gu, meta_d, gu, dn) -> bool:
    """Whether K4 takes this pair of packed sites (asymmetric W4/W8 with
    chained metas); other packings run the composed path on K1."""
    keys = {"data", "scales", "zeros"}
    return (
        meta_gu is not None and meta_d is not None and chains(meta_gu, meta_d)
        and isinstance(gu, dict) and set(gu.keys()) == keys
        and isinstance(dn, dict) and set(dn.keys()) == keys
    )


def fused_mlp_plain(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
                    meta_gu, meta_d, eps=1e-5, resid=True):
    F_ = meta_d[2]
    h = rms_norm(x, norm_w, eps)
    gu = quantized_matmul_plain(h, gu_data, gu_scales, gu_zeros, meta_gu)
    gate, up = gu[..., :F_], gu[..., F_:]
    act = Fn.silu(gate.float()).to(x.dtype) * up
    y = quantized_matmul_plain(act, d_data, d_scales, d_zeros, meta_d)
    return x + y if resid else y


def mlp_route(M: int, meta_gu, meta_d, gu_ptrs, d_ptrs) -> str:
    """The body of both phases: "gemv_tc" where gemv_route takes phase A (the
    gate and up column sets of F columns each, row pitch 2F) and phase B
    (the down site), else "gemv". ptrs: each site's codes, scales, zeros."""
    bits, group, K, _ = meta_gu
    F_ = meta_d[2]
    a = gemv_route(M, K, F_, bits, group, gu_ptrs, ldw=2 * F_)
    b = gemv_route(M, F_, K, bits, group, d_ptrs)
    return "gemv_tc" if a == b == "gemv_tc" else "gemv"


def fused_mlp(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
              meta_gu, meta_d, eps=1e-5, resid=True):
    """x [..., K] bf16 with at most 32 rows -> x + MLP(x) (MLP(x) with
    resid=False), same shape."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, norm_w, gu_data, gu_scales, gu_zeros,
                               d_data, d_scales, d_zeros, meta_gu, meta_d, eps, resid)
    out, route = _launch(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
                         meta_gu, meta_d, eps, simt=False, resid=resid)
    fused_mlp.launches += 1
    count_gemv(fused_mlp, route)
    return out


def fused_mlp_simt(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
                   meta_gu, meta_d, eps=1e-5):
    """fused_mlp on dq_core's SIMT GEMV whatever mlp_route says: the earlier
    body on the same bytes, for chip_smoke.py's "was" times. Card tensors
    only; counted in its own `.launches`."""
    out, _ = _launch(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
                     meta_gu, meta_d, eps, simt=True, resid=True)
    fused_mlp_simt.launches += 1
    return out


def _launch(x, norm_w, gu_data, gu_scales, gu_zeros, d_data, d_scales, d_zeros,
            meta_gu, meta_d, eps, simt: bool, resid: bool):
    """K4's two phases on card tensors; returns (out, the body they ran)."""
    require(x.is_cuda, f"unsupported device {x.device}")
    bits, group, K, _ = meta_gu
    F_ = meta_d[2]
    require(chains(meta_gu, meta_d) and gu_zeros is not None and d_zeros is not None,
            f"fused mlp takes chained asymmetric W4/W8 metas, got {meta_gu}, {meta_d}")
    require(x.dtype == torch.bfloat16 and x.shape[-1] == K and x.is_contiguous(),
            "x must be contiguous bf16 [..., K]")
    M = x.numel() // K
    require(0 < M <= MAX_M, f"fused mlp is decode-only: M={M} > {MAX_M}")
    require(norm_w.dtype == torch.bfloat16 and tuple(norm_w.shape) == (K,)
            and norm_w.is_contiguous() and norm_w.device == x.device,
            "norm_w must be contiguous bf16 [K]")
    check_packed(gu_data, gu_scales, gu_zeros, meta_gu, x.device)
    check_packed(d_data, d_scales, d_zeros, meta_d, x.device)
    require(x.data_ptr() % 8 == 0 and norm_w.data_ptr() % 8 == 0,
            "x and norm_w must be 8-byte aligned")
    dev = x.device
    act = torch.empty(M, F_, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    route = "gemv" if simt else mlp_route(
        M, meta_gu, meta_d, [t.data_ptr() for t in (gu_data, gu_scales, gu_zeros)],
        [t.data_ptr() for t in (d_data, d_scales, d_zeros)])
    if route == "gemv_tc":  # one launch a phase, K split over a thread-block cluster
        cl_a, per_a = gemv_tc_split(dev, K, F_, group)
        cl_b, per_b = gemv_tc_split(dev, F_, K, group)
        part_a = part_b = None
    else:  # dq_core's GEMV, split over K (a second launch adding the splits)
        cl_a = cl_b = 0
        per_a, part_a = split_k(dev, M, K, F_, group, nset=2)
        per_b, part_b = split_k(dev, M, F_, K, group)
    lib = _build.load("fused_mlp", _SIG)
    rc = lib.qtpu_fused_mlp(
        x.data_ptr(), norm_w.data_ptr(),
        gu_data.data_ptr(), gu_scales.data_ptr(), gu_zeros.data_ptr(),
        d_data.data_ptr(), d_scales.data_ptr(), d_zeros.data_ptr(),
        act.data_ptr(), out.data_ptr(),
        None if part_a is None else part_a.data_ptr(), per_a,
        None if part_b is None else part_b.data_ptr(), per_b, cl_a, cl_b,
        M, K, F_, bits, group, int(resid), float(eps), _build.stream_of(x),
    )
    _build.check(rc, "fused_mlp")
    return out, route


fused_mlp.launches = 0
fused_mlp.gemv_tc_launches = 0
fused_mlp.gemv_launches = 0
fused_mlp_simt.launches = 0
