"""K9 and K10: the packed expert matmuls of a sparse-MoE layer
(csrc/moe_matmul.cu).

`moe_matmul` replaces pallas_moe_quantized_matmul
(qtpu/kernels/pallas_moe_matmul.py:40): every expert of one layer's packed
site in one launch, x [M, K] (shared) or [E, M, K] (per_expert_input) ->
[E, M, N]. `moe_gathered_matmul` replaces pallas_moe_gathered_matmul (:165):
one routed slot per row, x [Gs, K] with the int32 expert index of each row
[Gs] -> [Gs, N], the index read by the kernel from device memory, so a decode
step never waits on the host. The weights are one layer's view [E, Kp, N] of
the stacked [L, E, ...] leaf (`W[l]`, zero-copy), with scales and zeros
[E, K/g, N], meta = (bits, group, K, N).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version:
K1's plain `quantized_matmul_plain` (qtpu's XLA reference: dequantize to the
activation dtype, then matmul) per expert, stacked, as qtpu's per-expert loop
(qtpu/models/moe.py:193-200) computes it, and per slot for the gathered form.
The kernels apply scale and zero in f32, as K1 does.

Which body K9 launches is `moe_route`, the kernel's own rule: the GEMV
(M <= 8), the Hopper route of K1 with an expert axis (wgmma fed by TMA,
csrc/dq_wgmma.cuh) or the mma.sync body per expert for the other M > 8
calls. `moe_matmul.wgmma_launches` and `.mma_launches` count the launches of
those two (all are in `.launches`). `moe_matmul_mma` runs the mma.sync body
on any M > 8 call: the route's earlier body, kept so that chip_smoke.py can
time both on the same bytes (K1's and K9's "was" times); no serving or eval
path calls it. At M <= 8 K1's `gemv_route` picks the tensor-core GEMV with
an expert axis (csrc/dq_gemv_tc.cuh, one launch over every expert's column
strips and K slices; `moe_matmul.gemv_tc_launches`) or dq_core's GEMV
(`.gemv_launches`); `moe_matmul_simt` runs dq_core's GEMV whatever the rule
says, the earlier body for the "was" times.

K10's body is `gathered_route`, its kernel's rule: at W4/W8, group 64 or
128, N % 16 == 0 and 16-byte aligned tensors the tensor-core GEMV's block
body with one weight stream per distinct routed expert (the slots of one
expert, at most 8 a block, become the columns of the mma's B operand; K
split over a thread-block cluster sized by `gemv_tc_split` with the upper
bound ceil(N / 128) x Gs strips, since the host does not know how many
experts are distinct), counted in `moe_gathered_matmul.gemv_tc_launches`;
else dq_core's GEMV, one slot a row tile (`.gemv_launches`).
`moe_gathered_matmul_simt` runs dq_core's GEMV on any call, for the "was"
times; no model path calls it.
"""

from __future__ import annotations

import torch

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require
from qtpu_torch.kernels.dequant_matmul import (GEMV_TC_COLS, check_packed, count_gemv,
                                               dq_route, gemv_route, gemv_tc_split,
                                               quantized_matmul_plain, split_k)

_SIG = {
    "qtpu_moe_grouped": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "qtpu_moe_grouped_mma": [P, P, P, P, P, I, I, I, I, I, I, I, P],
    "qtpu_moe_gathered": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
}
GATHERED_MAX_SLOTS = 65535  # the grid's y extent: one block row a slot


def moe_route(M: int, K: int, N: int, bits: int, group: int, ptrs,
              per_expert_input: bool = False) -> str:
    """The body qtpu_moe_grouped runs for E experts' [M, K] x [K, N] calls
    of a contiguous [E, ...] leaf, x 16-byte aligned as the wrapper
    requires; ptrs: the first expert's codes, scales (and zeros if any).
    K1's rule on the first expert's view (dq_route), and the Hopper route
    only where every stride between two experts is a multiple of 16 bytes:
    x's (per_expert_input), the codes', scales', zeros' and output's
    (csrc/moe_matmul.cu: moe_wgmma_fits). At M <= 8 the GEMV ("gemv"),
    which `gemv_route` refines (every stride between experts is then 16-byte
    aligned: N % 16 == 0 and whole groups)."""
    route = dq_route(M, N, bits, group, ptrs)
    if route != "wgmma":
        return route
    strides = ((M * K * 2 if per_expert_input else 0), K * bits // 8 * N, K // group * N * 2,
               K // group * N, M * N * 2)
    return "wgmma" if all(s % 16 == 0 for s in strides) else "mma"


def gathered_route(Gs: int, K: int, N: int, bits: int, group: int, ptrs) -> str:
    """The body qtpu_moe_gathered runs for Gs routed slots of [1, K] x
    [K, N] over a contiguous [E, ...] leaf, x 16-byte aligned as the wrapper
    requires; ptrs: the first expert's codes, scales (and zeros if any).
    "gemv_tc" (csrc/moe_matmul.cu: gathered_tc_fits): K1's gemv_route on one
    slot's view, at most GATHERED_MAX_SLOTS slots and every stride between
    two experts (codes, scales, zeros) a multiple of 16 bytes; else "gemv",
    dq_core's GEMV (W2, other groups, ragged N, unaligned tensors)."""
    strides = (K * bits // 8 * N, K // group * N * 2, K // group * N)
    ok = (0 < Gs <= GATHERED_MAX_SLOTS and gemv_route(1, K, N, bits, group, ptrs) == "gemv_tc"
          and all(s % 16 == 0 for s in strides))
    return "gemv_tc" if ok else "gemv"


def _expert(t, e):
    return None if t is None else t[e]


def moe_matmul_plain(x, data, scales, zeros, meta, per_expert_input=False):
    return torch.stack([
        quantized_matmul_plain(x[e] if per_expert_input else x, data[e], scales[e],
                               _expert(zeros, e), meta)
        for e in range(data.shape[0])
    ])


def moe_gathered_matmul_plain(x, expert_idx, data, scales, zeros, meta):
    return torch.cat([
        quantized_matmul_plain(x[i:i + 1], data[e], scales[e], _expert(zeros, e), meta)
        for i, e in enumerate(expert_idx.tolist())
    ])


def _check_grouped(x, data, scales, zeros, meta, per_expert_input):
    """The wrapper's checks of a K9 card call; returns (E, M)."""
    require(x.is_cuda, f"unsupported device {x.device}")
    K = meta[2]
    E = data.shape[0]
    require(x.dtype == torch.bfloat16 and x.is_contiguous(), "x must be contiguous bf16")
    require(x.dim() == (3 if per_expert_input else 2) and x.shape[-1] == K
            and (not per_expert_input or x.shape[0] == E),
            f"x must be [{'E, ' if per_expert_input else ''}M, {K}], got {tuple(x.shape)}")
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    _check_experts(data, scales, zeros, meta, x.device)
    return E, x.shape[-2]


def _check_experts(data, scales, zeros, meta, device):
    """K1's checks on one expert, and the [E, ...] leaves contiguous."""
    check_packed(data[0], scales[0], _expert(zeros, 0), meta, device)
    E = data.shape[0]
    for t in (data, scales, zeros):
        if t is not None:
            require(t.dim() == 3 and t.shape[0] == E and t.is_contiguous(),
                    "expert weights must be contiguous [E, ...]")


def _grouped(x, data, scales, zeros, meta, per_expert_input, simt: bool):
    """One launch of K9 on card tensors; returns (out, the body it ran).
    simt: dq_core's GEMV at M <= 8 whatever gemv_route says."""
    bits, group, K, N = meta
    E, M = _check_grouped(x, data, scales, zeros, meta, per_expert_input)
    out = torch.empty(E, M, N, dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out, None
    ptrs = [t.data_ptr() for t in (data, scales, zeros) if t is not None]
    route = moe_route(M, K, N, bits, group, ptrs, per_expert_input)
    if route == "gemv" and not simt:
        route = gemv_route(M, K, N, bits, group, ptrs)
    cluster = 0
    if route == "gemv_tc":  # one launch over every expert's strips, K over a cluster
        cluster, per = gemv_tc_split(x.device, K, N, group, tiles=-(-N // GEMV_TC_COLS) * E)
        part = None
    elif M <= 8:  # dq_core's GEMV, split over K across all experts' tiles
        per, part = split_k(x.device, M, K, N * E, group)
    else:  # the tensor cores over all of K
        per, part = K // group, None
    lib = _build.load("moe_matmul", _SIG)
    rc = lib.qtpu_moe_grouped(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), per, cluster, int(per_expert_input),
        E, M, K, N, bits, group, _build.stream_of(x),
    )
    _build.check(rc, "moe_matmul")
    return out, route


def moe_matmul(x, data, scales, zeros, meta, per_expert_input=False):
    """out[e] = x @ dequant(W[e]) (x[e] with per_expert_input) for every
    expert of data [E, Kp, N]. Returns [E, M, N] bf16."""
    if x.device.type == "cpu":
        return moe_matmul_plain(x, data, scales, zeros, meta, per_expert_input)
    out, route = _grouped(x, data, scales, zeros, meta, per_expert_input, simt=False)
    if route is not None:
        moe_matmul.launches += 1
        count_gemv(moe_matmul, route)
    return out


def moe_matmul_simt(x, data, scales, zeros, meta, per_expert_input=False):
    """moe_matmul with dq_core's SIMT GEMV at M <= 8 whatever gemv_route
    says: the tensor-core GEMV's earlier body on the same bytes, for
    chip_smoke.py's "was" times. Card tensors only; counted in its own
    `.launches`."""
    out, _ = _grouped(x, data, scales, zeros, meta, per_expert_input, simt=True)
    moe_matmul_simt.launches += 1
    return out


def moe_matmul_mma(x, data, scales, zeros, meta, per_expert_input=False):
    """moe_matmul on the mma.sync body at M > 8 whatever moe_route says:
    the Hopper route's earlier body on the same bytes, for chip_smoke.py's
    "was" times of K1 and K9. Card tensors only; counted in its own
    `.launches`."""
    bits, group, K, N = meta
    E, M = _check_grouped(x, data, scales, zeros, meta, per_expert_input)
    require(M > 8 and (group * bits // 8) % 16 == 0,
            f"the mma.sync body takes M > 8 and groups of 16k packed rows: M={M}, meta {meta}")
    out = torch.empty(E, M, N, dtype=torch.bfloat16, device=x.device)
    lib = _build.load("moe_matmul", _SIG)
    rc = lib.qtpu_moe_grouped_mma(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), out.data_ptr(), int(per_expert_input),
        E, M, K, N, bits, group, _build.stream_of(x),
    )
    _build.check(rc, "moe_matmul_mma")
    moe_matmul_mma.launches += 1
    return out


def _gathered(x, expert_idx, data, scales, zeros, meta, simt: bool):
    """One launch of K10 on card tensors; returns (out, the body it ran, None
    for Gs = 0). simt: dq_core's GEMV whatever gathered_route says."""
    require(x.is_cuda, f"unsupported device {x.device}")
    bits, group, K, N = meta
    require(x.dtype == torch.bfloat16 and x.dim() == 2 and x.shape[1] == K
            and x.is_contiguous(), f"x must be contiguous bf16 [Gs, {K}]")
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    Gs = x.shape[0]
    require(expert_idx.dtype == torch.int32 and tuple(expert_idx.shape) == (Gs,)
            and expert_idx.device == x.device and expert_idx.is_contiguous(),
            f"expert_idx must be contiguous int32 [{Gs}] on {x.device}")
    _check_experts(data, scales, zeros, meta, x.device)
    out = torch.empty(Gs, N, dtype=torch.bfloat16, device=x.device)
    if Gs == 0:
        return out, None
    ptrs = [t.data_ptr() for t in (data, scales, zeros) if t is not None]
    route = "gemv" if simt else gathered_route(Gs, K, N, bits, group, ptrs)
    if route == "gemv_tc":  # one launch, K over a cluster; the strips of Gs slots bound the tiles
        cluster, per = gemv_tc_split(x.device, K, N, group, tiles=-(-N // GEMV_TC_COLS) * Gs)
        part = None
    else:  # dq_core's GEMV, one slot a row tile
        cluster = 0
        per, part = split_k(x.device, Gs, K, N, group, tiles=-(-N // 32) * Gs)
    lib = _build.load("moe_matmul", _SIG)
    rc = lib.qtpu_moe_gathered(
        x.data_ptr(), expert_idx.data_ptr(), data.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), per, cluster,
        data.shape[0], Gs, K, N, bits, group, _build.stream_of(x),
    )
    _build.check(rc, "moe_gathered_matmul")
    return out, route


def moe_gathered_matmul(x, expert_idx, data, scales, zeros, meta):
    """out[i] = x[i] @ dequant(W[expert_idx[i]]) for each slot i of x [Gs, K];
    expert_idx [Gs] int32 on x's device; rows whose index lies outside
    [0, E) hold no result. Returns [Gs, N] bf16."""
    if x.device.type == "cpu":
        return moe_gathered_matmul_plain(x, expert_idx, data, scales, zeros, meta)
    out, route = _gathered(x, expert_idx, data, scales, zeros, meta, simt=False)
    if route is not None:
        moe_gathered_matmul.launches += 1
        count_gemv(moe_gathered_matmul, route)
    return out


def moe_gathered_matmul_simt(x, expert_idx, data, scales, zeros, meta):
    """moe_gathered_matmul on dq_core's SIMT GEMV (one slot a row tile, a
    repeated expert streamed once per slot) whatever gathered_route says: the
    earlier body on the same bytes, for chip_smoke.py's "was" times. Card
    tensors only; counted in its own `.launches`."""
    out, _ = _gathered(x, expert_idx, data, scales, zeros, meta, simt=True)
    moe_gathered_matmul_simt.launches += 1
    return out


moe_matmul.launches = 0
moe_matmul.wgmma_launches = 0
moe_matmul.mma_launches = 0
moe_matmul.gemv_tc_launches = 0
moe_matmul.gemv_launches = 0
moe_matmul_mma.launches = 0
moe_matmul_simt.launches = 0
moe_gathered_matmul.launches = 0
moe_gathered_matmul.gemv_tc_launches = 0
moe_gathered_matmul.gemv_launches = 0
moe_gathered_matmul_simt.launches = 0
