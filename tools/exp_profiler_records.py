#!/usr/bin/env python3
"""How often a torch.profiler session on the card comes back without the
kernel records of launches that happened, and for which launches.

Late in a long run of tests/test_torch_gpu.py, profiler-counted tests saw 1-3
of their 4 kernel records in every retry while the wrappers' counters showed
the launches. This runs SESSIONS sessions of 4 calls each of:

  k6_gemv_tc   K6 at decode (M 8, 2048 x 2048): one cluster launch
               (cudaLaunchKernelEx with a cluster dimension)
  k10_gemv_tc  K10 at 4 routed slots (Mixtral-width expert, K 4096): a
               cluster launch
  k1_gemv_tc   K1's decode GEMV (M 8, TinyLlama's qkv): a cluster launch
  k1_wgmma     K1 at M 1024 on the Hopper route: a plain launch
  torch_mm     a bf16 torch.mm (cuBLAS)

and counts, per call kind and per block of sessions, the sessions whose
kernel records number fewer than 4, and what else they held. Then the same
4 calls captured into a CUDA graph, whose kernel nodes (cudaGraphDebugDotPrint)
count the launches without the profiler.

    python3 tools/exp_profiler_records.py [SESSIONS]   # on a machine with an H100

One JSON line per call kind and a summary, with nvidia-smi's name and power
limit; the graphs' DOT files go to build/exp/. Imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DUMPS = ROOT / "build" / "exp"  # the DOT files of the captured graphs
sys.path.insert(0, str(ROOT))


def calls(torch):
    from qtpu_torch.core.packing import quantize_pack
    from qtpu_torch.kernels import dequant_matmul as k1
    from qtpu_torch.kernels import int8_matmul as k6
    from qtpu_torch.kernels import moe_matmul as k9

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    w8 = quantize_pack(torch.randn(2048, 2048, generator=g, device=dev) * 0.05, 8, 2048)
    x8 = torch.randn(8, 2048, generator=g, device=dev).to(torch.bfloat16)
    parts = [quantize_pack(torch.randn(4096, 1024, generator=g, device=dev) * 0.02, 4, 128)
             for _ in range(8)]
    ex = [torch.stack([getattr(p, f) for p in parts]) for f in ("data", "scales", "zeros")]
    xe = torch.randn(4, 4096, generator=g, device=dev).to(torch.bfloat16)
    eidx = torch.tensor([1, 6, 3, 6], dtype=torch.int32, device=dev)
    w4 = quantize_pack(torch.randn(2048, 2560, generator=g, device=dev) * 0.02, 4, 128)
    xm = torch.randn(1024, 2048, generator=g, device=dev).to(torch.bfloat16)
    a = torch.randn(1024, 1024, generator=g, device=dev).to(torch.bfloat16)
    m4 = (4, 128, 2048, 2560)
    return {
        "k6_gemv_tc": ("w8a8_gemv_tc_kernel",
                       lambda: k6.w8a8_matmul(x8, w8.data, w8.scales, w8.zeros, (8, 2048, 2048, 2048))),
        "k10_gemv_tc": ("moe_gathered_tc_kernel",
                        lambda: k9.moe_gathered_matmul(xe, eidx, *ex, (4, 128, 4096, 1024))),
        "k1_gemv_tc": ("dq_gemv_tc_kernel",
                       lambda: k1.quantized_matmul(x8, w4.data, w4.scales, w4.zeros, m4)),
        "k1_wgmma": ("dq_wgmma_kernel",
                     lambda: k1.quantized_matmul(xm, w4.data, w4.scales, w4.zeros, m4)),
        "torch_mm": ("", lambda: a @ a),  # every kernel record: cuBLAS names vary
    }


def session(torch, fn, tag, reps=4):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    rows = {e.key: e.count for e in avg}
    kern = sum(e.count for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA and tag in e.key)
    return kern, sorted(rows)


def graph_nodes(torch, fn, reps=4, dump_to=None) -> dict:
    """{kernel name: nodes} of a CUDA graph captured over reps calls."""
    from qtpu_torch.serve.graphs import kernel_nodes

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    seen = {}
    for name in kernel_nodes(g, dump_to):
        seen[name[:90]] = seen.get(name[:90], 0) + 1
    return seen


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs

    n = int((argv or sys.argv[1:] or ["300"])[0])
    DUMPS.mkdir(parents=True, exist_ok=True)
    card = cs.nvidia_smi_line()
    cases = calls(torch)
    for _, fn in cases.values():
        fn()
    torch.cuda.synchronize()
    short = {k: [] for k in cases}
    held = {k: set() for k in cases}
    for i in range(n):
        for name, (tag, fn) in cases.items():
            kern, keys = session(torch, fn, tag)
            if kern < 4:
                short[name].append((i, kern))
                held[name].update(keys)
    block = max(1, n // 6)
    for name in cases:
        by_block = [sum(1 for i, _ in short[name] if b <= i < b + block) for b in range(0, n, block)]
        emit = {"call": name, "sessions": n, "short_sessions": len(short[name]),
                "short_by_block_of_sessions": by_block, "block": block,
                "records_seen_when_short": sorted({k for _, k in short[name]}),
                "what_short_sessions_held": sorted(held[name])[:12],
                "graph_kernel_nodes_of_4_calls": graph_nodes(
                    torch, cases[name][1], dump_to=DUMPS / f"graph_{name}.dot"),
                "card": card}
        print(json.dumps(emit), flush=True)
    print(json.dumps({"summary": {k: len(v) for k, v in short.items()}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
