#!/usr/bin/env python3
"""What bounds the decode GEMV (M <= 8) of the dequant matmuls on the card:
at Mixtral-8x7B's K9 decode sites (E 8, W4 g128, M 8) and TinyLlama-1.1B's
five fused W4 g128 sites (M 8), times

  current   the body of qtpu_torch/csrc/dq_core.cuh (dq_tile, SIMT f32 FMAs),
            split K as the wrappers split it, with its sum of the splits;
  nofma     the same launches with the products x * w removed (every load and
            every dequantization kept, each weight folded into one f32 sum);
  stream    the same packed bytes read once, 16-byte loads, nothing computed;
  tc        the wrappers' tensor-core body (csrc/dq_gemv_tc.cuh), where the
            package has it (quantized_matmul.gemv_tc_launches), at the split
            of K its rule picks (gemv_split) and, in "tc_by_cluster", at every
            other cluster size that splits K into non-empty slices of whole
            groups (the C entries take the cluster as an argument);

beside the byte bound (packed codes, scales and zeros at 3.35 TB/s). If
`current` sits near `nofma`, the loads and the dequantization bound the body
(bytes in flight or issue); if `nofma` sits near `stream`, the products do.

    python3 tools/exp_decode_gemv.py        # on a machine with an H100

Builds tools/exp_decode_gemv.cu with nvcc into build/exp/; prints one JSON
line per site (per-call µs from CUDA events around a CUDA graph, enough
copies of a small site to exceed the 50 MB L2), with nvidia-smi's name and
power limit. Imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from qtpu_torch.core.packing import quantize_pack  # noqa: E402
from qtpu_torch.kernels import _build  # noqa: E402
from qtpu_torch.kernels import dequant_matmul as k1  # noqa: E402
from qtpu_torch.kernels import moe_matmul as k9  # noqa: E402

L2_BYTES = 50 * 1024 * 1024
HBM = 3.35e12
GROUP = 128
# name: (E, K, N, per-expert x)
SITES = {
    "mixtral_gate_up": (8, 4096, 14336, False), "mixtral_down": (8, 14336, 4096, True),
    "tinyllama_qkv": (1, 2048, 2560, False), "tinyllama_o": (1, 2048, 2048, False),
    "tinyllama_gateup": (1, 2048, 11264, False), "tinyllama_down": (1, 5632, 2048, False),
    "tinyllama_lm_head": (1, 2048, 32000, False),
}
M = 8


def build():
    out = ROOT / "build" / "exp"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libexp_decode_gemv.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(ROOT / "qtpu_torch" / "csrc"),
           "-o", str(lib), str(ROOT / "tools" / "exp_decode_gemv.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_dq.argtypes = [P, I, P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.exp_stream.argtypes = [P, ctypes.c_longlong, P, I, P]
    return lib, [ln.strip() for ln in r.stdout.splitlines() + r.stderr.splitlines()
                 if "registers" in ln or "spill" in ln]


def timed(calls, reps=120):
    """Warm per-call ms of `calls` cycled in a CUDA graph."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        for i in range(reps):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def site_case(lib, name, E, K, N, per_expert, dev, gen):
    wbytes = E * (K * N / 2 + (K // GROUP) * N * 3)
    copies = max(1, min(32, math.ceil(2 * L2_BYTES / wbytes)))
    sites = []
    for _ in range(copies):
        parts = [quantize_pack(torch.randn(K, N, generator=gen, device=dev) * 0.02, 4, GROUP)
                 for _ in range(E)]
        sites.append(tuple(torch.stack([getattr(p, f) for p in parts])
                           for f in ("data", "scales", "zeros")))
    x = torch.randn(*((E,) if per_expert else ()), M, K, generator=gen, device=dev)
    x = x.to(torch.bfloat16)
    out = torch.empty(E, M, N, dtype=torch.bfloat16, device=dev)
    per, part = k1.split_k(dev, M, K, N * E, GROUP)
    part_p = None if part is None else part.data_ptr()

    def body(s, nofma):
        rc = lib.exp_dq(x.data_ptr(), int(per_expert), s[0].data_ptr(), s[1].data_ptr(),
                        s[2].data_ptr(), out.data_ptr(), part_p, per, E, M, K, N, GROUP, nofma,
                        _build.stream_of(x))
        _build.check(rc, "exp_dq")

    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def stream(s):
        rc = lib.exp_stream(s[0].data_ptr(), s[0].numel(), sink.data_ptr(), 8 * sms,
                            _build.stream_of(x))
        _build.check(rc, "exp_stream")

    # the current body against the wrapper's plain version, so the times are of a right body
    body(sites[0], 0)
    want = k9.moe_matmul_plain(x, *sites[0], (4, GROUP, K, N), per_expert)
    err = float(torch.linalg.vector_norm(out.float() - want.float())
                / torch.linalg.vector_norm(want.float()))
    row = {"site": name, "E": E, "M": M, "K": K, "N": N, "group": GROUP, "copies": copies,
           "split_groups": per, "current_rel_err": err,
           "bound_us": 1e6 * wbytes / HBM,
           "current_us": 1e3 * timed([lambda s=s: body(s, 0) for s in sites]),
           "nofma_us": 1e3 * timed([lambda s=s: body(s, 1) for s in sites]),
           "stream_us": 1e3 * timed([lambda s=s: stream(s) for s in sites])}
    if hasattr(k1.quantized_matmul, "gemv_tc_launches"):
        meta = (4, GROUP, K, N)
        if E == 1:
            xs = x.reshape(M, K)
            calls = [lambda s=s: k1.quantized_matmul(xs, s[0][0], s[1][0], s[2][0], meta)
                     for s in sites]
        else:
            calls = [lambda s=s: k9.moe_matmul(x, *s, meta, per_expert_input=per_expert)
                     for s in sites]
        row["tc_us"] = 1e3 * timed(calls)
        row["tc_cluster"] = k1.gemv_tc_split(dev, K, N, GROUP, tiles=E * -(-N // k1.GEMV_TC_COLS))
        row["tc_by_cluster"] = {}
        groups = K // GROUP
        lib1 = _build.load("dequant_matmul", k1._SIG)
        lib9 = _build.load("moe_matmul", k9._SIG)
        for c in range(1, 9):
            per = -(-groups // c)
            if per * (c - 1) >= groups or per * GROUP > k1.GEMV_TC_X_CAP:
                continue

            def forced(s, c=c, per=per):
                st = _build.stream_of(x)
                if E == 1:
                    rc = lib1.qtpu_dq_matmul(x.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                                             s[2].data_ptr(), out.data_ptr(), None, per, c,
                                             M, K, N, 4, GROUP, st)
                else:
                    rc = lib9.qtpu_moe_grouped(x.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                                               s[2].data_ptr(), out.data_ptr(), None, per, c,
                                               int(per_expert), E, M, K, N, 4, GROUP, st)
                _build.check(rc, "gemv_tc")
            row["tc_by_cluster"][c] = 1e3 * timed([lambda s=s: forced(s) for s in sites])
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_decode_gemv: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib, ptxas = build()
    print(json.dumps({"card": smi, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (E, K, N, per_expert) in SITES.items():
        print(json.dumps(site_case(lib, name, E, K, N, per_expert, dev, gen)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
