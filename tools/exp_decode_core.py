#!/usr/bin/env python3
"""Times K3's kernel (its K3 and K11 modes) at forced cluster sizes and K12
at forced split counts, on the card, at the decode shapes of the port's
paths: how the cluster rule (`decode_cluster`) and the split rule
(`flash_splits`) of qtpu_torch/kernels/kv_attention.py sit against the
sizes around them.

    python3 tools/exp_decode_core.py        # on a machine with an H100

Prints one JSON line per case: the shape, the size forced and the warm
per-call time (CUDA events around a CUDA graph of calls cycling over enough
layers to exceed the L2), with nvidia-smi's name and power limit.
Imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from qtpu_torch.kernels import _build  # noqa: E402
from qtpu_torch.kernels import kv_attention as kv  # noqa: E402

# (name, B, KV, G, hd, S, layers cycled): the serve cells' decode attention
K3_SHAPES = (("tinyllama", 8, 4, 8, 64, 176, 22), ("mixtral", 8, 8, 4, 128, 176, 32),
             ("gpt2", 8, 12, 1, 64, 176, 12))
# (name, B, KV, G, hd, S, window): K12's long rows
K12_SHAPES = (("tinyllama_s32768", 8, 4, 8, 64, 32768, 0),
              ("mistral_window4096", 4, 8, 4, 128, 32768, 4096))


def timed(calls, reps=200):
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


def k3_cases(dev, gen):
    lib = _build.load("kv_attention", kv._SIG)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, B, KV, G, hd, S, L in K3_SHAPES:
        k = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
        v = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
        ks = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
        vs = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
        q = torch.randn(B, KV * G, hd, generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        for mode in ("k3", "k11"):
            for cl in range(1, 9):
                def call(l, cl=cl, mode=mode):
                    st = _build.stream_of(q)  # the capturing stream inside the graph
                    if mode == "k3":
                        rc = lib.qtpu_decode_attention(
                            q.data_ptr(), k[l].data_ptr(), v[l].data_ptr(), ks[l].data_ptr(),
                            vs[l].data_ptr(), pos.data_ptr(), out.data_ptr(), B, KV, G, S, hd, 0,
                            cl, st)
                    else:
                        rc = lib.qtpu_decode_attention_write(
                            q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k[l].data_ptr(),
                            v[l].data_ptr(), ks[l].data_ptr(), vs[l].data_ptr(), pos.data_ptr(),
                            out.data_ptr(), B, KV, G, S, hd, 0, cl, st)
                    kv._launched(rc, mode, cl)
                ms = timed([lambda l=l: call(l) for l in range(L)])
                print(json.dumps({"kernel": mode, "shape": name, "B": B, "KV": KV, "G": G,
                                  "hd": hd, "S": S, "cluster": cl,
                                  "rule": kv.decode_cluster(sms, B, KV, S), "us": 1e3 * ms}),
                      flush=True)
        del k, v, ks, vs


def scaling_cases(dev, gen):
    """K3 at one block a (sequence, kv-head) against the rows it reads, at
    Mixtral's and TinyLlama's widths: the slope is the time a chunk, the
    intercept what a block pays whatever it reads."""
    lib = _build.load("kv_attention", kv._SIG)
    for name, B, KV, G, hd, L in (("mixtral", 8, 8, 4, 128, 32), ("tinyllama", 8, 4, 8, 64, 22),
                                  ("mixtral_hd64", 8, 8, 4, 64, 32)):
        S = 1024
        k = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
        v = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
        ks = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
        vs = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
        q = torch.randn(B, KV * G, hd, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty_like(q)
        for rows in (1, 64, 128, 192, 256, 512, 1024):
            pos = torch.full((B,), rows - 1, dtype=torch.int32, device=dev)

            def call(l):
                rc = lib.qtpu_decode_attention(
                    q.data_ptr(), k[l].data_ptr(), v[l].data_ptr(), ks[l].data_ptr(),
                    vs[l].data_ptr(), pos.data_ptr(), out.data_ptr(), B, KV, G, S, hd, 0, 1,
                    _build.stream_of(q))
                kv._launched(rc, "k3", 1)
            ms = timed([lambda l=l: call(l) for l in range(L)])
            print(json.dumps({"kernel": "k3_rows", "shape": name, "hd": hd, "rows": rows,
                              "cluster": 1, "us": 1e3 * ms}), flush=True)
        del k, v, ks, vs


def k12_cases(dev, gen):
    lib = _build.load("kv_flash_decode", kv._FLASH_SIG)
    for name, B, KV, G, hd, S, window in K12_SHAPES:
        k = torch.empty(B, KV, S, hd, dtype=torch.int8, device=dev).random_(-127, 128,
                                                                            generator=gen)
        v = torch.empty(B, KV, S, hd, dtype=torch.int8, device=dev).random_(-127, 128,
                                                                            generator=gen)
        ks = torch.empty(B, KV, S, device=dev).uniform_(0.01, 0.06, generator=gen)
        vs = torch.empty(B, KV, S, device=dev).uniform_(0.01, 0.06, generator=gen)
        q = torch.randn(B, KV * G, hd, generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor([S - 64, S - 55, S - 46, S - 37, S - 28, S - 19, S - 1, S + 3][:B],
                           dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        rule = kv.flash_splits(torch.cuda.get_device_properties(0).multi_processor_count,
                               kv.flash_blocks_per_sm(0, hd), B, KV,
                               min(S, window) if window else S)
        for nsplit in sorted({4, 8, 12, 16, 17, 24, 32, 48, 64, rule}):
            part = torch.empty(B * KV * nsplit * G * (hd + 2), dtype=torch.float32, device=dev)
            for body in ("mma", "simt"):
                fn = lib.qtpu_flash_decode if body == "mma" else lib.qtpu_flash_decode_simt

                def call(fn=fn, part=part, nsplit=nsplit):
                    rc = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k.data_ptr(),
                            v.data_ptr(), ks.data_ptr(), vs.data_ptr(), pos.data_ptr(),
                            part.data_ptr(), out.data_ptr(), B, KV, G, S, hd, window, nsplit,
                            _build.stream_of(q))
                    _build.check(rc, "flash_decode")
                ms = timed([call], reps=20)
                print(json.dumps({"kernel": "k12", "body": body, "shape": name, "nsplit": nsplit,
                                  "rule": rule, "us": 1e3 * ms}), flush=True)
        del k, v, ks, vs


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_decode_core: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k3_cases(dev, gen)
    scaling_cases(dev, gen)
    k12_cases(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
