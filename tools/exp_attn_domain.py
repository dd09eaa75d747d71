#!/usr/bin/env python3
"""Times the attention kernels and their build, on the card.

    python3 tools/exp_attn_domain.py --times [--tree PATH]
    python3 tools/exp_attn_domain.py --build-modes

--times: the warm time of each attention kernel (K5, K3, K8, K11, the
one-layer entry, K12) at the main paths' shapes at the head dims the kernels
took before hd 8-256 (TIMES), from the qtpu_torch of PATH (default: this
tree), so that two trees can be timed in turns within one call.
--build-modes: the wall time of building every kernel source at once
(qtpu_torch.kernels._build.build) into a fresh directory in each of
BUILD_MODES: one nvcc process a source, the attention sources with nvcc's
--split-compile=0 (_build.SPLIT_COMPILE, the build's way), and every source
without it.
Prints one JSON line per measurement. Imports nothing of JAX or qtpu; the
kernels' agreement with their plain versions over their whole domain is
tests/test_torch_gpu.py's (test_attention_kernels_take_every_head_dim,
test_attention_kernels_take_any_group).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREE = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() if "--tree" in sys.argv else ROOT
sys.path.insert(0, str(TREE))

import torch  # noqa: E402

from qtpu_torch.kernels import _build  # noqa: E402
from qtpu_torch.kernels import flash_attention as k5  # noqa: E402
from qtpu_torch.kernels import kv_attention as k23  # noqa: E402

SOURCES = ("flash_attention", "kv_attention", "kv_flash_decode")
# mode -> the sources compiled with --split-compile=0
BUILD_MODES = {"split_compile": _build.SPLIT_COMPILE, "one_thread_a_source": ()}


def cache(g, L, B, KV, S, hd, dev):
    k = torch.randint(-127, 128, (L, B, KV, S, hd), generator=g, device=dev).to(torch.int8)
    v = torch.randint(-127, 128, (L, B, KV, S, hd), generator=g, device=dev).to(torch.int8)
    ks = torch.rand(L, B, KV, S, generator=g, device=dev) * 0.05 + 0.01
    vs = torch.rand(L, B, KV, S, generator=g, device=dev) * 0.05 + 0.01
    return [k, v, ks, vs]


# (name, kernel, B, KV, G, hd, S): the main paths' attention shapes at the
# head dims taken before: TinyLlama's serve and long_ctx, Mixtral's and
# OPT-2.7B's decode, GPT-2's one-layer entry, the eval blocks
TIMES = [("tinyllama_k3", "k3", 8, 4, 8, 64, 176), ("tinyllama_k11", "k11", 8, 4, 8, 64, 176),
         ("tinyllama_k8", "k8", 8, 4, 8, 64, 176), ("mixtral_k11", "k11", 8, 8, 4, 128, 176),
         ("gpt2_layer", "layer", 8, 12, 1, 64, 176), ("opt27_layer", "layer", 8, 32, 1, 80, 176),
         ("opt27_k8", "k8", 8, 32, 1, 80, 176), ("long_ctx_k12", "k12", 8, 4, 8, 64, 32768),
         ("mistral_k12", "k12", 4, 8, 4, 128, 32768), ("eval_k5_hd64", "k5", 1, 4, 8, 64, 2048),
         ("eval_k5_hd128", "k5", 1, 8, 4, 128, 2048), ("eval_k5_hd80", "k5", 1, 32, 1, 80, 2048)]


def graph_ms(calls, reps=100):
    """Warm per-call ms of `calls` cycled in a CUDA graph (CUDA events)."""
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
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * reps)


def times(smi):
    """One JSON line of every TIMES shape's warm ms (8 layers or inputs
    cycled, past the L2 where they fill it)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"tree": str(TREE), "card": smi}
    for name, kind, B, KV, G, hd, S in TIMES:
        H = KV * G
        if kind == "k5":
            sets = [[(torch.randn(1, n, S, hd, generator=g, device=dev) * 0.5).to(torch.bfloat16)
                     for n in (H, KV, KV)] for _ in range(4)]
            out[name] = graph_ms([lambda s=s: k5.flash_attention(*s, 0) for s in sets], 40)
            continue
        q = torch.randn(B, H, hd, generator=g, device=dev).to(torch.bfloat16)
        kn = torch.randn(B, 1, KV, hd, generator=g, device=dev).to(torch.bfloat16)
        vn = torch.randn(B, 1, KV, hd, generator=g, device=dev).to(torch.bfloat16)
        if kind == "k12":
            c = [t[0] for t in cache(g, 1, B, KV, S, hd, dev)]
            pos = torch.tensor([S - 64 + 7 * i for i in range(B)], dtype=torch.int32, device=dev)
            out[name] = graph_ms([lambda: k23.decode_attention_flash(q, kn, vn, *c, pos)], 40)
            continue
        L = 8
        pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S - 1][:B], dtype=torch.int32,
                           device=dev)
        if kind == "k8":
            kb = torch.randn(L, B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
            vb = torch.randn(L, B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
            calls = [lambda l=l: k23.decode_attention_write_bf16(q, kn, vn, kb, vb, pos, l)
                     for l in range(L)]
        else:
            c = cache(g, L, B, KV, S, hd, dev)
            calls = {"k3": [lambda l=l: k23.decode_attention(q, *c, pos, l) for l in range(L)],
                     "k11": [lambda l=l: k23.decode_attention_write(q, kn, vn, *c, pos, l)
                             for l in range(L)],
                     "layer": [lambda l=l: k23.decode_attention_layer(q, *(t[l] for t in c), pos)
                               for l in range(L)]}[kind]
        out[name] = graph_ms(calls)
    print(json.dumps(out), flush=True)
    return 0


def build_modes(smi):
    """One JSON line a mode of BUILD_MODES: the wall seconds of building
    every source of _build.SOURCES at once into a fresh directory, and each
    attention source's seconds (or the build's error)."""
    split = _build.SPLIT_COMPILE
    for mode, mode_split in BUILD_MODES.items():
        _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix=f"qtpu_build_{mode}_"))
        _build.SPLIT_COMPILE = mode_split
        t0 = time.perf_counter()
        try:
            rep = _build.build()
            out = {n: rep[n]["seconds"] for n in SOURCES}
        except RuntimeError as e:
            out = {"error": str(e)[:2000]}
        print(json.dumps({"build_mode": mode, "split_compile": mode_split,
                          "wall_s": time.perf_counter() - t0, "seconds": out, "card": smi}),
              flush=True)
    _build.SPLIT_COMPILE, _build.BUILD_DIR = split, _build.DEFAULT_BUILD_DIR
    return 0


def main(argv):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if "--build-modes" in argv:
        return build_modes(smi)
    if "--times" in argv:
        _build.build(SOURCES)
        return times(smi)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
