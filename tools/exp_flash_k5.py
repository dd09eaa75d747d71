#!/usr/bin/env python3
"""K5 (flash attention) on the card at several shapes: the Hopper body
(wgmma fed by TMA), the mma.sync body on the same bytes and SDPA, so that the
time can be split into a part a block pays whatever it computes and a part a
key tile pays (blocks scale with S, causal tiles with S^2 / 2), per head dim.

    python3 tools/exp_flash_k5.py        # on a machine with an H100

Prints one JSON line per shape (per-call µs from CUDA events around a CUDA
graph of calls) with nvidia-smi's name and power limit, and a least-squares
fit of time = blocks x per-block + tiles x per-tile for each body and head
dim. Imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from qtpu_torch.kernels import flash_attention as k5  # noqa: E402

# (B, H, KV, S, hd, window)
SHAPES = [(1, 32, 4, s, 64, 0) for s in (512, 1024, 2048, 4096)] + \
         [(4, 32, 4, 2048, 64, 0), (1, 32, 4, 2048, 64, 256)] + \
         [(1, 32, 8, s, 128, 0) for s in (512, 1024, 2048, 4096)]


def timed(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * reps) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_flash_k5: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for B, H, KV, S, hd, window in SHAPES:
        q = (torch.randn(B, H, S, hd, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        k = (torch.randn(B, KV, S, hd, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        v = torch.randn(B, KV, S, hd, generator=gen, device="cuda").to(torch.bfloat16)
        blocks = B * H * -(-S // k5.WGMMA_BQ)
        tiles = B * H * sum(len(k5.flash_tiles(q0, S, window))
                            for q0 in range(0, S, k5.WGMMA_BQ))
        row = {"B": B, "H": H, "KV": KV, "S": S, "hd": hd, "window": window,
               "blocks": blocks, "tiles": tiles,
               "wgmma_us": timed(lambda: k5.flash_attention(q, k, v, window)),
               "mma_us": timed(lambda: k5.flash_attention_mma(q, k, v, window))}
        if window == 0:
            row["sdpa_us"] = timed(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        rows.append(row)
        print(json.dumps(row), flush=True)
    for hd in (64, 128):
        pts = [r for r in rows if r["hd"] == hd]
        A = torch.tensor([[r["blocks"], r["tiles"]] for r in pts], dtype=torch.float64)
        for body in ("wgmma", "mma"):
            y = torch.tensor([r[f"{body}_us"] for r in pts], dtype=torch.float64)
            fit = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
            print(json.dumps({"fit": body, "hd": hd, "us_per_block": float(fit[0]),
                              "us_per_tile": float(fit[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
