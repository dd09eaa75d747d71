#!/usr/bin/env python3
"""Device time of one packed W4 eval block of qtpu_torch, compared across
source trees in turns on one CUDA card.

    python3 tools/torch_eval_block_pairs.py --blocks 6 PARENT . . PARENT

Each TREE argument (a checkout holding qtpu_torch/ and fixtures/) runs in a
process of its own, in the order given, importing that tree's qtpu_torch:
TinyLlama-1.1B (22 layers, random weights from seed 0), RTN W4 g128 packed
with fused sites, one warm block of 2048 tokens of the committed fixture,
then --blocks blocks timed on the host around a synchronize and --blocks
blocks each under torch.profiler (device time: the sum of its CUDA
kernels' time; K1's part: the kernels named dq_*). One JSON line per tree
run, then nvidia-smi's name and power limit and a summary line with each
tree's readings in run order. It imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BLOCK = 2048
MCFG = {"w_bit": 4, "q_group_size": 128}


def child(tree: Path, blocks: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import qtpu_torch
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    pkg = Path(qtpu_torch.__file__).resolve()
    if not pkg.is_relative_to(tree):
        raise RuntimeError(f"qtpu_torch imported from {pkg}, not from {tree}")
    ids = load_fixture_test(str(tree / "fixtures" / "public_bytes"))
    params = llama.init_params(cfg, seed=0, device="cuda")
    packed, qmeta = fuse_packed_sites(*pack_model(params, "rtn", MCFG))
    del params
    torch.cuda.empty_cache()

    def block():
        return evaluate_perplexity(packed, ids, cfg, n_samples=1, block_size=BLOCK, qmeta=qmeta)

    ppl = block()  # warm: builds and loads the kernels
    wall = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    device, k1 = [], []
    for _ in range(blocks):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            block()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device.append(sum(t for _, t in rows) / 1e3)
        k1.append(sum(t for k, t in rows if "dq_" in k) / 1e3)
    return {"tree": str(tree), "perplexity": ppl, "host_ms": wall, "device_ms": device,
            "k1_device_ms": k1, "device_ms_median": statistics.median(device),
            "host_ms_median": statistics.median(wall)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path, help="source trees, run in this order")
    ap.add_argument("--blocks", type=int, default=6, help="timed and profiled blocks a run")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.blocks)), flush=True)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree.resolve()),
                               "--blocks", str(args.blocks)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"the run on {tree} failed ({proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"summary": [
        {k: r[k] for k in ("tree", "device_ms_median", "host_ms_median", "perplexity")}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
