"""Scaling of the sharded decode over ('data', 'model') meshes (port of
qtpu/bench/scaling.py):

    python -m qtpu_torch.bench.scaling [--model tinyllama] [--meshes 1x1,2x1,2x2]
                                       [--device cuda] [--group 128]

Measures decode tokens/s on meshes of growing size and reports the
efficiency against linear scaling of the one-device run. Data parallelism
scales the serving batch (each data shard decodes its own sequences);
tensor parallelism splits the weights and the KV heads (qtpu_torch.sharding
.specs, KV heads replicated where tp exceeds them).

The ranks are processes of one torch.distributed world: called inside an
initialized world, every rank calls scaling_sweep and each shape runs on the
world's first dp * tp ranks (the rest wait at the next shape); called in
one process, it spawns that world (qtpu_torch.sharding.multihost.spawn, as
many ranks as the largest shape, on the backend choose_backend gives) and
hands the params to the ranks through a file. Ranks that share one card
(gloo, NCCL refusing two ranks on a card) or the CPU give a functional run
of the sharded path whose efficiency means nothing, as qtpu says of its
virtual CPU mesh; only ranks with a card each measure scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def decode_tokens_per_s(params, cfg, qmeta=None, mesh=None, batch_per_data_shard: int = 8,
                        prompt_len: int = 64, n_steps: int = 32, arch: str = "llama",
                        record=None) -> float:
    """Tokens/s of the batched greedy decode loop, optionally over a mesh
    (params whole; the rank's shard is cut here). Each data shard runs
    batch_per_data_shard sequences: a prefill, then decode steps on the
    int8 cache. qtpu's estimator: the global batch over the per-step time
    of an n_steps + 2 run against a 2-step run, each ended by a host read of
    the last tokens (on the card after all of the step's work). record: a
    dict that receives the rank's rows' greedy tokens [b, n_steps + 2] and
    logits [b, n_steps + 3, V] (the prefill's first) of the longest run."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group
    from qtpu_torch.sharding.specs import shard_model

    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    B = batch_per_data_shard * dp
    dev = params["embed"].device
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, prompt_len))).to(torch.int32)
    b, d = batch_per_data_shard, axis_rank(mesh, "data")
    prompt = prompt[d * b:(d + 1) * b].to(dev)
    group = None
    if mesh is not None:
        params, qmeta, cfg = shard_model(params, qmeta, cfg, mesh)
        group = local_group(mesh, "model") if tp > 1 else None

    def run(n):
        cache = init_cache(cfg, b, prompt_len + n_steps + 8, quantized=True, device=dev)
        keep = record is not None and n == n_steps + 2
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompt, cache, cfg, qmeta, arch=arch, tp=group)
        outs, toks = [logits], []
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
        for _ in range(n):
            toks.append(tok)
            logits, cache = decode_step(params, tok, pos, cache, cfg, qmeta, arch=arch, tp=group)
            if keep:
                outs.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos = pos + 1
        int(tok.sum())
        dt = time.perf_counter() - t0
        if keep:
            record["tokens"] = torch.stack(toks, 1).cpu()
            record["logits"] = torch.stack(outs, 1).float().cpu()
        return dt

    run(2)
    per_tok = max((run(n_steps + 2) - run(2)) / n_steps, 1e-9)
    return B / per_tok


def _sweep_here(params, cfg, qmeta, mesh_shapes, repeats, kw, records=None) -> list[dict]:
    """The sweep on the initialized world (or one process): every rank
    builds each mesh; its first dp * tp ranks measure; rank 0's rate is
    broadcast over the world."""
    import torch.distributed as dist

    from qtpu_torch.sharding.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    results, base = [], None
    for dp, tp in mesh_shapes:
        n = dp * tp
        if n > world:
            raise ValueError(f"mesh {dp}x{tp} needs {n} devices, have {world}")
        mesh = make_mesh(data=dp, model=tp) if n > 1 else None
        trials = []
        for _ in range(max(1, repeats)):
            rec = {} if records is not None else None
            tps = (decode_tokens_per_s(params, cfg, qmeta, mesh, record=rec, **kw)
                   if rank < n else 0.0)
            if world > 1:  # rank 0's rate on every rank
                on = "cuda" if dist.get_backend() == "nccl" else "cpu"
                t = torch.tensor([tps], dtype=torch.float64, device=on)
                dist.broadcast(t, src=0)
                tps = float(t)
            trials.append(tps)
            if rec:
                records[(dp, tp)] = rec
        tps = max(trials)
        if base is None:
            base = tps
        row = {"mesh": {"data": dp, "model": tp}, "devices": n, "tokens_per_second": tps,
               "scaling_efficiency": tps / (base * n)}
        if repeats > 1:
            row["trials_tokens_per_second"] = trials
        results.append(row)
    return results


def _rank(rank, world, d, device, mesh_shapes, repeats, kw, record):
    from qtpu_torch.sharding.multihost import device_of_rank

    dev = device_of_rank() if device == "cuda" else "cpu"
    if dev == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    blob = torch.load(f"{d}/params.pt", map_location=dev, weights_only=False)
    records = {} if record else None
    rows = _sweep_here(blob["params"], blob["cfg"], blob["qmeta"], mesh_shapes, repeats, kw,
                       records)
    torch.save({"rows": rows, "records": records}, f"{d}/rank{rank}.pt")


def scaling_sweep(params, cfg, qmeta=None, mesh_shapes=((1, 1), (2, 1), (4, 1)),
                  repeats: int = 1, records=None, **kw) -> list[dict]:
    """Tokens/s across mesh shapes; efficiency = tps / (tps_1 x N), tps_1 the
    first shape's. repeats > 1 measures each shape that many times and
    reports the best, with every trial. kw: decode_tokens_per_s's.

    Inside an initialized world every rank must call it (the same shapes);
    otherwise it spawns a world of the largest shape's ranks on the params'
    device (the card, or the CPU when the params are there) and returns
    rank 0's rows. records: a dict that receives, per (dp, tp), each rank's
    greedy tokens and logits of its rows ({rank: record} when spawned)."""
    import torch.distributed as dist

    from qtpu_torch.sharding.multihost import spawn

    world = max(dp * tp for dp, tp in mesh_shapes)
    if dist.is_initialized() or world == 1:
        return _sweep_here(params, cfg, qmeta, mesh_shapes, repeats, kw, records)
    device = params["embed"].device.type
    with tempfile.TemporaryDirectory() as d:
        torch.save({"params": params, "cfg": cfg, "qmeta": qmeta}, f"{d}/params.pt")
        spawn(_rank, world, (d, device, tuple(mesh_shapes), repeats, kw, records is not None),
              init_file=f"{d}/init", device=device, timeout_s=600)
        outs = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    if records is not None:
        for r, o in enumerate(outs):
            for shape, rec in o["records"].items():
                records.setdefault(shape, {})[r] = rec
    return outs[0]["rows"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tinyllama", help="a preset (qtpu_torch.models.config)")
    ap.add_argument("--meshes", default="1x1,2x1,2x2", help="data x model shapes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--group", type=int, default=128,
                    help="RTN W4 group (64 for the tiny presets at tp 4)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("qtpu_torch.bench.scaling: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    from qtpu_torch.bench.synth import tiled_packed_llama
    from qtpu_torch.models.config import get_model_config

    cfg = get_model_config(args.model)
    packed, qmeta = tiled_packed_llama(cfg, 4, args.group, device=args.device)
    shapes = tuple(tuple(int(v) for v in s.split("x")) for s in args.meshes.split(","))
    for row in scaling_sweep(packed, cfg, qmeta, shapes):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
