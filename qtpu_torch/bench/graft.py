"""The one-card forward step and the multi-rank dry run (port of qtpu's
__graft_entry__.py):

    python -m qtpu_torch.bench.graft N [--device cuda|cpu]

`entry()` returns (fn, (packed, ids)): the packed forward of
TinyLlama-1.1B, RTN W4 g128 with fused qkv / gate-up sites (one random
layer a site tiled over the layers, qtpu_torch.bench.synth), on ids of
zeros [1, 128]; on the card fn runs K1 on every linear and K5 (K4 is the
decode step's). qtpu jits fn; here it runs eagerly, as the bench's
forward does.

`dryrun_multichip(n)` runs qtpu's seven steps on TINY_TEST over n ranks of
one torch.distributed world (qtpu_torch.sharding), one real step each:
  1. data-parallel calibration capture (statistics reduced over `data`);
  2. AWQ quantize on those statistics;
  3. the tensor-parallel packed forward (RTN W4 g64) on a data x model
     mesh, model 2 for even n;
  4. the expert-parallel MoE forward (TINY_MOE_TEST, experts over `model`);
  5. the GPipe NLL over 2 stages;
  6. at n >= 8, the data 2 x pipe 2 x model 2 mesh's NLL;
  6b. the seq-sharded ring forward over seq 4 (seq n below 4 ranks);
  7. the sharded true-Hessian capture.
Rank 0's qtpu "dryrun_multichip ok: ..." line is printed. Called in one
process it spawns the n ranks (gloo on the CPU or sharing one card, NCCL
with a card each: choose_backend), prints rank 0's line and returns every
rank's results; inside a world of n ranks every rank calls it and rank 0
prints.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

ENTRY_TOKENS = 128


def entry(cfg=None, device="cuda"):
    """(fn, example_args): the packed forward step of the flagship model,
    TinyLlama-1.1B with packed W4 g128 weights on fused sites (cfg: another
    llama ModelConfig)."""
    from qtpu_torch.bench.synth import tiled_packed_llama
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B

    cfg = TINYLLAMA_1_1B if cfg is None else cfg
    packed, qmeta = tiled_packed_llama(cfg, w_bit=4, group=128, device=device)
    ids = torch.zeros((1, ENTRY_TOKENS), dtype=torch.int32, device=device)

    def fn(packed_params, input_ids):
        return llama.forward(packed_params, input_ids, cfg, qmeta=qmeta)

    fn.qmeta, fn.cfg = qmeta, cfg
    return fn, (packed, ids)


def _steps(n: int, device, say: bool = True) -> dict:
    """qtpu's dry run on this rank of an n-rank world (module docstring).
    Returns this rank's results: each step's output shape and the TP
    logits of its data shard. say: rank 0 prints the ok line."""
    import torch.distributed as dist

    from qtpu_torch.calib.sharded import collect_calibration_stats_sharded
    from qtpu_torch.models import llama, moe
    from qtpu_torch.models.config import TINY_MOE_TEST, TINY_TEST
    from qtpu_torch.quant.apply import pack_model, quantize_model
    from qtpu_torch.sharding.mesh import axis_rank, build_mesh, local_group, make_mesh
    from qtpu_torch.sharding.pipeline import make_pipe_mesh, pipeline_nll, shard_params_pipeline
    from qtpu_torch.sharding.ring_attention import seq_sharded_forward
    from qtpu_torch.sharding.specs import shard_model

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    cfg = TINY_TEST
    mesh = make_mesh(data=dp, model=tp)
    group = local_group(mesh, "model") if tp > 1 else None
    d = axis_rank(mesh, "data")
    params = llama.init_params(cfg, seed=0, device=device)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (dp * 2, 64))).to(torch.int32)
    rows = ids[d * 2:(d + 1) * 2].to(device)
    res = {"rank": rank, "mesh": (dp, tp), "ids": ids}

    # 1) data-parallel calibration capture (statistics reduced over `data`)
    calib = [ids[i:i + 1].numpy() for i in range(dp * 2)]
    stats = collect_calibration_stats_sharded(llama.forward, params, calib, cfg, mesh)
    res["stats_sites"] = sorted(stats.mean_abs)

    # 2) quantize step (AWQ on the captured statistics)
    qp = quantize_model(params, "awq", {"w_bit": 4, "q_group_size": 64, "protect_ratio": 0.01,
                                        "scale_factor": 2.0}, stats)
    res["awq_sites"] = sorted(s for s, p in qp["layers"].items() if isinstance(p, dict))

    # 3) tensor-parallel packed serving forward
    packed, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64})
    lp, lq, lc = shard_model(packed, qmeta, cfg, mesh)
    logits = llama.forward(lp, rows, lc, qmeta=lq, tp=group)
    res["tp_logits"] = logits.float().cpu()

    # 4) expert-parallel MoE forward (experts over `model`, the combine
    # all-reduced)
    mcfg = TINY_MOE_TEST
    mp, _, mc = shard_model(moe.init_params(mcfg, seed=1, device=device), None, mcfg, mesh)
    moe_logits = moe.forward(mp, rows, mc, tp=group)
    res["moe_logits"] = (dp * moe_logits.shape[0], *moe_logits.shape[1:])  # over `data`

    # 5) pipeline parallelism: 2 stages, qtpu's GPipe microbatch schedule
    pipe_msg = ""
    pp = 2 if n % 2 == 0 and cfg.num_layers % 2 == 0 else 1
    if pp > 1:
        pmesh = make_pipe_mesh(pipe=pp, data=1)
        if rank < pp:
            mb = torch.zeros((2, 1, 32), dtype=torch.int32, device=device)
            nll = pipeline_nll(shard_params_pipeline(params, pmesh), mb, cfg, pmesh, pp)
            res["pipe_nll"] = nll.float().cpu()
            pipe_msg = f", pipeline nll {tuple(nll.shape)} over {pp} stages"

    # 6) data x pipe x model: the GPipe schedule with each stage's Megatron
    # shard (TP collectives inside every tick)
    if n >= 8 and cfg.num_layers % 2 == 0:
        m3 = make_pipe_mesh(pipe=2, data=2, model=2)
        if rank < 8:
            mb = torch.zeros((2, 1, 32), dtype=torch.int32, device=device)
            p3 = shard_params_pipeline(params, m3, cfg=cfg)
            res["pipe3_nll"] = pipeline_nll(p3, mb, cfg, m3, 2).float().cpu()
            pipe_msg += ", data=2 x pipe=2 x model=2 nll ok"

    # 6b) sequence parallelism: the whole forward with its sequence over
    # `seq`, every layer's attention the chunked ring
    sq = min(4, n)
    smesh = build_mesh((sq,), ("seq",))
    ids_seq = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 64))).to(torch.int32).to(device)
    if rank < sq:
        ring = seq_sharded_forward(params, ids_seq, cfg, local_group(smesh, "seq"), chunk=8)
        res["ring_shape"] = (1, sq * ring.shape[1], ring.shape[-1])  # the ranks' parts

    # 7) sharded true-Hessian calibration: the partial X^T X reduced over
    # `data`
    calib32 = [ids[i:i + 1, :32].numpy() for i in range(dp * 2)]
    st = collect_calibration_stats_sharded(llama.forward, params, calib32, cfg, mesh,
                                           collect_hessian=True)
    assert st.hessian is not None and "attn_in" in st.hessian
    res["hessian"] = tuple(st.hessian["attn_in"].shape)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    res["line"] = (f"dryrun_multichip ok: mesh data={dp} x model={tp}, "
                   f"logits {(dp * logits.shape[0], *logits.shape[1:])}, moe logits "
                   f"{res['moe_logits']}{pipe_msg}, seq-sharded fwd logits "
                   f"{res.get('ring_shape')} over seq={sq}, sharded hessian {res['hessian']}")
    if rank == 0 and say:
        print(res["line"], flush=True)
    return res


def _rank(rank, world, d, device):
    from qtpu_torch.sharding.multihost import device_of_rank

    dev = device_of_rank() if device == "cuda" else torch.device("cpu")
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.save(_steps(world, dev, say=False), f"{d}/rank{rank}.pt")


def dryrun_multichip(n_devices: int, device="cuda"):
    """qtpu's full pipeline over n_devices ranks on tiny shapes (module
    docstring). Inside a world of n_devices ranks every rank calls it and
    gets its own results; called in one process it spawns the world and
    returns every rank's results, rank 0's first."""
    import torch.distributed as dist

    from qtpu_torch.sharding.multihost import spawn

    if dist.is_initialized():
        from qtpu_torch.sharding.multihost import device_of_rank

        return _steps(n_devices, device_of_rank() if device == "cuda" else torch.device("cpu"))
    with tempfile.TemporaryDirectory() as d:
        spawn(_rank, n_devices, (d, device), init_file=f"{d}/init", device=device,
              timeout_s=600)
        res = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(n_devices)]
    print(res[0]["line"], flush=True)  # rank 0's line, from this process
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="ranks (default: the cards here, else 4)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("qtpu_torch.bench.graft: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 4)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
