#!/usr/bin/env python3
"""Two readings behind chip_smoke.py's shard gates, in a 2-process gloo
world sharing card 0 (as the shard phase runs it).

ring: the ring attention's forward at seq 2 (S 8192) against the one-rank
forward on K5, and against the one-rank forward through the same ring code,
for TinyLlama-1.1B at full width (RTN W4 g128 fused, random weights from
seed 0) cut to each depth given: the relative (Frobenius) error of each
rank's half of the logits. It sets the depth at which the smoke holds the
ring against K5.

moe: MoE EP 2's decode step at Mixtral-8x7B widths (2 layers, RTN W4 g128,
weights from seed 7, the shard phase's inputs, routes forced to the
one-rank run's) on 8 slots (K9) and 2 slots (K10 gathered), under variants
of the expert-parallel code: as it is; the gathered combine all-reduced in
bf16; the lm_head's all_gather staged through host memory; slots routed to
the other rank's experts not weighed 0. Which variant gives the 0.956 that
one early run of the 2-slot case read.

    python3 chip_smoke.py --phases build    # the kernels, once
    python3 tools/exp_shard_card.py 4 8 11 22

Prints one JSON line per rank and writes them to
chiprun_out/exp_shard_card.jsonl.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

MOE_VARIANTS = ("as_is", "bf16_combine", "staged_all_gather", "foreign_slots_weighed")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _cut(packed, n):
    """The first n layers of a stacked params tree."""
    def take(v):
        return None if v is None else v[:n]

    layers = {s: {k: take(v) for k, v in p.items()} if isinstance(p, dict) else p[:n]
              for s, p in packed["layers"].items()}
    return {**packed, "layers": layers}


def _gathered(moe, coll, bf16_combine, weigh_foreign):
    """moe._moe_mlp_gathered with the variant's changes."""
    import torch
    import torch.nn.functional as Fn

    def fn(h, layers, cfg, qm, l, tp=None):
        B, T, D = h.shape
        k = cfg.num_experts_per_tok
        topv, topi = moe._route(h, layers, cfg, qm, l)
        eidx = topi.reshape(B * k).to(torch.int32)
        if tp is not None:
            e0, E_loc = moe._local_experts(layers, tp)
            eidx = eidx - e0
            mine = (eidx >= 0) & (eidx < E_loc)
            eidx = torch.where(mine, eidx, torch.zeros_like(eidx))
            if not weigh_foreign:
                topv = topv * mine.reshape(topv.shape)
        xrows = h.reshape(B, D).repeat_interleave(k, dim=0)

        def gmm(x, site):
            p = layers[site]
            return moe.moe_gathered_matmul(x, eidx, p["data"][l], p["scales"][l],
                                           moe._at(p.get("zeros"), l), qm(site))

        act = Fn.silu(gmm(xrows, "exp_gate").float()).to(h.dtype) * gmm(xrows, "exp_up")
        d = gmm(act, "exp_down")
        out = (topv.reshape(B, k, 1) * d.float().reshape(B, k, D)).sum(dim=1)
        if bf16_combine:
            out = out.to(h.dtype)
        if tp is not None:
            out = coll.all_reduce(out, tp)
        return out.to(h.dtype).reshape(B, T, D)

    return fn


def _ring(rank, depths, smoke):
    import torch

    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.sharding.mesh import build_mesh, local_group
    from qtpu_torch.sharding.ring_attention import seq_sharded_forward

    packed, qmeta = smoke._tinyllama_w4(torch, {})
    ids = smoke._shard_inputs(torch, cfg)["seq"].cuda()
    g = local_group(build_mesh((2,), ("seq",)), "seq")
    Sl = ids.shape[1] // 2
    out = {}
    for n in depths:
        p, c = _cut(packed, n), cfg.replace(num_layers=n)
        got = seq_sharded_forward(p, ids, c, g, qmeta=qmeta)
        half = slice(rank * Sl, (rank + 1) * Sl)
        k5 = llama.forward(p, ids, c, qmeta=qmeta)[:, half]
        one_ring = seq_sharded_forward(p, ids, c, None, qmeta=qmeta)[:, half]
        out[n] = {"vs_k5_forward": _rel(got, k5), "vs_one_rank_ring": _rel(got, one_ring),
                  "one_rank_ring_vs_k5": _rel(one_ring, k5),
                  "max_abs_vs_k5": float((got - k5).abs().max())}
        del got, k5, one_ring
        torch.cuda.empty_cache()
    return out


def _moe(rank, smoke):
    import torch

    from qtpu_torch.models import moe
    from qtpu_torch.models.config import MIXTRAL_8X7B
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding import collectives as coll
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.specs import shard_model

    mesh = make_mesh(data=1, model=2)
    tp = local_group(mesh, "model")
    mcfg = MIXTRAL_8X7B.replace(num_layers=smoke.SHARD_MOE_LAYERS)
    mp, mq = pack_model(moe.init_params(mcfg, seed=7, device="cuda"), "rtn",
                        {"w_bit": 4, "q_group_size": smoke.MOE_GROUP}, arch="moe")
    torch.cuda.empty_cache()
    lp, lq, lc = shard_model(mp, mq, mcfg, mesh)
    route, gathered, card_ops = moe._route, moe._moe_mlp_gathered, coll.GLOO_CARD_OPS

    def run(p, q, c, ids, tp_, log, forced=None):
        moe._route = smoke._route_tap(moe, route, log, forced)
        try:
            B, T = ids.shape
            cache = init_cache(c, B, T + 16, quantized=True, device="cuda")
            logits, cache = prefill(p, ids, cache, c, q, arch="moe", tp=tp_)
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos = torch.full((B,), T, dtype=torch.int32, device="cuda")
            logits, cache = decode_step(p, tok, pos, cache, c, q, arch="moe", tp=tp_)
            return logits.float().cpu()
        finally:
            moe._route = route

    out = {}
    for B, ids in smoke._shard_inputs(torch, TINYLLAMA_1_1B)["moe"].items():
        ids = ids.cuda()
        one_log = []
        want = run(mp, mq, mcfg, ids, None, one_log)
        forced = [t for _, t in one_log]
        out[B] = {}
        for v in MOE_VARIANTS:
            moe._moe_mlp_gathered = _gathered(moe, coll, v == "bf16_combine",
                                              v == "foreign_slots_weighed")
            if v == "staged_all_gather":
                coll.GLOO_CARD_OPS = frozenset(card_ops - {"all_gather"})
            try:
                out[B][v] = _rel(run(lp, lq, lc, ids, tp, [], forced), want)
            finally:
                moe._moe_mlp_gathered, coll.GLOO_CARD_OPS = gathered, card_ops
    return out


def _work(rank, world, depths, out_path):
    import chip_smoke as smoke
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank, "ring": _ring(rank, depths, smoke), "moe": _moe(rank, smoke)}
    with open(out_path, "a") as f:
        f.write(json.dumps(res) + "\n")
    print(json.dumps(res), flush=True)


def main() -> int:
    import torch

    from qtpu_torch.sharding.multihost import spawn

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    depths = [int(a) for a in sys.argv[1:]] or [8, 22]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(ROOT, "chiprun_out", "exp_shard_card.jsonl")
    spawn(_work, 2, (depths, out_path), init_file=os.path.join(tempfile.mkdtemp(), "init"),
          device="cuda", timeout_s=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
