#!/usr/bin/env python3
"""How far a tensor-parallel forward lies from the one-rank forward, beside
how far the one-rank forward lies from f32 arithmetic.

TinyLlama-1.1B's widths at a cut depth, RTN W4 g128 fused, random weights
from seed 0, on the CPU: two gloo processes run the TP 2 forward of a
[2, 64] batch; rank 0 also runs the one-rank forward and the same packed
weights dequantized to an f32 twin. Prints the relative errors of the
logits (Frobenius): TP against one rank, one rank against f32, TP against
f32. Equal errors against f32 mean the TP path is no less accurate and the
two bf16 runs differ by their own rounding noise.

    python3 tools/exp_tp_noise.py 4 8      # the depths to run (~25 s a depth)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _work(rank, world, layers):
    import torch

    from qtpu_torch.core.packing import dequantize_parts
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.specs import shard_model

    torch.set_num_threads(4)
    cfg = TINYLLAMA_1_1B.replace(num_layers=layers)
    packed, qmeta = pack_model(llama.init_params(cfg, seed=0, device="cpu"), "rtn",
                               {"w_bit": 4, "q_group_size": 128})

    def dense(p):
        return {"w": torch.stack([dequantize_parts(p["data"][l], p["scales"][l], p["zeros"][l],
                                                   4, 128) for l in range(p["data"].shape[0])])}

    twin = {"embed": packed["embed"].float(), "final_norm": packed["final_norm"].float(),
            "lm_head": {"w": dequantize_parts(*(packed["lm_head"][k] for k in
                                                ("data", "scales", "zeros")), 4, 128)},
            "layers": {s: dense(p) if isinstance(p, dict) else p.float()
                       for s, p in packed["layers"].items()}}
    fused, fq = fuse_packed_sites(packed, qmeta)
    mesh = make_mesh(data=1, model=world)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    lp, lq, lc = shard_model(fused, fq, cfg, mesh)
    tp = llama.forward(lp, ids, lc, qmeta=lq, tp=local_group(mesh, "model"))
    if rank == 0:
        one = llama.forward(fused, ids, cfg, qmeta=fq)
        f32 = llama.forward(twin, ids, cfg)
        print(f"layers {layers}: tp-vs-one-rank {_rel(tp, one):.4f} "
              f"one-rank-vs-f32 {_rel(one, f32):.4f} tp-vs-f32 {_rel(tp, f32):.4f}", flush=True)


def main() -> int:
    from qtpu_torch.sharding.multihost import spawn

    for layers in [int(a) for a in sys.argv[1:]] or [4]:
        spawn(_work, 2, (layers,), init_file=os.path.join(tempfile.mkdtemp(), "init"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
