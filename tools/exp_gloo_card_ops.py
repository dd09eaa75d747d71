#!/usr/bin/env python3
"""Which torch.distributed ops the gloo backend runs on card tensors.

Two processes share card 0 in one gloo world (as chip_smoke.py's shard
phase runs them: NCCL refuses two ranks on one card) and try each op the
sharded paths use on bf16 and f32 CUDA tensors directly, without staging
through host memory, checking the result. The answer decides
qtpu_torch.sharding.collectives.GLOO_CARD_OPS (the ops left unstaged).

    python3 tools/exp_gloo_card_ops.py      # prints one JSON line per rank
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


OPS = [f"{op}_{dt}" for dt in ("bfloat16", "float32")
       for op in ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather", "send_recv",
                  "batch_isend_irecv")]


def _probe(rank, world, out_dir, ops):
    """Try `ops` in turn; each rank writes the op it starts and what it
    got, so an op that kills the process (gloo's TCP transport writing from
    a card pointer aborts) is named by the last line started."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "a")

    def t(v, dt):
        return torch.full((1024,), float(v), dtype=dt, device=dev)

    def all_reduce_sum(dt):
        """At the sizes the sharded paths reduce (a decode step's [8, 2048]
        up to a prefill's [8, 128, 2048]), each element its own value."""
        ok = True
        for n in (1024, 8192, 16384, 32768, 131072, 2097152):
            base = torch.arange(n, device=dev).remainder(64).to(dt)
            x = base * (rank + 1)
            dist.all_reduce(x)
            ok &= bool((x.float() == (base.float() * 3)).all())
        return ok

    def all_reduce_max(dt):
        x = t(rank + 1, dt)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool((x == 2).all())

    def broadcast(dt):
        x = t(rank + 5, dt)
        dist.broadcast(x, src=1)
        return bool((x == 6).all())

    def all_gather(dt):
        parts = [t(0, dt) for _ in range(world)]
        dist.all_gather(parts, t(rank + 1, dt))
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def send_recv(dt):
        if rank == 0:
            dist.send(t(7, dt), dst=1)
            return True
        x = t(0, dt)
        dist.recv(x, src=0)
        return bool((x == 7).all())

    def batch_isend_irecv(dt):
        s, r = t(rank + 1, dt), t(0, dt)
        ops_ = [dist.P2POp(dist.isend, s, (rank + 1) % world),
                dist.P2POp(dist.irecv, r, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops_):
            w.wait()
        return bool((r == (rank - 1) % world + 1).all())

    fns = {f.__name__: f for f in (all_reduce_sum, all_reduce_max, broadcast, all_gather,
                                    send_recv, batch_isend_irecv)}
    for name in ops:
        op, dt = name.rsplit("_", 1)
        log.write(json.dumps({"start": name}) + "\n")
        log.flush()
        try:
            ok = fns[op](getattr(torch, dt))
            torch.cuda.synchronize()
            got = "ok" if ok else "wrong result"
        except Exception as e:  # a refusal that raises: the probe's answer
            got = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        log.write(json.dumps({"done": name, "result": got}) + "\n")
        log.flush()
        dist.barrier()


def main() -> int:
    import torch

    from qtpu_torch.sharding.multihost import spawn

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    results, left, worlds = {}, list(OPS), 0
    while left and worlds < len(OPS):  # a new world after each op that kills one
        d = tempfile.mkdtemp()
        worlds += 1
        try:
            spawn(_probe, 2, (d, left), init_file=os.path.join(d, "init"), device="cuda",
                  timeout_s=60)
        except Exception as e:
            print(f"world {worlds} ended: {type(e).__name__}", file=sys.stderr)
        for r in range(2):
            p = os.path.join(d, f"rank{r}.log")
            for line in (open(p).read().splitlines() if os.path.exists(p) else []):
                ev = json.loads(line)
                if "done" in ev:
                    results.setdefault(ev["done"], {})[r] = ev["result"]
                else:
                    results.setdefault(ev["start"], {}).setdefault(r, "process died")
        left = [op for op in left if op not in results]
    print(json.dumps({"gloo_card_ops": results, "worlds": worlds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
