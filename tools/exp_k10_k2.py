#!/usr/bin/env python3
"""What sets the time of K10's tensor-core body and of K2's programmatic
launch on the card: the same entries at forced settings.

  k10   Mixtral-8x7B's gate/up and down expert sites, W4 g128, at the
        2-slot engine's 4 routed slots (1, 6, 3, 6: 3 distinct experts) and
        at 4 distinct experts (1, 6, 3, 7): moe_gathered_tc_kernel at every
        cluster size that splits K into non-empty slices of whole groups
        with x's slice at most 4096 values (the C entry takes the cluster
        and the slice), beside the wrapper's own split (gemv_tc_split) and
        dq_core's body (moe_gathered_matmul_simt), each with the bound of
        the distinct experts' bytes;
  k2    chip_smoke.py's K2 times (22 launches in a graph, with and without
        the programmatic attribute, and the earlier kernel; the order of a
        W4 decode step, K1 qkv, RoPE, K2, K3 on TinyLlama-1.1B's 22 layers,
        with and without it) repeated REPEATS times, for their spread.

    python3 tools/exp_k10_k2.py [k10] [k2]   # on a machine with an H100

Per-call µs from CUDA events around a CUDA graph of calls, enough of them
to exceed the 50 MB L2 (chip_smoke.cuda_ms). One JSON line per case, with
nvidia-smi's name and power limit. Imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SITES = {"gate_up": (4096, 14336), "down": (14336, 4096)}
SLOTS = {"3_distinct": (1, 6, 3, 6), "4_distinct": (1, 6, 3, 7)}
GROUP = 128
REPEATS = 3


def k10(torch, smi):
    from qtpu_torch.kernels import _build
    from qtpu_torch.kernels import moe_matmul as k9
    from qtpu_torch.kernels.dequant_matmul import GEMV_TC_X_CAP, gemv_tc_split

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    lib = _build.load("moe_matmul", k9._SIG)
    for name, (K, N) in SITES.items():
        site = cs._expert_site(torch, gen, dev, 8, K, N)
        meta = (4, GROUP, K, N)
        groups = K // GROUP
        for tag, slots in SLOTS.items():
            Gs, distinct = len(slots), len(set(slots))
            eidx = torch.tensor(slots, dtype=torch.int32, device=dev)
            x = torch.randn(Gs, K, generator=gen, device=dev).to(torch.bfloat16)
            out = torch.empty(Gs, N, dtype=torch.bfloat16, device=dev)
            wbytes = distinct * (K * N / 2 + groups * N * 3)
            bound_ms, _ = cs.bound(wbytes + Gs * (K + N) * 2 + Gs * 4, 2 * Gs * K * N)
            want = k9.moe_gathered_matmul_plain(x, eidx, *site, meta)

            def call(c, per):
                rc = lib.qtpu_moe_gathered(
                    x.data_ptr(), eidx.data_ptr(), site[0].data_ptr(), site[1].data_ptr(),
                    site[2].data_ptr(), out.data_ptr(), None, per, c, 8, Gs, K, N, 4, GROUP,
                    _build.stream_of(x))
                if rc != 0:
                    raise RuntimeError(f"qtpu_moe_gathered returned {rc} at cluster {c}")

            rule = gemv_tc_split(dev, K, N, GROUP, tiles=-(-N // 128) * Gs)
            row = {"exp": "k10", "site": name, "K": K, "N": N, "slots": list(slots),
                   "bound_us": bound_ms * 1e3, "rule": list(rule), "card": smi, "clusters": {}}
            for c in range(1, 9):
                per = -(-groups // c)
                if per * (c - 1) >= groups or per * GROUP > GEMV_TC_X_CAP:
                    continue
                call(c, per)
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max()
                            / (want.float().abs().max() + 1e-6))
                if err >= 2e-2:
                    raise AssertionError(f"K10 at cluster {c}: {err}")
                ms, _ = cs.cuda_ms(torch, [lambda c=c, per=per: call(c, per)], wbytes)
                row["clusters"][c] = ms * 1e3
            ms, _ = cs.cuda_ms(torch, [lambda: k9.moe_gathered_matmul_simt(x, eidx, *site, meta)],
                               wbytes)
            row["simt_us"] = ms * 1e3
            print(json.dumps(row), flush=True)
        del site


def k2(torch, smi):
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    L, B, KV, S, hd = cfg.num_layers, 8, cfg.num_kv_heads, 176, cfg.head_dim
    cache = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
             for _ in range(2)]
    cache += [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01 for _ in range(2)]
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    for r in range(REPEATS):
        t = cs._k2_times(torch, gen, dev, cfg, kn, vn, cache, pos)
        launch_us = {k: t[k] * 1e3 for k in ("ms", "serial_ms", "was_ms")}
        step_ms = {k: t[k] for k in ("step_ms_pdl", "step_ms_serial")}
        print(json.dumps({"exp": "k2", "repeat": r, "launch_us": launch_us, "step_ms": step_ms,
                          "card": smi}), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_k10_k2: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    which = argv or ["k10", "k2"]
    if "k10" in which:
        k10(torch, smi)
    if "k2" in which:
        k2(torch, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
