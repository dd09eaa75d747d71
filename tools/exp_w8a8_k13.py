#!/usr/bin/env python3
"""What sets the time of K6's tensor-core decode GEMV and of K13's
tensor-core phases on the card: the same entries at forced settings.

  k6    TinyLlama-1.1B's five W8A8 sites at M 8: w8a8_gemv_tc_kernel at every
        cluster size that splits K into non-empty slices of whole 32-row
        steps (the C entry takes the cluster and the slice), built with a
        per-lane ring of 3, 4 and 5 steps (kW8TcRing), beside the wrapper's
        own split (w8a8_gemv_split) and the dp4a body;
  k13   one TinyLlama-1.1B layer, W4 g128, M 1, 8 and 32: the kernel at the
        wrapper's plan and at plans with fewer K slices in the o and down
        phases (the row phases after them add each slice's partials), built
        with slices of at most 512, 1024 and 2048 K values (kTcSlice) and
        with 4 blocks an SM in its launch bounds in place of 3 (slices of
        at most 1024); beside it the dq_core tiles (layer_boundary_dq) at
        their 2 blocks an SM and at 1;
  anatomy  copies with a part of the work taken out, timed the same way
        (ANATOMY: K6 without its mma, without its whole step, without the
        quantization prologue, and with the warps' steps interleaved in
        place of contiguous; K13 without its row phases, without its grid
        barriers, without both).

    python3 tools/exp_w8a8_k13.py [k6] [k13]   # on a machine with an H100

Variants are copies of the sources with one constant changed, built with
nvcc into build/exp/; per-call µs from CUDA events around a CUDA graph of
calls on enough weight copies to exceed the 50 MB L2 (chip_smoke.cuda_ms).
One JSON line per case, with nvidia-smi's name and power limit. Imports
nothing of JAX or qtpu.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import L2_BYTES, cuda_ms, nvidia_smi_line  # noqa: E402
from qtpu_torch.core.packing import quantize_pack  # noqa: E402
from qtpu_torch.kernels import _build  # noqa: E402
from qtpu_torch.kernels import int8_matmul as k6  # noqa: E402
from qtpu_torch.kernels import layer_boundary as k13  # noqa: E402
from qtpu_torch.models.config import TINYLLAMA_1_1B as CFG  # noqa: E402

EXP = ROOT / "build" / "exp"
K6_SITES = {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632),
            "down": (5632, 2048), "lm_head": (2048, 32000)}
# (source, constant's pattern, values): each value a library of its own
VARIANTS = {
    "w8a8_matmul": (r"constexpr int kW8TcRing = \d+;", "constexpr int kW8TcRing = {};",
                    (3, 4, 5)),
    "layer_boundary": (r"constexpr int kTcSlice = \d+;", "constexpr int kTcSlice = {};",
                       (512, 1024, 2048)),
}
LB_MIN4 = ("kMinBlocks = TC ? 3 : 2;", "kMinBlocks = TC ? 4 : 2;")
LB_DQ_MIN1 = ("kMinBlocks = TC ? 3 : 2;", "kMinBlocks = TC ? 3 : 1;")
NOROW = [(f"  __shared__ float {a};", f"  __shared__ float {a};\n  if (N > 0) return;")
         for a in ("red[T / 32]", "inv[32]")]
# copies with a part of the work taken out, for timing only (their outputs
# are not the kernel's): K6 without the mma (the byte_perms kept), without
# the whole step (the ring's loads kept); K13 without its row phases,
# without its grid barriers, without both
ANATOMY = {
    ("w8a8_matmul", "nomma"): [(
        "    mma_s8(acc[i], af, bf);",
        "    acc[i][0] ^= (int)(af[0] + af[1] + bf[0]);\n"
        "    acc[i][1] ^= (int)(af[2] + af[3] + bf[1]);")],
    ("w8a8_matmul", "nostep"): [(
        "    w8tc_step(w, b.x, b.y, acc);",
        "    { uint32_t v = b.x ^ b.y;\n"
        "      for (int r = 0; r < 8; ++r) v ^= w[r].x ^ w[r].y ^ w[r].z ^ w[r].w;\n"
        "      acc[0][0] ^= (int)v; }")],
    ("w8a8_matmul", "interleave"): [
        ("  const int ws = min(nsteps, warp * per);\n  const int we = min(nsteps, ws + per);",
         "  const int ws = 0;\n"
         "  const int we = max(0, (nsteps - warp + kTcWarps - 1) / kTcWarps);"),
        ("(size_t)(kbase + kW8TcK * s + 8 * lt)",
         "(size_t)(kbase + kW8TcK * (warp + kTcWarps * s) + 8 * lt)"),
        ("xrow + kW8TcK * s)", "xrow + kW8TcK * (warp + kTcWarps * s))")],
    ("w8a8_matmul", "noquant"): [
        ("  // ---- sx: the rows' absmax over the slice, then over the cluster",
         "  // ---- the warp's steps", "  cl.sync();\n  __syncthreads();\n\n")],
    ("layer_boundary", "norow"): NOROW,
    ("layer_boundary", "nosync"): [("grid.sync();", "(void)grid;")],
    ("layer_boundary", "tilesonly"): NOROW + [("grid.sync();", "(void)grid;")],
}


def build_variants():
    """{(source, tag): ctypes library}, every variant compiled at once."""
    EXP.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (pat, rep, values) in VARIANTS.items():
        src = (ROOT / "qtpu_torch" / "csrc" / f"{name}.cu").read_text()
        for v in values:
            jobs[(name, str(v))] = re.sub(pat, rep.format(v), src)
        if name == "layer_boundary":
            jobs[(name, "min4")] = src.replace(*LB_MIN4)
            jobs[(name, "dqmin1")] = src.replace(*LB_DQ_MIN1)
        for (n, tag), edits in ANATOMY.items():
            if n == name:
                text = src
                for edit in edits:  # (old, new), or (from, up to, new) for a region
                    old, new = edit[0], edit[-1]
                    if old not in text:
                        raise RuntimeError(f"{n} {tag}: {old!r} not in the source")
                    if len(edit) == 3:
                        a = text.index(old)
                        text = text[:a] + new + text[text.index(edit[1], a):]
                    else:
                        text = text.replace(old, new)
                jobs[(name, tag)] = text
    procs = {}
    for (name, tag), text in jobs.items():
        cu = EXP / f"{name}_{tag}.cu"
        cu.write_text(text)
        so = EXP / f"lib{name}_{tag}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(ROOT / "qtpu_torch" / "csrc"),
               "-o", str(so), str(cu)]
        procs[(name, tag)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{out}")
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"built": key, "ptxas_tail": regs[-4:]}), flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in {**k6._SIG, **k13._SIG}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def _with_lib(name, lib, fn):
    """fn() with _build.load returning `lib` for `name`."""
    load = _build.load
    _build.load = lambda n, sig: lib if n == name else load(n, sig)
    try:
        return fn()
    finally:
        _build.load = load


def k6_cases(libs, smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for site, (K, N) in K6_SITES.items():
        meta = (8, K, K, N)
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / (K * N))))
        qts = [quantize_pack(torch.randn(K, N, generator=gen, device="cuda") * 0.02, 8, K)
               for _ in range(copies)]
        x = (torch.randn(8, K, generator=gen, device="cuda") * 2).to(torch.bfloat16)
        want = k6.w8a8_matmul_dp4a(x, qts[0].data, qts[0].scales, qts[0].zeros, meta)
        row = {"site": site, "K": K, "N": N, "rule": k6.w8a8_gemv_split(sms, N, K),
               "card": smi}
        row["dp4a_us"] = 1e3 * cuda_ms(torch, [lambda q=q: k6.w8a8_matmul_dp4a(
            x, q.data, q.scales, q.zeros, meta) for q in qts], K * N)[0]
        steps = K // 32
        split = k6.w8a8_gemv_split
        for ring in VARIANTS["w8a8_matmul"][2]:
            lib = libs[("w8a8_matmul", str(ring))]
            for c in range(1, 9):
                per = -(-steps // c)
                if per * (c - 1) >= steps or per * 32 > 4096:
                    continue
                k6.w8a8_gemv_split = lambda s, n, kk, c=c, per=per: (c, per * 32)
                try:
                    got = _with_lib("w8a8_matmul", lib, lambda: k6.w8a8_matmul(
                        x, qts[0].data, qts[0].scales, qts[0].zeros, meta))
                    if not bool((got.view(torch.int16) == want.view(torch.int16)).all()):
                        raise AssertionError(f"{site} ring {ring} cluster {c}: bits differ")
                    us = 1e3 * _with_lib("w8a8_matmul", lib, lambda: cuda_ms(
                        torch, [lambda q=q: k6.w8a8_matmul(x, q.data, q.scales, q.zeros, meta)
                                for q in qts], K * N)[0])
                finally:
                    k6.w8a8_gemv_split = split
                row[f"ring{ring}_c{c}_us"] = us
        for tag in ("nomma", "nostep", "interleave", "noquant"):
            lib = libs[("w8a8_matmul", tag)]
            for c in (1, 2, 8):
                per = -(-steps // c)
                if per * (c - 1) >= steps or per * 32 > 4096:
                    continue
                k6.w8a8_gemv_split = lambda s, n, kk, c=c, per=per: (c, per * 32)
                try:
                    us = 1e3 * _with_lib("w8a8_matmul", lib, lambda: cuda_ms(
                        torch, [lambda q=q: k6.w8a8_matmul(x, q.data, q.scales, q.zeros, meta)
                                for q in qts], K * N)[0])
                finally:
                    k6.w8a8_gemv_split = split
                row[f"{tag}_c{c}_us"] = us
        print(json.dumps(row), flush=True)
        del qts


def _layer(gen, bits, group, copies):
    D, F, Q = CFG.hidden_size, CFG.intermediate_size, CFG.q_dim
    shapes = ((Q, D), (D, 2 * F), (F, D), (D, Q + 2 * CFG.kv_dim))
    stacks = []
    for K, N in shapes:
        parts = [quantize_pack(torch.randn(K, N, generator=gen, device="cuda") * 0.02, bits,
                               group) for _ in range(copies + 1)]
        stacks.append({k: torch.stack([getattr(p, k) for p in parts])
                       for k in ("data", "scales", "zeros")})
    metas = tuple((bits, group, K, N) for K, N in shapes)
    return stacks, metas


def k13_cases(libs, smi):
    gen = torch.Generator(device="cuda").manual_seed(1)
    copies = 3
    stacks, metas = _layer(gen, 4, 128, copies)
    D, Q = CFG.hidden_size, CFG.q_dim
    mn = torch.ones(D, dtype=torch.bfloat16, device="cuda")

    def views(i):
        return [{k: v[i] for k, v in s.items()} for s in stacks[:3]] + \
               [{k: v[i + 1] for k, v in stacks[3].items()}]

    plan, grid = k13.plan, k13._grid
    for M in (1, 8, 32):
        attn = torch.randn(M, Q, generator=gen, device="cuda").to(torch.bfloat16)
        x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
        want = k13.layer_boundary_plain(attn, x, mn, mn, *views(0), metas)

        def timed():
            y2, qkv = k13.layer_boundary(attn, x, mn, mn, *views(0), metas)
            err = max(float(torch.linalg.vector_norm(a.float() - b.float())
                            / torch.linalg.vector_norm(b.float())) for a, b in
                      ((y2.float() - x.float(), want[0].float() - x.float()), (qkv, want[1])))
            us = 1e3 * cuda_ms(torch, [lambda i=i: k13.layer_boundary(
                attn, x, mn, mn, *views(i), metas) for i in range(copies)], 23e6)[0]
            return us, err

        def timed_only():
            return 1e3 * cuda_ms(torch, [lambda i=i: k13.layer_boundary(
                attn, x, mn, mn, *views(i), metas) for i in range(copies)], 23e6)[0]

        def dq_us():
            return 1e3 * cuda_ms(torch, [lambda i=i: k13.layer_boundary_dq(
                attn, x, mn, mn, *views(i), metas) for i in range(copies)], 23e6)[0]

        row = {"M": M, "card": smi, "dq_us": dq_us()}
        k13._grid.cache_clear()
        row["dq_min1_us"] = _with_lib("layer_boundary", libs[("layer_boundary", "dqmin1")],
                                      dq_us)
        k13._grid.cache_clear()
        for tag in ("512", "1024", "2048", "min4", "norow", "nosync", "tilesonly"):
            lib = libs[("layer_boundary", tag)]
            cap = int(tag) if tag.isdigit() else 1024
            k13.TC_SLICE = cap
            k13._grid.cache_clear()
            blocks = _with_lib("layer_boundary", lib, lambda: grid(0, 4, 128, True))
            base = plan(metas, M, blocks, True)
            forced = {"plan": base}
            if tag == "1024":  # o: 16 groups of 128; down: 44
                for per_o in (8, 4, 2, 1):
                    for per_d in (8, 4, 2):
                        forced[f"o{16 // per_o}_d{-(-44 // per_d)}"] = (
                            (per_o, 16 // per_o), base[1], (per_d, -(-44 // per_d)), base[3])
            for name, p in forced.items():
                k13.plan = lambda *a, p=p: p
                try:
                    us, err = _with_lib("layer_boundary", lib, timed if tag.isdigit() or
                                        tag == "min4" else lambda: (timed_only(), None))
                finally:
                    k13.plan = plan
                row[f"slice{tag}_{name}"] = {"us": us, "rel_err": err, "blocks": blocks,
                                             "plan": p}
            k13._grid.cache_clear()
        k13.TC_SLICE = 1024
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    only = (argv if argv is not None else sys.argv[1:]) or ["k6", "k13"]
    if not torch.cuda.is_available():
        print("exp_w8a8_k13: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    _build.build(("w8a8_matmul", "layer_boundary"))
    libs = build_variants()
    if "k6" in only:
        k6_cases(libs, smi)
    if "k13" in only:
        k13_cases(libs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
