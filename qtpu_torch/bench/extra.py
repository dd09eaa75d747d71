"""Serving measurements beyond the bench's perplexity run (port of qtpu's
bench_extra.py):

    python -m qtpu_torch.bench.extra --out PATH [--device cuda] [--tiny]

writes to PATH (and prints after each measurement) qtpu's keys, computed as
qtpu computes them:
  - llama2_7b_w4_decode_tokens_per_s: Llama-2-7B W4 g128, B 8, prompt 128
  - tinyllama_w4_prefill_tokens_per_s_s2048 (B 2) and _s8192 (B 1): the
    packed forward (K1 on every linear, K5), S past TinyLlama's max_seq_len
    as in qtpu
  - tinyllama_w4_decode_tokens_per_s_s16k_cache: B 4, the prompt written at
    16000 into a per-layer cache of S 16384, so every step attends over the
    whole window (K12); the skipped rows hold zeros, which cost the kernel
    the same bytes as real history
  - tinyllama_w8_decode_tokens_per_s_staged and
    tinyllama_w8a8_decode_tokens_per_s: W8 weight-only against W8A8 (K6 with
    per-token int8 activations) on the same shapes, B 8. qtpu ran both under
    QTPU_DECODE_DELIVERY=staged, a TPU workaround for its scalar-prefetch
    weight delivery; the port has one weight delivery (W[l] views), so the
    key keeps qtpu's name and the switch is not copied
  - tinyllama_w4_decode_tokens_per_s_b32: B 32
  - batcher_*: a ContinuousBatcher (12 slots, max_seq_len 512, int8 cache,
    decode_block 16, prefill_chunk 384) answering 24 requests of 16-383
    prompt tokens and 64 new ones: cold (the first engine: kernel builds
    and CUDA graph captures at first use inside the time) and warm (a fresh
    engine after warmup(), its graphs captured before the time)
  - moe_8x1b_w4_decode_tokens_per_s[_b1|_b2|_b1_dense]: an 8-expert top-2
    MoE at TinyLlama's widths, B 8 (grouped route, K9), B 1 and 2
    (gathered, K10) and B 1 with QTPU_MOE_GATHERED=0 (grouped)

Decode rates use qtpu's estimator: B over the time of a decode block of
`block` steps, from the difference of a run of n_large blocks and one of
n_small (each a prefill and its blocks, ended by a host read of the last
tokens). On the card a block is one CUDA graph of `block` decode steps
replayed, as the serving engine replays it; on the CPU the steps run
eagerly. Weights are one random layer a site tiled over the layers
(qtpu_torch.bench.synth). Keys already in PATH are kept and not measured
again (qtpu's resume). --tiny runs the tiny configs at small shapes, for a
CPU check of the code; Plan.quick() gives the estimator's fewest blocks
(n_small 1, n_large 2; prefill 2 forwards against 1), which chip_smoke.py
runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _decode_block_fn(packed, qmeta, cfg, cache, tok, pos, block, arch):
    """One decode block on static tok / pos [B] (advanced in place): the
    greedy tokens [B, block]."""
    from qtpu_torch.serve.decode import decode_multi

    def fn():
        toks, _ = decode_multi(packed, tok, pos, cache, None, None, cfg, block, qmeta, arch=arch)
        tok.copy_(toks[:, -1])
        pos.add_(block)
        return toks

    return fn


def decode_tps(packed, qmeta, cfg, B, P, n_small, n_large, block=25, arch="llama",
               cache_pad=0, per_layer=False, device="cuda", record=None):
    """Tokens/s through the serving decode path (qtpu's decode_tps):
    decode blocks of `block` steps after a prefill of a [B, P] prompt.

    cache_pad > 0 sizes the cache cache_pad positions larger and writes the
    prompt at that offset, so decode attends over the whole cache_pad + P
    window each step (long-context decode without prefilling cache_pad real
    tokens). per_layer: the per-layer cache, S rounded up to 2048 (K12's
    tile). record: a dict that receives the prompt, the prefill's token, the
    first block's tokens of the last run and the cache's shape."""
    from qtpu_torch.serve.decode import prefill
    from qtpu_torch.serve.graphs import capture
    from qtpu_torch.serve.kvcache import init_cache

    dev = torch.device(device)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))).to(torch.int32).to(dev)
    start = torch.full((B,), cache_pad, dtype=torch.int32, device=dev) if cache_pad else None
    S = cache_pad + P + n_large * block + 8
    if per_layer:  # K12 blocks the cache's S axis in 2048-row tiles
        S += (-S) % 2048
    cache = init_cache(cfg, B, S, quantized=True, device=dev, per_layer=per_layer)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    step = _decode_block_fn(packed, qmeta, cfg, cache, tok, pos, block, arch)
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)  # load the kernels outside the capture
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = capture(step, None)
        step = graph.replay

    def reset():  # an empty cache for each run, as qtpu's init_cache in run()
        for c in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            for t in (c if per_layer else (c,)):
                t.zero_()
        cache.length.zero_()

    def run(n_blocks):
        reset()
        _sync(dev)
        t0 = time.perf_counter()
        logits, _ = prefill(packed, prompt, cache, cfg, qmeta, start=start, arch=arch)
        tok.copy_(torch.argmax(logits, -1).to(torch.int32))
        pos.fill_(cache_pad + P)
        first, tok0 = None, tok.clone() if record is not None else None
        for i in range(n_blocks):
            toks = step()
            if i == 0 and record is not None:
                first = toks.clone()
        int(tok.sum())  # the host read that ends the run, as qtpu's
        dt = time.perf_counter() - t0
        if record is not None:
            record.update(prompt=prompt, prefill_token=tok0, first_block=first, S=S,
                          cache_pad=cache_pad, per_layer=per_layer, arch=arch)
        return dt

    run(n_small)
    t = (run(n_large) - run(n_small)) / ((n_large - n_small) * block)
    return B / max(t, 1e-9)


def prefill_tps(packed, qmeta, cfg, B, S, iters=6, device="cuda", arch="llama", record=None):
    """Tokens/s of the packed forward on [B, S] (qtpu's prefill_tps): a chain
    of forwards, each fed the argmax of the last, timed at iters + 1 against
    1. record: a dict that receives the ids and the first forward's argmax."""
    from qtpu_torch.models import get_arch

    forward = get_arch(arch).forward
    dev = torch.device(device)
    ids0 = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))).to(torch.int32).to(dev)

    def run(n):
        ids = ids0
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(n):
            ids = torch.argmax(forward(packed, ids, cfg, qmeta=qmeta), -1).to(torch.int32)
            if i == 0 and record is not None:
                record.update(ids=ids0, argmax=ids)
        int(ids.sum())
        return time.perf_counter() - t0

    run(1)
    t = (run(iters + 1) - run(1)) / iters
    return B * S / max(t, 1e-9)


def batcher_load(packed, qmeta, cfg, plan, device="cuda", record=None):
    """qtpu's engine-level load: the batcher answering plan.requests requests
    (prompt lengths drawn in [plan.prompt_lo, plan.prompt_hi), the same
    sequence each load), cold and warm. Returns the batcher_* keys. record:
    a dict that receives both engines' finished requests."""
    from qtpu_torch.serve.batching import ContinuousBatcher

    def load(eng):
        rng = np.random.default_rng(0)
        for _ in range(plan.requests):
            plen = int(rng.integers(plan.prompt_lo, plan.prompt_hi))
            eng.submit(rng.integers(0, cfg.vocab_size, (plen,), dtype=np.int64),
                       max_new_tokens=plan.new_tokens)

    def fresh():
        return ContinuousBatcher(packed, cfg, qmeta=qmeta, max_batch=plan.max_batch,
                                 max_seq_len=plan.max_seq_len, kv_dtype="int8",
                                 decode_block=16, prefill_chunk=plan.prefill_chunk,
                                 device=device)

    cold = fresh()
    t0 = time.perf_counter()
    load(cold)
    cold.run()
    cold_dt = time.perf_counter() - t0
    eng = fresh()
    eng.warmup()
    load(eng)
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    m, mc = eng.metrics(), cold.metrics()
    if record is not None:
        record.update(warm=eng.finished, cold=cold.finished)
    return {"batcher_tokens_per_s": round(m["total_tokens"] / dt, 1),
            "batcher_mean_ttft_warm_s": round(m["mean_ttft_s"], 4),
            "batcher_mean_ttft_cold_s": round(mc["mean_ttft_s"], 4),
            "batcher_tokens_per_s_cold": round(mc["total_tokens"] / cold_dt, 1),
            "batcher_requests": m["requests"]}


MOE_8X1B = {"arch": "moe", "vocab_size": 32000, "hidden_size": 2048, "intermediate_size": 5632,
            "num_layers": 22, "num_heads": 32, "num_kv_heads": 4, "head_dim": 64,
            "max_seq_len": 2048, "num_experts": 8, "num_experts_per_tok": 2}


@dataclasses.dataclass
class Plan:
    """The shapes and step counts of every measurement: qtpu's by default."""

    cfg_7b: str = "llama2-7b"
    cfg: str = "tinyllama"
    moe: dict = dataclasses.field(default_factory=lambda: dict(MOE_8X1B))
    P: int = 128
    B_7b: int = 8
    prefill: tuple = ((2, 2048, 6), (1, 8192, 3))  # (B, S, iters)
    long_B: int = 4
    cache_pad: int = 16384 - 384
    B_w8: int = 8
    B_b32: int = 32
    B_moe: int = 8
    block: int = 25
    n_small: int = 1
    n_large: dict = dataclasses.field(default_factory=lambda: {
        "7b": 5, "s16k": 5, "w8": 4, "b32": 6, "moe": 3})
    max_batch: int = 12
    max_seq_len: int = 512
    prefill_chunk: int = 384
    requests: int = 24
    prompt_lo: int = 16
    prompt_hi: int = 384
    new_tokens: int = 64

    def quick(self) -> "Plan":
        """The fewest blocks the estimator takes: n_large 2, prefill iters 1."""
        return dataclasses.replace(
            self, n_large={k: 2 for k in self.n_large},
            prefill=tuple((B, S, 1) for B, S, _ in self.prefill))

    @classmethod
    def tiny(cls) -> "Plan":
        """The tiny configs at small shapes (a CPU check of the code)."""
        from qtpu_torch.models.config import TINY_MOE_TEST

        return cls(cfg_7b="tiny-test", cfg="tiny-test",
                   moe=dataclasses.asdict(TINY_MOE_TEST), P=16, B_7b=2,
                   prefill=((2, 64, 1), (1, 128, 1)), long_B=2, cache_pad=1024, B_w8=2,
                   B_b32=4, B_moe=4, block=2, n_large={k: 2 for k in cls().n_large},
                   max_batch=4, max_seq_len=128, prefill_chunk=64, requests=6, prompt_lo=16,
                   prompt_hi=64, new_tokens=8)


def measurements(plan: Plan, device="cuda", records=None):
    """[(keys, thunk)] in qtpu's order; thunk() -> {key: value}. Models are
    built when a thunk first needs them and dropped when another is built.
    records: a dict that receives, per decode key, decode_tps's record
    (prompt, prefill token, first block) and the (packed, qmeta) it ran."""
    from qtpu_torch.bench.synth import tiled_packed_llama, tiled_packed_moe, tiled_w8a8_llama
    from qtpu_torch.models.config import ModelConfig, get_model_config

    cfg7, cfg = get_model_config(plan.cfg_7b), get_model_config(plan.cfg)
    mcfg = ModelConfig(**plan.moe)
    models = {}

    def model(name):
        if name not in models:
            make = {"7b": lambda: tiled_packed_llama(cfg7, 4, 128, device=device),
                    "w4": lambda: tiled_packed_llama(cfg, 4, 128, device=device),
                    "w8": lambda: tiled_packed_llama(cfg, 8, 128, device=device),
                    "w8a8": lambda: tiled_w8a8_llama(cfg, device=device),
                    "moe": lambda: tiled_packed_moe(mcfg, 4, 128, device=device)}[name]
            models.clear()  # one model on the card at a time
            models[name] = make()
        return models[name]

    def dec(key, name, c, B, n, **kw):
        rec = None
        if records is not None:
            rec = records[key] = {"model": model(name), "cfg": c, "B": B, "kw": kw}
        return {key: round(decode_tps(*model(name), c, B=B, P=plan.P, n_small=plan.n_small,
                                      n_large=plan.n_large[n], block=plan.block, device=device,
                                      record=rec, **kw), 1)}

    def moe(key, B, gathered):
        os.environ["QTPU_MOE_GATHERED"] = gathered
        try:
            return dec(key, "moe", mcfg, B, "moe", arch="moe")
        finally:
            os.environ.pop("QTPU_MOE_GATHERED", None)

    def prefill(key, B, S, iters):
        return {key: round(prefill_tps(*model("w4"), cfg, B, S, iters, device=device), 1)}

    (B2, S2, i2), (B8, S8, i8) = plan.prefill
    w8 = ("tinyllama_w8_decode_tokens_per_s_staged", "tinyllama_w8a8_decode_tokens_per_s")
    moe_keys = [f"moe_8x1b_w4_decode_tokens_per_s{s}" for s in ("", "_b1", "_b2", "_b1_dense")]
    return [
        (("llama2_7b_w4_decode_tokens_per_s",),
         lambda k="llama2_7b_w4_decode_tokens_per_s": dec(k, "7b", cfg7, plan.B_7b, "7b")),
        (("tinyllama_w4_prefill_tokens_per_s_s2048",),
         lambda: prefill("tinyllama_w4_prefill_tokens_per_s_s2048", B2, S2, i2)),
        (("tinyllama_w4_prefill_tokens_per_s_s8192",),
         lambda: prefill("tinyllama_w4_prefill_tokens_per_s_s8192", B8, S8, i8)),
        (("tinyllama_w4_decode_tokens_per_s_s16k_cache",),
         lambda k="tinyllama_w4_decode_tokens_per_s_s16k_cache": dec(
             k, "w4", cfg, plan.long_B, "s16k", cache_pad=plan.cache_pad, per_layer=True)),
        (w8, lambda: {**dec(w8[0], "w8", cfg, plan.B_w8, "w8"),
                      **dec(w8[1], "w8a8", cfg, plan.B_w8, "w8")}),
        (("tinyllama_w4_decode_tokens_per_s_b32",),
         lambda k="tinyllama_w4_decode_tokens_per_s_b32": dec(k, "w4", cfg, plan.B_b32, "b32")),
        (("batcher_tokens_per_s", "batcher_mean_ttft_warm_s", "batcher_mean_ttft_cold_s",
          "batcher_tokens_per_s_cold", "batcher_requests"),
         lambda: batcher_load(*model("w4"), cfg, plan, device)),
        ((moe_keys[0],), lambda: moe(moe_keys[0], plan.B_moe, "1")),
        ((moe_keys[1],), lambda: moe(moe_keys[1], 1, "1")),
        ((moe_keys[2],), lambda: moe(moe_keys[2], 2, "1")),
        ((moe_keys[3],), lambda: moe(moe_keys[3], 1, "0")),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the JSON file of the keys (kept keys resume)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="tiny configs at small shapes")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("qtpu_torch.bench.extra: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    out_path = Path(args.out)
    out = json.loads(out_path.read_text()) if out_path.exists() else {}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plan = Plan.tiny() if args.tiny else Plan()
    for keys, thunk in measurements(plan, args.device):
        if all(k in out for k in keys):
            print(json.dumps({k: out[k] for k in keys} | {"cached": True}), flush=True)
            continue
        out.update(thunk())
        out_path.write_text(json.dumps(out, indent=2))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
