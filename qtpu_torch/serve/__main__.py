"""Serving demo CLI of the port: drive the continuous-batching engine end
to end on random-init weights and random prompts.

Usage:
  python -m qtpu_torch.serve [--model tiny-test]
                             [--method none|rtn|awq|smoothquant|gptq|pot|apot] [--a8]
                             [--w-bit 4] [--group 64] [--kv bfloat16|int8]
                             [--requests 4] [--tokens 16] [--batch 4]
                             [--temperature 0.0] [--device cuda|cpu] [--http PORT]

The flags and defaults are qtpu's (`python -m qtpu.serve`). GPT-2 and OPT
(--model gpt2, opt-125m, tiny-gpt2-test, tiny-opt-test) serve with every
method: packed linears on K1 (OPT's q/k/v fused), int8-cache decode on K2
and the one-layer decode attention (K3's kernel), bf16-cache decode on K8.
The MoE
models (--model tiny-moe-test, tiny-qwen2-moe-test, mixtral-8x7b,
qwen2-moe-a14b) serve with every method: affine expert sites (rtn, awq,
gptq without actorder, smoothquant) on kernels K9 (grouped) and K10
(gathered, decode with batch x top-k below the expert count; smoothed
rows scaled by their expert's vector), codebook expert sites (pot, apot) on
K7, W8A8 ones (--a8) on K6, one launch an expert; int8-cache decode on K11.
awq,
smoothquant and gptq calibrate on qtpu's four random batches of 64 ids
(numpy default_rng(0..3)); --a8 serves SmoothQuant W8A8 (per-channel int8
weights, dynamic int8 activations, kernel K6); pot and apot pack W4
codebook sites (kernel K7). The default bf16 KV cache decodes on kernel
K8, the int8 cache (--kv int8) on K2/K3.

--http PORT serves qtpu's HTTP API instead of the demo run (POST /generate,
GET /health; serve/http.py): the engine is warmed first (kernel builds, a
scratch prefill, the CUDA graphs of its decode blocks), then the server
listens on 127.0.0.1:PORT (0: any free port) until interrupted.
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qtpu_torch.serve", description=__doc__)
    ap.add_argument("--model", default="tiny-test")
    ap.add_argument("--method", default="rtn",
                    choices=["none", "rtn", "awq", "smoothquant", "gptq", "pot", "apot"])
    ap.add_argument("--w-bit", type=int, default=4)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--kv", default="bfloat16", choices=["bfloat16", "int8"])
    ap.add_argument("--a8", action="store_true",
                    help="W8A8: dynamic int8 activations (smoothquant only)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve an HTTP API instead of the demo run (0: any free port)")
    args = ap.parse_args(argv)

    from qtpu_torch.models import get_arch, get_model_config
    from qtpu_torch.serve.batching import ContinuousBatcher

    cfg = get_model_config(args.model)
    arch = get_arch(cfg.arch)
    params = arch.init_params(cfg, seed=args.seed, device=args.device)
    qmeta = None
    if args.method != "none":
        from qtpu_torch.quant.apply import (
            CALIBRATED_METHODS,
            fold_smooth,
            fuse_packed_sites,
            pack_model,
        )

        stats = None
        if args.method in CALIBRATED_METHODS:
            from qtpu_torch.calib import collect_calibration_stats

            batches = [np.random.default_rng(i).integers(0, cfg.vocab_size, (1, 64),
                                                         dtype=np.int32) for i in range(4)]
            stats = collect_calibration_stats(arch.forward, params, batches, cfg)
        mcfg = {"w_bit": args.w_bit, "q_group_size": args.group}
        if args.a8:
            mcfg.update({"act_quant": True, "w_bit": 8})
        params, qmeta = pack_model(params, args.method, mcfg, stats, arch=cfg.arch)
        params, qmeta = fold_smooth(params, qmeta, arch=cfg.arch)
        params, qmeta = fuse_packed_sites(params, qmeta, arch=cfg.arch)
        a8 = "A8" if any(len(m) == 5 for _, m in qmeta) else ""
        print(f"packed model with {args.method} W{mcfg['w_bit']}{a8} g{args.group}")

    eng = ContinuousBatcher(
        params, cfg, qmeta=qmeta, max_batch=args.batch, max_seq_len=args.max_seq,
        kv_dtype=args.kv, seed=args.seed, device=args.device,
    )
    if args.http is not None:
        return _serve_http(eng, args.http)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=8 + 2 * i, dtype=np.int32)
        eng.submit(prompt, max_new_tokens=args.tokens, temperature=args.temperature)
    t0 = time.perf_counter()
    done = eng.run()
    total_tokens = sum(len(r.output) for r in done)
    dt = time.perf_counter() - t0
    for r in done:
        print(f"req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    print(
        f"{len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens / dt:.1f} tok/s incl. kernel builds) on {args.device}"
    )
    return 0


def _serve_http(eng, port: int) -> int:
    from qtpu_torch.serve.http import ServingFrontend, make_server

    # warm before opening the port, so that the first requests see warm TTFT
    print(f"engine warmup {eng.warmup():.1f}s", flush=True)
    frontend = ServingFrontend(eng)
    server = make_server(frontend, port)
    print(f"serving on http://127.0.0.1:{server.server_address[1]} "
          "(POST /generate, GET /health)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        frontend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
