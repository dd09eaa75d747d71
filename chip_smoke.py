#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as a check of the port
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:
  device   the card's name, count, and nvidia-smi's name and power limit
  build    nvcc builds every kernel source (in parallel), with the -Xptxas -v
           register and shared-memory report
  kernels  K1-K13 against their plain PyTorch versions at the shapes of the
           main paths (TinyLlama-1.1B, batch 8, prompt 128, W4 g128; K5 at
           one layer of an eval block of 2048 tokens; K6 at M = 8, 1024 and
           2048 on every W8A8 site, K7 on every fused codebook site; K8 on
           the serve cell's bf16 cache; K9 on Mixtral-8x7B's expert sites at
           M = 8 and 1024 and one Qwen2-57B-A14B site, K10 at 4 routed slots
           on its tensor-core body (one weight stream per distinct routed
           expert, the route against gathered_route's rule, two calls giving
           the same bits) with dq_core's GEMV (moe_gathered_matmul_simt) as
           "was", K11 on the serve_moe cell's int8 cache; K2 on programmatic
           dependent launch, 22 launches in a graph and in the order of a W4
           decode step (K1 qkv, RoPE, K2, K3) against the same kernel
           launched without the attribute and the earlier kernel; K1 on GPT-2's 50257-wide
           lm_head; K12's three entries at the long_ctx cell's layer (S 32768),
           at Mistral-7B widths with a window of 4096 and at the serve cell's
           cache, beside K11 on a stacked cache of the same long layer; the
           one-layer decode attention at GPT-2's serve shape; K1 with qtpu's
           norm_w and resid options at the TinyLlama qkv and o sites, at M 8
           on the tensor-core GEMV and at M 16, 32, 64, 1024 and 2048 on the
           Hopper route (each beside the composed chain it replaces, the
           plain version and torch.matmul / addmm on the bf16 weight); K13 at
           the TinyLlama layer, M 1, 8, 32, W4 and W8, and at a Llama-2-7B
           layer, M 8, W4, beside the K1 + K4 + K1 chains it replaces; K1 and
           K7 at the five TinyLlama sites at prefill M 1024 and eval M 2048 on
           the Hopper route, csrc/dq_wgmma.cuh, with K1's earlier mma.sync
           body timed on the same bytes through K9's mma.sync entry with one
           expert as "was", the route each call took against dq_route's rule,
           two calls giving the same bits, W2/W4/W8 g64/g128 and ragged M on
           the route, OPT's q/k/v and lm_head, and the host cost of encoding
           its tensor maps; K9 at M 1024 on the same route with its expert
           axis and K6 at M 1024 and 2048 on its int8 route, each with the
           route against its rule (moe_route, w8a8_route), two calls giving
           the same bits, K6's bits equal to its mma.sync body's, and the
           mma.sync bodies timed on the same bytes as "was"); K3's kernel
           (K3, K8, K11, the one-layer entry: a thread-block cluster of
           `decode_cluster` blocks a (sequence, kv-head)) and K12 on the
           shared core of csrc/kv_decode_core.cuh, each with its earlier body
           (the `_simt` entries) timed on the same bytes as "was" and the
           codes, scales or rows it writes equal to the earlier body's; the
           tensor-core decode GEMV (csrc/dq_gemv_tc.cuh) of K1 (every decode
           site, and with its norm_w / resid options), K7, K9 and K4 and K5's
           Hopper body (wgmma fed by TMA; eval shape and Mistral-7B's hd 128),
           each on the route its rule names (gemv_route, flash_route) and
           beside its earlier body on the same bytes as "was"
           (quantized_matmul_simt, codebook_matmul_simt, moe_matmul_simt,
           fused_mlp_simt, flash_attention_mma); K6 at M <= 8 on its own
           tensor-core GEMV (one launch, csrc/w8a8_matmul.cu) with the dp4a
           body's three launches (w8a8_matmul_dp4a) as "was" and its bits
           equal at M 1, 3 and 8, and K13's phases on the tensor-core step
           with the dq_core tiles (layer_boundary_dq) as "was"; with times:
           kernel, plain version, one PyTorch library call where one
           computes the same function, and the bound from bytes and
           operations at 3.35 TB/s and 989 TFLOP/s bf16 or 1,979 TOP/s int8
           (H100 SXM data sheet); a kernels_hopper_route line gives each
           Hopper-route site against its library call (torch.matmul on the
           dequantized weight, torch.bmm on the bf16 experts, torch._int_mm)
           and its share of the bound, a kernels_decode_gemv_k5 line each
           decode GEMV site (K6's and K13's too) and K5 shape against its
           earlier body, its bound and its library call (K13: the default
           chain); the serving and eval phases check that every decode
           launch of K1, K7, K9, K4 and K6 took the tensor-core GEMV (but
           GPT-2's 50257-wide lm_head), every K13 launch its tensor-core
           tiles and every K5 launch its Hopper body; and every attention
           kernel at hd 80 and 96 (K5 on an eval block of 32 heads, ragged S
           and a prefill; the one-layer entry and K8 at OPT-2.7B's MHA
           decode, K3, K11 and K12's three entries at 32 heads over 8) against
           its plain version with its times, listed in the kernels line as
           <kernel>_hd80 / _hd96; the same at Falcon3-7B's shapes (hd 256:
           K5 on its eval block, 12 q heads over 4 kv heads; the decode
           entries at B 8, G 3; K12 at S 32768) as <kernel>_hd256, and over
           the kernels' domain (DOMAIN_SHAPES: hd 8, 24, 40, 72 and 136 at
           32 q heads over 8; G 48 and 64 on one kv head at hd 64 and 128;
           K12's flash entry at S 4096) as <kernel>_<tag>; K1 at
           Falcon3-7B's five sites at M 8, 1024 and 2048 and K4 at its MLP
           (F 23040, M 8) against their plain versions with their times, as
           dequant_matmul_falcon3, dequant_matmul_wgmma_falcon3 and
           fused_mlp_falcon3
  e2e      a 2-layer model at TinyLlama widths: prefill + 4 decode steps on
           the card against the same on the CPU (plain versions), RTN W4 on
           the int8 KV cache and POT W4 on the bf16 cache; and a 2-layer
           Mixtral-8x7B-width MoE model, RTN W4 g128, on the int8 cache
           (batch 4, grouped K9) and the bf16 cache (batch 2, gathered K10),
           with the (token, expert) routes that differ between the card and the
           CPU counted per layer and a second card run on the CPU's routes; a
           2-layer TinyLlama-width model on the per-layer int8 cache at S 4096
           (prefill 128, 8 decode steps, K12 2 a step); 2-layer GPT2_SMALL and
           OPT_125M-width models, RTN W4, on both caches; the 2-layer TinyLlama
           under QTPU_FUSE_NORM_RESID=1 and QTPU_BOUNDARY=1 on both caches; in
           the Mixtral e2e every kernel call is also held to its plain version,
           the CPU runs a second time with the weights in f32, and a
           teacher-forced pass holds each half-layer (attention, MoE MLP) on
           the card, from the CPU run's inputs, to the CPU, to the plain
           versions on the card and to the f32-weight arithmetic; 1-layer
           llamas at hd 80 (hidden 2560, 32 heads) and 96 (3072) and a
           1-layer OPT-2.7B (hd 80), the eval forward and prefill + 4 decode
           steps against the CPU on the int8 and bf16 caches (the llamas
           also on the per-layer int8 cache at S 2048, K12), every attention
           call on its kernel (K5, K2 + K3 or the one-layer entry, K8, K12
           as reckoned) and none on the plain route
  serve    the main path at full width: TinyLlama-1.1B (22 layers, random
           per-layer weights from a seed), RTN W4 g128 with fused sites, a
           ContinuousBatcher with the int8 KV cache answering 8 requests of
           prompt 128 and 32 new tokens, first on CUDA graphs of its decode
           blocks and of qtpu's prefill buckets, captured by warmup() (its
           seconds, the memory it adds and the buckets captured printed),
           then on an eager engine (cuda_graphs=False): greedy tokens equal
           request for request (and sampled ones at temperature 0.8, in
           serve), and for each tokens/s, mean TTFT, a decode step's and
           each bucket's prefill wall and device ms and busy share (serve:
           every warm bucket on graphs; so too in serve_w8a8, serve_bf16,
           serve_gpt2, opt_2_7b, serve_moe at 8 and 2 slots, http and ckpt,
           and long_ctx, whose 32 steps run again as 2 replays of its
           16-step graph against the eager steps' ids; boundary's six
           engines run on graphs, the default and fuse branches also eager);
           on both engines every kernel's launch count is
           checked against its count per prefill and per decode step, and
           every K1 launch of the prefill on the Hopper route (the route
           counters; so too in eval, pot_apot and serve_bf16 for their eval
           blocks and prefills, for K6 in quant and serve_w8a8 and for K9 in
           serve_moe and the Mixtral e2e); then the host wall time of steady
           16-step decode blocks
  profile  torch.profiler over one warm prefill and one 16-step decode block
           of the serve cell: host and device time per step, the device busy
           share and the kernels that take the device time; and the host wall
           time of three warm prefills without the profiler
  long_ctx long-context decode on the per-layer int8 cache: TinyLlama-1.1B at
           full width, RTN W4 g128 fused, a ContinuousBatcher with 8 slots and
           kv_layout="per_layer" sized to S 32768 (max_seq_len 32752,
           decode_block 16), every layer filled up to S - 80 with seeded
           random codes and scales drawn from the model's own prefill, 32
           decode steps (K12 22 a step); K12 against its plain version on every
           layer of the first step, that step against the plain functions on
           the card (and the same on the empty cache, the floor), tokens/s, a
           profile (device time, busy share, K12's share), peak memory
  opt_2_7b OPT-2.7B at full width (facebook/opt-2.7b's widths: 32 heads of
           80, vocab 50272; 8 of its 32 layers, OPT_2_7B_LAYERS; random
           per-layer weights from seed 0), RTN W4 g128 fused: the engine at
           8 x (128 + 32) on the int8 cache (K2 and the one-layer entry a
           layer a step) and the bf16 cache (K8 a layer a step), graphs and
           eager, tokens equal, tokens/s, TTFT, a step's device time against
           its byte bound; the raw, fake-quant and packed perplexities on
           the fixture (4 blocks of 2048, packed within 1% of fake-quant, K5
           a layer a block on its Hopper body)
  serve_gpt2  GPT2_SMALL and OPT_125M at full width, RTN W4 g128, int8 KV, 8
           requests of prompt 128 and 32 new tokens: tokens/s, TTFT, launches
           (K1 49 a forward, K2 and the one-layer decode attention 12 a decode
           step), a profile of a decode step; then `python -m qtpu_torch.serve
           --model gpt2 --kv int8` (its main())
  falcon3  Falcon3-7B-Base at full width (FALCON3_7B: tiiuae/Falcon3-7B-Base's
           config.json, 12 q heads and 4 kv heads of 256; FALCON3_LAYERS of
           its 28 layers; random per-layer weights from seed 0), RTN W4 g128
           fused: the engine at 8 x (128 + 32) on CUDA graphs on the int8
           cache (K2 and K3 a layer a step) and the bf16 cache (K8), each
           held to the port's plain run of the same bytes (the prefill and
           FALCON3_STEPS decode steps teacher-forced on the engine's tokens,
           every kernel swapped for its plain version on the card): logits
           within 3e-2 of the plain run's at 2 layers, and at the served
           depth within 3e-2 of the plain functions' f32 run on the same
           bytes or no farther from it than the plain bf16 run is, tokens
           past SHARD_FLIP_GAP, each kernel family alone against the plain
           run printed; one eval block of 2048 on the fixture through K5 at
           hd 256 (its Hopper body), its perplexity within 1% of the plain
           forward's and its logits held the same way; the per-layer int8
           cache at S 32768 (FALCON3_LONG_LAYERS layers, filled with seeded
           random codes) through K12, 4 decode steps against the plain run
           (3e-2); every attention call on its kernel, none on the plain
           route
  boundary qtpu's layer-boundary decode branches at full width: TinyLlama-1.1B
           (8 of its 22 layers, CUT_LAYERS) RTN W4 g128 fused, 8 slots,
           8 requests of 128 + 32, on the stacked int8 and bf16 caches, each
           under default, QTPU_FUSE_NORM_RESID=1 and QTPU_BOUNDARY=1:
           tokens/s, TTFT, peak memory, launches per step (K13, K11 or K8 a
           layer, K1 2 under boundary), a profile (K13's
           share), a step from one prefill against the default's, K13
           held to its plain version on every layer of that step, and every
           K13 launch on its tensor-core tiles
  eval     the quantize-and-evaluate path at full width through
           `python -m qtpu_torch.bench` (its main() in this process):
           TinyLlama-1.1B, the byte-level fixture (4 blocks of 2048), raw,
           RTN W4 g128 fake-quant and packed perplexity, sizes and the
           serving pseudo-method, with every launch count checked; then the
           time per warm eval block, a profiler split of a packed block, and
           a 2-layer eval on the card against the CPU
  quant    the calibrated methods at full width through `python -m
           qtpu_torch.bench` (main() in this process): TinyLlama-1.1B, the
           fixture's 4 calibration blocks of 512 and 4 test blocks of 2048,
           AWQ W4 g128, GPTQ W4 g128 with true Hessians, SmoothQuant W8A8
           (alpha 0.5), packed_eval, and the serving pseudo-method on the
           SmoothQuant artifact; perplexities, error rows and every launch
           count checked; then the time of calibration, of AWQ's and
           SmoothQuant's quantize and of each method's pack (GPTQ's sweep
           once), a profiler split of warm packed eval blocks,
           and a 2-layer packed eval on the card against the CPU
  serve_w8a8  the serving engine at full width on SmoothQuant W8A8
           (calibrated on the fixture, int8 KV, 8 requests of prompt 128 and
           32 new tokens) with launch counts checked (K6 on every linear,
           every decode launch on its tensor-core GEMV, K2/K3 per decode
           step, no K1/K4), a profile of one prefill and one 16-step decode
           block (with the CUDA kernel launches a step), then `python -m
           qtpu_torch.serve --method
           smoothquant --a8 --kv int8` (its main())
  pot_apot the POT/APOT path at full width through `python -m
           qtpu_torch.bench` (main() in this process): TinyLlama-1.1B at
           POT_APOT_LAYERS (4) of its 22 layers, the
           fixture's 4 test blocks of 2048, POT (on the 0.1 grid) and APOT
           W4 g128 fake-quant and packed (K7) perplexity, sizes, and the
           serving pseudo-method
           on the POT artifact with the bf16 KV cache (K8), launch counts
           checked; then each method's quantize and pack time, a profiler
           split of a packed block, and pot/apot codes of one full-width
           site on the card against the CPU
  serve_bf16  the serving engine at full width on POT W4 g128 with fused
           sites and the bf16 KV cache (8 requests of prompt 128 and 32 new
           tokens) with launch counts checked (K7 on every linear, K8 per
           decode step, no K1-K4), a profile of one prefill and one 16-step
           decode block, then `python -m qtpu_torch.serve --method apot`
           (its main(), the default bf16 cache)
  serve_moe  the sparse-MoE serving path: Mixtral-8x7B at full width with 4
           of its 32 layers (MOE_LAYERS) (random per-layer weights from seed 0), RTN W4
           g128, a ContinuousBatcher with 8 slots and the int8 KV cache
           answering 8 requests of prompt 128 and 32 new tokens (K1 on q, k,
           v, o and lm_head, K9 on the expert sites, K11 per layer of a
           decode step), then a 2-slot engine answering 2 requests (decode on
           K10, 3 launches a layer a step on the tensor-core body), launch
           counts checked; a profile of one prefill and of decode steps at
           8 and at 2 slots (K10's share); then `python -m qtpu_torch.serve --model
           tiny-moe-test --kv int8 --batch 1` (its main())
  http     the HTTP front end (qtpu_torch/serve/http.py) over the serve
           cell's engine after warmup(): 8 threads POST 8 requests of prompt
           128 and 32 new tokens at once; each response's tokens against the
           eager engine's, the launches against the serve reckoning, /health
           (8 requests), 400 on {} and 404 on an unknown path; then `python
           -m qtpu_torch.serve --model tiny-test --kv int8 --http 0` in a
           process of its own: its "serving on" line, one request, SIGINT
  ckpt     real models in, packed artifacts out, at full width: a
           TinyLlama-1.1B Hugging Face checkpoint (config.json from the
           preset, bf16 random weights from seed 0, two safetensors shards
           and their index) written by this script; config_from_hf against
           the preset and load_checkpoint to the card against the written
           tensors, bit for bit (GB/s); `python -m qtpu_torch.bench` (main()
           in this process) with checkpoint_path, RTN W4 g128, packed_eval,
           2 fixture blocks of 2048 and save_artifacts, held to eval's rules
           (K1 on the Hopper route, K5 on its Hopper body); load_quantized
           to the card against pack_model in this process, bit for bit; 8
           requests of 128 + 32 greedy tokens on the int8 cache on the
           loaded artifact and on the in-process params: the same tokens,
           K1-K4 launches as the serve phase reckons them
  moe_methods  the MoE methods at Mixtral-8x7B's full width (2 layers; GPTQ,
           POT and APOT on the first): routed calibration on the fixture, then
           awq, smoothquant W8A8, gptq (true Hessians, actorder), pot and
           apot each quantized and packed (seconds printed), packed
           perplexity within the eval phase's gates of fake-quant, sizes
           against the reckoning on meta tensors, served 8 x (128 + 32) on 8
           slots and 2 x (128 + 32) on 2 slots on graphs and eager (greedy
           tokens equal; every expert site on the kernel its method names:
           K9 / K10 for AWQ's smoothed sites, K1 with perms for GPTQ, K6 for
           W8A8, K7 for the codebooks); then `python -m qtpu_torch.bench` on
           a 1-layer Mixtral-width HF checkpoint this script writes (awq,
           smoothquant, packed_eval, serving, save_artifacts), the AWQ
           artifact loaded to the card and served on 2 slots (K10)
  utils    qtpu_torch.utils on the card: the bench on tiny-test with
           profile_dir (a Chrome trace an eval, the packed one naming K1's
           and K5's kernels), Timer against CUDA events (within 5%),
           checked() raising on a NaN made inside a function
  synth    tiled_packed_llama(TinyLlama-1.1B) on the card (one layer's
           bytes, tiled over 22 as stride-0 views) served against a
           materialized copy (tokens equal, bytes against the reckoning),
           and qtpu_torch.native (built with g++, without OpenMP where the
           compiler has no runtime for it): available(), the flags, bytes
           equal to the torch packers at TinyLlama's site widths, GB/s
  shard    sharding (qtpu_torch.sharding): the tensor-parallel code in a
           1-rank NCCL world bit for bit the unsharded path; the kernels at
           TinyLlama's TP 2 shard shapes and on 4 Mixtral experts, timed;
           a 2-process gloo world sharing the card (NCCL refuses two ranks
           on one card; what gloo takes no card tensor for is staged
           through host memory, counted): TP 2 serve and eval, DP 2 eval
           and calibration, pipe 2 eval, ring attention at seq 2 (S 8192,
           8 layers), MoE EP 2 at Mixtral-8x7B widths, each held to the
           one-rank run; an 8-process gloo world: TinyLlama W4 g64 at TP 8,
           twice its 4 KV heads (each rank holds the KV head its q heads
           read), 8 decode steps against a one-rank run
  extras   qtpu's last entry points at full width: every measurement of
           `python -m qtpu_torch.bench.extra` (bench_extra.py's keys:
           Llama-2-7B W4 decode at B 8, TinyLlama W4 prefill at 2 x 2048
           and 1 x 8192, decode over a 16k per-layer cache, W8 and W8A8, B
           32, the batcher cold and warm, the 8x1B MoE at B 8, 1, 2 and 1
           on the grouped route) once with the fewest blocks qtpu's
           estimator takes, each rate's launches held to their reckoning;
           the 7B and 16k runs' first decode block against the plain
           functions on the card; graft.entry()'s forward against its plain
           run; scaling_sweep at (1, 1) and (2, 1) on 2 gloo ranks sharing
           the card; graft.dryrun_multichip(4) on 4, its TP logits against
           the one-rank forward. The kernels phase holds each kernel at the
           shapes these measurements give it (its `kernels_extras` line)

Each phase also holds the count of attention calls that took the plain
route (a shape a kernel does not take, models/ops.py: hd % 8 != 0, hd >
256) to its reckoning: 0 in every phase.

Launch counters under CUDA graphs: a replay runs no Python, so the engine
adds to every wrapper's counters, on each replay, what the capture of that
block or prefill bucket counted (qtpu_torch/serve/graphs.py); the
reckonings hold unchanged.

The last lines are the nvidia-smi line, the `kernels` JSON line and
{"ok": true, "device": {...}}. Any failed check raises, and the script then
exits non-zero without the last line. It needs a CUDA device and the
qtpu_torch package beside it; it imports nothing of JAX or qtpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "e2e", "serve", "profile", "long_ctx", "serve_gpt2",
          "opt_2_7b", "falcon3", "boundary", "eval", "quant", "serve_w8a8", "pot_apot", "serve_bf16",
          "serve_moe", "http", "ckpt", "moe_methods", "utils", "synth", "shard", "extras")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
INT8_OP_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores
L2_BYTES = 50 * 1024 * 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The least time (ms) for the bytes at the memory rate and the
    operations at `rate`, and which of the two bounds it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def cuda_ms(torch, calls, per_call_bytes: float, reps: int = 0, graph: bool = True) -> tuple[float, str]:
    """Warm per-call device time of `calls` (closures on distinct buffers,
    used in turn so the 50 MB L2 is exceeded), from CUDA events around a
    CUDA graph of the calls (no host overhead in the time), or around eager
    calls when graph=False (for calls that synchronize with the host)."""
    n = len(calls)
    reps = reps or max(n, min(200, int(4 * L2_BYTES // max(per_call_bytes, 1)) + 1))
    for f in calls[: min(n, 3)]:
        f()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if not graph:
        e0.record()
        for i in range(reps):
            calls[i % n]()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps, "eager"
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:  # warm on the side stream before capture
            f()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        for i in range(reps):
            calls[i % n]()
    g.replay()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(3):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * reps), "graph"


def rel_err(torch, got, want) -> float:
    g, w = got.float(), want.float()
    return float(torch.linalg.vector_norm(g - w) / (torch.linalg.vector_norm(w) + 1e-6))


def _rel_err_rows(torch, got, want, rows: int = 256) -> float:
    """rel_err of two [S, V] tensors, taken `rows` rows at a time (eight
    ranks on one card each hold a 2048 x 152064 block: no f32 copy of it)."""
    num = den = 0.0
    for i in range(0, got.shape[0], rows):
        g, w = got[i:i + rows].float(), want[i:i + rows].float()
        num += float(torch.linalg.vector_norm(g - w)) ** 2
        den += float(torch.linalg.vector_norm(w)) ** 2
    return num ** 0.5 / (den ** 0.5 + 1e-6)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ----------------------------------------------------------------- phases
def phase_device(torch, ctx):
    ctx["name"] = torch.cuda.get_device_name(0)
    ctx["count"] = torch.cuda.device_count()
    ctx["smi"] = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    emit({"phase": "device", "name": ctx["name"], "count": ctx["count"],
          "nvidia_smi": ctx["smi"], "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build(torch, ctx):
    from qtpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in r["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, r in report.items()
    }
    emit({"phase": "build", "wall_s": wall,
          "seconds": {n: r["seconds"] for n, r in report.items()},
          "cached": {n: r["cached"] for n, r in report.items()}, "ptxas": ptxas})


def _packed(torch, L, K, N, bits, group, gen, dev, symmetric=False):
    """L layers of a random [K, N] weight packed with quantize_pack."""
    from qtpu_torch.core.packing import quantize_pack

    parts = [
        quantize_pack(torch.randn(K, N, generator=gen, device=dev) * 0.02, bits, group, symmetric)
        for _ in range(L)
    ]
    data = torch.stack([p.data for p in parts])
    scales = torch.stack([p.scales for p in parts])
    zeros = None if symmetric else torch.stack([p.zeros for p in parts])
    return data, scales, zeros


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (floats compared as integers: -0.0, NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


def _route_taken(torch, wrapper, call):
    """Runs call() once and returns (its output, the body the wrapper's
    route counters saw: "wgmma", "mma", "gemv_tc" or "gemv")."""
    w0, m0 = wrapper.wgmma_launches, wrapper.mma_launches
    t0 = getattr(wrapper, "gemv_tc_launches", 0)
    out = call()
    torch.cuda.synchronize()
    if wrapper.wgmma_launches > w0:
        return out, "wgmma"
    if getattr(wrapper, "gemv_tc_launches", 0) > t0:
        return out, "gemv_tc"
    return out, "mma" if wrapper.mma_launches > m0 else "gemv"


def _rule(route, M, K, N, bits, group, ptrs):
    """A wrapper's rule (dq_route, cb_route, moe_route), refined at M <= 8 by
    gemv_route (the tensor-core GEMV or dq_core's)."""
    from qtpu_torch.kernels.dequant_matmul import gemv_route

    return gemv_route(M, K, N, bits, group, ptrs) if route == "gemv" else route


def _k1_case(torch, ctx, gen, dev, M, K, N, bits, group, symmetric=False, timed=True,
             was=False):
    """K1 against its plain version at one shape (relative 2e-2), the route
    its counters saw against dq_route's rule, and at M > 8 two calls giving
    the same bits; timed: the kernel, the plain version, torch.matmul on
    the weight dequantized to bf16 and the bound; was: the mma.sync body of
    the earlier route on the same bytes (K9's mma.sync entry, moe_matmul_mma,
    with one expert and x shared, which runs dq_mma_body<BITS, false>)."""
    from qtpu_torch.core.packing import dequantize_parts
    from qtpu_torch.kernels import moe_matmul as k9
    from qtpu_torch.kernels.dequant_matmul import (dq_route, quantized_matmul,
                                                   quantized_matmul_plain, quantized_matmul_simt)

    meta = (bits, group, K, N)
    wbytes = K * N * bits / 8 + (K // group) * N * (2 + (0 if symmetric else 1))
    copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes))) if timed else 1
    data, scales, zeros = _packed(torch, copies, K, N, bits, group, gen, dev, symmetric)
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    z = (lambda i: None) if zeros is None else (lambda i: zeros[i])
    got, route = _route_taken(torch, quantized_matmul,
                              lambda: quantized_matmul(x, data[0], scales[0], z(0), meta))
    want = quantized_matmul_plain(x, data[0], scales[0], z(0), meta)
    torch.cuda.synchronize()
    err = rel_err(torch, got, want)
    ptrs = [t.data_ptr() for t in (data[0], scales[0], z(0)) if t is not None]
    row = {"M": M, "K": K, "N": N, "bits": bits, "group": group, "sym": symmetric,
           "rel_err": err, "max_abs_err": float((got.float() - want.float()).abs().max()),
           "tol_rel": 2e-2, "route": route,
           "rule": _rule(dq_route(M, N, bits, group, ptrs), M, K, N, bits, group, ptrs)}
    if err >= 2e-2 or not torch.isfinite(got.float()).all():
        raise AssertionError(f"K1 disagrees with its plain version: {row}")
    if route != row["rule"]:
        raise AssertionError(f"K1 ran the {route} body where its rule says {row['rule']}: {row}")
    if M > 8 or route == "gemv_tc":
        again = quantized_matmul(x, data[0], scales[0], z(0), meta)
        torch.cuda.synchronize()
        row["same_bits_two_calls"] = _bits_equal(torch, got, again)
        if not row["same_bits_two_calls"]:
            raise AssertionError(f"K1's two calls differ: {row}")
    if not timed:
        return row
    nbytes = wbytes + M * K * 2 + M * N * 2
    flops = 2 * M * K * N
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda i=i: quantized_matmul(x, data[i], scales[i], z(i), meta)
                for i in range(copies)], wbytes)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda i=i: quantized_matmul_plain(x, data[i], scales[i], z(i), meta)
                for i in range(copies)], wbytes)
    nlib = max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))
    wd = [dequantize_parts(data[i], scales[i], z(i), bits, group) for i in range(nlib)]
    row["library_ms"], _ = cuda_ms(torch, [lambda i=i: torch.matmul(x, wd[i])
                                           for i in range(nlib)], K * N * 2)
    if was and M > 8:
        ex = [(data[i][None], scales[i][None], None if zeros is None else zeros[i][None])
              for i in range(copies)]
        row["was_ms"], _ = cuda_ms(torch, [lambda e=e: k9.moe_matmul_mma(x, *e, meta) for e in ex],
                                   wbytes)
        row["was"] = "dq_mma_body (mma.sync) on the same bytes, K9's moe_matmul_mma, one expert"
    elif was:
        row["was_ms"], _ = cuda_ms(
            torch, [lambda i=i: quantized_matmul_simt(x, data[i], scales[i], z(i), meta)
                    for i in range(copies)], wbytes)
        row["was"] = "dq_core's SIMT GEMV on the same bytes, quantized_matmul_simt"
    return row


def _map_encode_ns(torch, dev, M, K, N):
    """The Hopper route's host cost a call: nanoseconds to encode its two
    tensor maps (qtpu_dq_map_ns, the mean of 1000 encodes), at one shape."""
    import ctypes

    from qtpu_torch.kernels import _build
    from qtpu_torch.kernels.dequant_matmul import _SIG

    lib = _build.load("dequant_matmul", _SIG)
    lib.qtpu_dq_map_ns.argtypes = [_build.P, _build.P] + [_build.I] * 4
    lib.qtpu_dq_map_ns.restype = ctypes.c_longlong
    x = torch.zeros(M, K, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(K // 2, N, dtype=torch.int8, device=dev)
    ns = lib.qtpu_dq_map_ns(x.data_ptr(), w.data_ptr(), M, K, N, 1000)
    if ns <= 0:
        raise AssertionError(f"qtpu_dq_map_ns returned {ns}")
    return {"M": M, "K": K, "N": N, "ns_per_call": ns, "maps": 2}


def phase_kernels(torch, ctx):
    from qtpu_torch.kernels import fused_mlp as k4
    from qtpu_torch.kernels import kv_attention as k23
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, P, g = 8, 128, 128
    qkv_n = cfg.q_dim + 2 * cfg.kv_dim
    detail = {}

    # K1 at every main-path shape (W4 g128), then the other packings; at
    # decode the tensor-core GEMV with dq_core's GEMV on the same bytes as "was"
    k1_rows = {
        "qkv_decode": _k1_case(torch, ctx, gen, dev, B, D, qkv_n, 4, g, was=True),
        "o_decode": _k1_case(torch, ctx, gen, dev, B, cfg.q_dim, D, 4, g, was=True),
        "lm_head_decode": _k1_case(torch, ctx, gen, dev, B, D, V, 4, g, was=True),
    }
    for site in ("gateup", "down"):  # K1 at K4's sites: the unfused decode calls of K7's shapes
        K_, N_ = K7_SITES[site]
        k1_rows[f"{site}_decode"] = _k1_case(torch, ctx, gen, dev, B, K_, N_, 4, g, was=True)
    # the Hopper route's sites: serve prefill (M 1024) and eval block (M 2048)
    for mname, M in (("prefill", B * P), ("eval", EVAL_BLOCK)):
        for site, (K, N) in K7_SITES.items():
            k1_rows[f"{site}_{mname}"] = _k1_case(torch, ctx, gen, dev, M, K, N, 4, g, was=True)
    for bits in (2, 4, 8):
        for grp in (64, 128):
            for sym in (False, True):
                tag = f"w{bits}g{grp}{'s' if sym else 'a'}"
                k1_rows[f"{tag}_decode"] = _k1_case(
                    torch, ctx, gen, dev, B, D, qkv_n, bits, grp, sym, timed=False)
                k1_rows[f"{tag}_m300"] = _k1_case(
                    torch, ctx, gen, dev, 300, D, qkv_n, bits, grp, sym, timed=False)
    for M in (3, 77, 1000):  # ragged M: TMA zero-fills the x box past M
        k1_rows[f"ragged_m{M}"] = _k1_case(torch, ctx, gen, dev, M, D, qkv_n, 4, g, timed=False)
    # W2 g32 has 8 packed rows per group: M > 8 takes the GEMV kernel
    k1_rows["w2g32a_m77"] = _k1_case(torch, ctx, gen, dev, 77, D, qkv_n, 2, 32, timed=False)
    # GPT-2's tied lm_head, [768, 50257]: N % 16 != 0, the mma.sync body at
    # prefill and the ragged column tail; OPT-125M's fused q/k/v and its
    # 50272-wide lm_head (N % 16 == 0, a ragged last tile): the Hopper route
    from qtpu_torch.models.config import GPT2_SMALL, OPT_125M

    gd, gv = GPT2_SMALL.hidden_size, GPT2_SMALL.vocab_size
    k1_rows["gpt2_lm_head_decode"] = _k1_case(torch, ctx, gen, dev, B, gd, gv, 4, g)
    k1_rows["opt_lm_head_decode"] = _k1_case(torch, ctx, gen, dev, B, OPT_125M.hidden_size,
                                             OPT_125M.vocab_size, 4, g, was=True)
    k1_rows["gpt2_lm_head_prefill"] = _k1_case(torch, ctx, gen, dev, B * P, gd, gv, 4, g)
    od, ov = OPT_125M.hidden_size, OPT_125M.vocab_size
    k1_rows["opt_qkv_prefill"] = _k1_case(torch, ctx, gen, dev, B * P, od, 3 * od, 4, g,
                                          timed=False)
    k1_rows["opt_lm_head_prefill"] = _k1_case(torch, ctx, gen, dev, B * P, od, ov, 4, g,
                                              timed=False)
    detail["dequant_matmul"] = k1_rows
    detail["wgmma_map_encode"] = _map_encode_ns(torch, dev, B * P, D, qkv_n)

    # K2 / K3 on the serving engine's cache: S = 128 + 32 + 16 rounded to 8
    S = 176
    k_all = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
    v_all = torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
    ks_all = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
    vs_all = torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    kc = [t.clone() for t in (k_all, v_all, ks_all, vs_all)]
    pc = [t.clone() for t in (k_all, v_all, ks_all, vs_all)]
    k23.cache_band_write(kn, vn, *kc, pos, 3)
    k23.cache_band_write_plain(kn, vn, *pc, pos, 3)
    torch.cuda.synchronize()
    code_diff = max(int((a.int() - b.int()).abs().max()) for a, b in zip(kc[:2], pc[:2]))
    n_code_diff = sum(int((a != b).sum()) for a, b in zip(kc[:2], pc[:2]))
    scale_err = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                    for a, b in zip(kc[2:], pc[2:]))
    k2 = {"code_max_diff": code_diff, "codes_differing": n_code_diff,
          "scale_max_rel_err": scale_err, "tol": "codes within 1 (rounding ties), scales 1e-6"}
    if code_diff > 1 or n_code_diff > 4 or scale_err > 1e-6:
        raise AssertionError(f"K2 disagrees with its plain version: {k2}")
    # the launches without the programmatic attribute and of the earlier
    # kernel write the same bits
    for fn in (k23.cache_band_write_serial, k23.cache_band_write_simt):
        oc = [t.clone() for t in (k_all, v_all, ks_all, vs_all)]
        fn(kn, vn, *oc, pos, 3)
        torch.cuda.synchronize()
        k2[f"same_bits_{fn.__name__}"] = all(bool((a == b).all()) for a, b in zip(kc, oc))
        if not k2[f"same_bits_{fn.__name__}"]:
            raise AssertionError(f"K2's launches write other bits: {fn.__name__} {k2}")
    row_bytes = B * KV * (2 * hd * 2 + 2 * hd + 2 * 4) + B * 4
    k2["bound_ms"], k2["bound_by"] = bound(row_bytes, 0)
    k2["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k23.cache_band_write_plain(kn, vn, *pc, pos, l) for l in range(L)],
        row_bytes, reps=L, graph=False)
    k2.update(_k2_times(torch, gen, dev, cfg, kn, vn, kc, pos))
    k2["library_ms"] = None
    detail["cache_band_write"] = k2

    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    k3 = {}
    rows_read = sum(min(int(p), S - 1) + 1 for p in pos.tolist())
    for window in (0, 64):
        got = k23.decode_attention(q, k_all, v_all, ks_all, vs_all, pos, 5, window=window)
        want = k23.decode_attention_plain(q, k_all, v_all, ks_all, vs_all, pos, 5, window=window)
        torch.cuda.synchronize()
        # f32 math of the same function: the reference test_pallas_kernels.py holds
        # the TPU kernel to (rtol/atol 2e-2)
        want32 = k23.decode_attention_plain(q.float(), k_all, v_all, ks_all, vs_all, pos, 5,
                                            window=window)
        torch.cuda.synchronize()
        # the last row (pos = S, an inactive batch slot) is garbage by contract
        gt, wt, w32 = got[:-1].float(), want[:-1].float(), want32[:-1]
        err = rel_err(torch, gt, wt)
        ok = err < 2e-2 and bool(torch.allclose(gt, w32, rtol=2e-2, atol=2e-2))
        k3[f"window{window}"] = {"max_abs_err": float((gt - wt).abs().max()), "rel_err": err,
                                 "max_abs_err_vs_f32": float((gt - w32).abs().max()),
                                 "tol": "rel 2e-2 vs plain; rtol/atol 2e-2 vs f32 math",
                                 "finite_inactive_row": bool(torch.isfinite(got[-1].float()).all())}
        if not ok or not k3[f"window{window}"]["finite_inactive_row"]:
            raise AssertionError(f"K3 disagrees with its plain version: {k3}")
    att_bytes = rows_read * KV * (2 * hd + 2 * 4) + 2 * B * H * hd * 2 + B * 4
    att_flops = rows_read * H * hd * 4
    k3["bound_ms"], k3["bound_by"] = bound(att_bytes, att_flops)
    k3["ms"], k3["timing"] = cuda_ms(
        torch, [lambda l=l: k23.decode_attention(q, k_all, v_all, ks_all, vs_all, pos, l)
                for l in range(L)], att_bytes)
    k3["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k23.decode_attention_plain(q, k_all, v_all, ks_all, vs_all, pos, l)
                for l in range(L)], att_bytes)
    # "was": the earlier body (one block per (sequence, kv-head)) on the same bytes
    k3["was_ms"], _ = cuda_ms(
        torch, [lambda l=l: k23.decode_attention_simt(q, k_all, v_all, ks_all, vs_all, pos, l)
                for l in range(L)], att_bytes)
    k3["cluster"] = _cluster(torch, k23, B, KV, S)
    # yardstick: SDPA over the cache dequantized to bf16 beforehand
    from qtpu_torch.serve.kvcache import dequantize_kv

    kd = dequantize_kv(k_all[:4], ks_all[:4])
    vd = dequantize_kv(v_all[:4], vs_all[:4])
    mask = k23.cache_mask(pos[:, None], S)[:, None]  # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k3["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask, enable_gqa=True)
                for l in range(4)], att_bytes)
    k3["library_call"] = "scaled_dot_product_attention on the cache dequantized to bf16"
    detail["decode_attention"] = k3

    # K4 over the 22 layers of a TinyLlama MLP, W4 g128
    gu = _packed(torch, L, D, 2 * F, 4, g, gen, dev)
    dn = _packed(torch, L, F, D, 4, g, gen, dev)
    nw = (1.0 + 0.1 * torch.randn(L, D, generator=gen, device=dev)).to(torch.bfloat16)
    x = torch.randn(B, 1, D, generator=gen, device=dev).to(torch.bfloat16)
    mgu, md = (4, g, D, 2 * F), (4, g, F, D)

    def mlp(fn, l):
        return fn(x, nw[l], gu[0][l], gu[1][l], gu[2][l], dn[0][l], dn[1][l], dn[2][l],
                  mgu, md, eps=cfg.norm_eps)

    t0 = k4.fused_mlp.gemv_tc_launches
    got, want = mlp(k4.fused_mlp, 7), mlp(k4.fused_mlp_plain, 7)
    was = mlp(k4.fused_mlp_simt, 7)
    torch.cuda.synchronize()
    err = rel_err(torch, got - x, want - x)
    k4r = {"rel_err_of_mlp_output": err, "max_abs_err": float((got.float() - want.float()).abs().max()),
           "tol_rel": 3e-2, "rel_err_vs_was": rel_err(torch, got - x, was - x),
           "route": "gemv_tc" if k4.fused_mlp.gemv_tc_launches > t0 else "gemv",
           "rule": k4.mlp_route(B, mgu, md, [t[l].data_ptr() for t in gu for l in (7,)],
                                [t[l].data_ptr() for t in dn for l in (7,)])}
    if err >= 3e-2 or not torch.isfinite(got.float()).all():
        raise AssertionError(f"K4 disagrees with its plain version: {k4r}")
    if k4r["route"] != k4r["rule"] or k4r["route"] != "gemv_tc":
        raise AssertionError(f"K4 ran the {k4r['route']} body, its rule says {k4r['rule']}")
    # the no-residual mode (a tensor-parallel rank past the group's first)
    t0 = k4.fused_mlp.gemv_tc_launches
    got_nr = k4.fused_mlp(x, nw[7], gu[0][7], gu[1][7], gu[2][7], dn[0][7], dn[1][7], dn[2][7],
                          mgu, md, eps=cfg.norm_eps, resid=False)
    want_nr = k4.fused_mlp_plain(x, nw[7], gu[0][7], gu[1][7], gu[2][7], dn[0][7], dn[1][7],
                                 dn[2][7], mgu, md, eps=cfg.norm_eps, resid=False)
    torch.cuda.synchronize()
    k4r["no_resid"] = {"rel_err": rel_err(torch, got_nr, want_nr),
                       "max_abs_err": float((got_nr.float() - want_nr.float()).abs().max()),
                       "rel_err_vs_resid_mode_minus_x": rel_err(torch, got_nr, got.float() - x.float()),
                       "route": "gemv_tc" if k4.fused_mlp.gemv_tc_launches > t0 else "gemv",
                       "tol_rel": 3e-2}
    if (k4r["no_resid"]["rel_err"] >= 3e-2 or k4r["no_resid"]["route"] != "gemv_tc"
            or not torch.isfinite(got_nr.float()).all()):
        raise AssertionError(f"K4's no-residual mode disagrees: {k4r['no_resid']}")
    mlp_w = (D * 2 * F + F * D) / 2 + (D // g) * 2 * F * 3 + (F // g) * D * 3
    mlp_bytes = mlp_w + 2 * B * D * 2 + D * 2
    k4r["bound_ms"], k4r["bound_by"] = bound(mlp_bytes, 2 * B * (D * 2 * F + F * D))
    k4r["ms"], k4r["timing"] = cuda_ms(torch, [lambda l=l: mlp(k4.fused_mlp, l) for l in range(L)],
                                       mlp_w)
    k4r["plain_ms"], _ = cuda_ms(torch, [lambda l=l: mlp(k4.fused_mlp_plain, l) for l in range(L)],
                                 mlp_w)
    k4r["was_ms"], _ = cuda_ms(torch, [lambda l=l: mlp(k4.fused_mlp_simt, l) for l in range(L)],
                               mlp_w)
    k4r["was"] = "dq_core's SIMT GEMV on the same bytes, fused_mlp_simt"
    k4r["library_ms"] = None
    detail["fused_mlp"] = k4r
    k5r = _k5_rows(torch, gen, dev, cfg)
    detail["flash_attention"] = k5r
    k6r = _k6_rows(torch, gen, dev)
    detail["w8a8_matmul"] = k6r
    k7r = _k7_rows(torch, gen, dev)
    detail["codebook_matmul"] = k7r
    k8r = _k8_row(torch, gen, dev, cfg)
    detail["decode_attention_write_bf16"] = k8r
    k9r = _k9_rows(torch, gen, dev)
    detail["moe_matmul"] = k9r
    k10r = _k10_rows(torch, gen, dev)
    detail["moe_gathered_matmul"] = k10r
    k11r = _k11_row(torch, gen, dev)
    detail["decode_attention_write"] = k11r
    k12r = _k12_rows(torch, gen, dev)
    detail["decode_attention_flash"] = k12r
    r9 = _row9_row(torch, gen, dev)
    detail["decode_attention_layer"] = r9
    k1o = _k1_option_rows(torch, gen, dev, cfg)
    detail["dequant_matmul_options"] = k1o
    k13r = _k13_rows(torch, gen, dev)
    detail["layer_boundary"] = k13r
    hdr = _head_dim_rows(torch, gen, dev)
    detail["head_dims"] = hdr
    f3 = _falcon3_matmul_rows(torch, ctx, gen, dev)
    detail["falcon3_matmuls"] = f3
    emit({"phase": "kernels", "card": ctx["smi"], "detail": detail})

    # one entry per kernel, at the work of one decode step (B = 8):
    # K1 = L x (qkv + o) + lm_head, K2/K3/K4 = L x one layer
    def step_sum(key):
        r = k1_rows
        return L * (r["qkv_decode"][key] + r["o_decode"][key]) + r["lm_head_decode"][key]

    k1_bound = step_sum("bound_ms")
    ctx["kernel_rows"] = {
        "dequant_matmul": {
            "route": "cuda", "source": "qtpu_torch/csrc/dequant_matmul.cu",
            "replaces": "qtpu/kernels/pallas_dequant_matmul.py:385",
            "max_abs_err": max(r["max_abs_err"] for r in k1_rows.values()),
            "ms": step_sum("ms"), "plain_ms": step_sum("plain_ms"), "bound_ms": k1_bound,
            "bound_by": "bytes", "library_ms": step_sum("library_ms"),
            "was_ms": step_sum("was_ms"),
        },
        "cache_band_write": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_attention.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:1067",
            "max_abs_err": float(code_diff),
            "ms": L * k2["ms"], "plain_ms": L * k2["plain_ms"], "bound_ms": L * k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": None, "was_ms": L * k2["was_ms"],
            "serial_ms": L * k2["serial_ms"],
        },
        "decode_attention": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_attention.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:1147",
            "max_abs_err": max(k3[w]["max_abs_err"] for w in ("window0", "window64")),
            "ms": L * k3["ms"], "plain_ms": L * k3["plain_ms"], "bound_ms": L * k3["bound_ms"],
            "bound_by": k3["bound_by"], "library_ms": L * k3["library_ms"],
            "was_ms": L * k3["was_ms"],
        },
        "fused_mlp": {
            "route": "cuda", "source": "qtpu_torch/csrc/fused_mlp.cu",
            "replaces": "qtpu/kernels/pallas_fused_mlp.py:221",
            "max_abs_err": k4r["max_abs_err"],
            "ms": L * k4r["ms"], "plain_ms": L * k4r["plain_ms"], "bound_ms": L * k4r["bound_ms"],
            "bound_by": k4r["bound_by"], "library_ms": None, "was_ms": L * k4r["was_ms"],
        },
        # K5 at the work of one eval block: L calls at the eval shape
        "flash_attention": {
            "route": "cuda", "source": "qtpu_torch/csrc/flash_attention.cu",
            "replaces": "qtpu/kernels/pallas_flash_attention.py:86",
            "max_abs_err": max(r["max_abs_err"] for r in k5r["cases"].values()),
            "ms": L * k5r["ms"], "plain_ms": L * k5r["plain_ms"], "bound_ms": L * k5r["bound_ms"],
            "bound_by": k5r["bound_by"], "library_ms": L * k5r["library_ms"],
            "was_ms": L * k5r["was_ms"],
        },
        # K6 at the work of one W8A8 eval block (M = 2048): L x (q, k, v, o,
        # gate, up, down) + lm_head; library: torch._int_mm on x_q
        "w8a8_matmul": {
            "route": "cuda", "source": "qtpu_torch/csrc/w8a8_matmul.cu",
            "replaces": "qtpu/kernels/pallas_int8_matmul.py:58",
            "max_abs_err": max(r["max_abs_err"] for r in k6r.values()),
            **{key: _k6_block(k6r, key, L) for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": _k6_bound_by(k6r, L), "library_ms": _k6_block(k6r, "int_mm_ms", L),
        },
        # K7 at the work of one decode step of the codebook model (M = 8):
        # L x (qkv, o, gateup, down) + lm_head; library: torch.matmul on the
        # weight dequantized to bf16 beforehand
        "codebook_matmul": {
            "route": "cuda", "source": "qtpu_torch/csrc/codebook_matmul.cu",
            "replaces": "qtpu/kernels/pallas_dequant_matmul.py:324",
            "max_abs_err": max(r["max_abs_err"] for r in k7r.values()),
            **{key: _k7_step(k7r, key, L) for key in ("ms", "plain_ms", "bound_ms",
                                                      "library_ms", "was_ms")},
            "bound_by": "bytes",
        },
        # K8 at the work of one decode step: L calls
        "decode_attention_write_bf16": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_attention.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:262",
            "max_abs_err": max(k8r[w]["max_abs_err"] for w in ("window0", "window64")),
            "ms": L * k8r["ms"], "plain_ms": L * k8r["plain_ms"], "bound_ms": L * k8r["bound_ms"],
            "bound_by": k8r["bound_by"], "library_ms": L * k8r["library_ms"],
            "was_ms": L * k8r["was_ms"],
        },
        # K9 at the work of one decode step of the serve_moe cell (B = 8, the
        # grouped route): MOE_LAYERS x (gate, up, down); library: torch.bmm
        # on the experts dequantized to bf16 beforehand
        "moe_matmul": {
            "route": "cuda", "source": "qtpu_torch/csrc/moe_matmul.cu",
            "replaces": "qtpu/kernels/pallas_moe_matmul.py:40",
            "max_abs_err": max(r["max_abs_err"] for r in k9r.values()),
            **{key: _moe_step(k9r, key) for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                    "was_ms")},
            "bound_by": "bytes",
        },
        # K10 at the work of one decode step of the 2-slot engine (4 routed
        # slots): MOE_LAYERS x (gate, up, down); library: torch.bmm on the
        # routed experts' bf16 weights gathered beforehand
        "moe_gathered_matmul": {
            "route": "cuda", "source": "qtpu_torch/csrc/moe_matmul.cu",
            "replaces": "qtpu/kernels/pallas_moe_matmul.py:165",
            "max_abs_err": max(r["max_abs_err"] for r in k10r.values()),
            **{key: _moe_step(k10r, key, "gathered") for key in ("ms", "plain_ms", "bound_ms",
                                                                 "library_ms", "was_ms")},
            "bound_by": "bytes", "body": k10r["gate_up"]["route"],
        },
        # K11 at the work of one decode step of the serve_moe cell: MOE_LAYERS calls
        "decode_attention_write": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_attention.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:313",
            "max_abs_err": max(k11r[w]["max_abs_err"] for w in ("window0", "window64")),
            **{key: MOE_LAYERS * k11r[key] for key in ("ms", "plain_ms", "bound_ms",
                                                       "library_ms", "was_ms")},
            "bound_by": k11r["bound_by"],
        },
        # K12 at the work of one decode step of the long_ctx cell: L calls at
        # B 8, S 32768 (its banded entries' rows are in the phase's detail)
        "decode_attention_flash": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_flash_decode.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:804",
            "max_abs_err": max(r["max_abs_err"] for r in k12r.values()),
            **{key: L * k12r["tinyllama_s32768"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                                  "library_ms", "was_ms")},
            "bound_by": k12r["tinyllama_s32768"]["bound_by"],
        },
        # the one-layer entry (K3's kernel) at the work of one decode step of
        # the serve_gpt2 cell: GPT-2's 12 layers at B 8, S 176
        "decode_attention_layer": {
            "route": "cuda", "source": "qtpu_torch/csrc/kv_attention.cu",
            "replaces": "qtpu/kernels/pallas_kv_attention.py:404",
            "max_abs_err": r9["max_abs_err"],
            **{key: GPT2_LAYERS * r9[key] for key in ("ms", "plain_ms", "bound_ms",
                                                      "library_ms", "was_ms")},
            "bound_by": r9["bound_by"],
        },
        # K13 at the work of one decode step of the boundary cell: L calls at
        # the TinyLlama layer, M 8, W4 g128 (its other shapes, and the chains
        # it replaces, are in the phase's detail)
        "layer_boundary": {
            "route": "cuda", "source": "qtpu_torch/csrc/layer_boundary.cu",
            "replaces": "qtpu/kernels/pallas_layer_boundary.py:139",
            "max_abs_err": max(r["max_abs_err"] for r in k13r.values()),
            **{key: L * k13r["TinyLlama-1.1B_w4_m8"][key] for key in ("ms", "plain_ms",
                                                                      "bound_ms", "was_ms")},
            "bound_by": k13r["TinyLlama-1.1B_w4_m8"]["bound_by"], "library_ms": None,
        },
        # K6's tensor-core GEMV at the work of one W8A8 decode step (M 8): L x
        # (q, k, v, o, gate, up, down) + lm_head; was: the dp4a GEMV's three
        # launches; library: torch.matmul on the weight dequantized to bf16
        "w8a8_matmul_gemv_tc": {
            "route": "cuda", "source": "qtpu_torch/csrc/w8a8_matmul.cu",
            "replaces": "qtpu/kernels/pallas_int8_matmul.py:58",
            "max_abs_err": max(k6r[f"{s}_decode"]["max_abs_err"] for s in K6_SITES),
            **{key: _k6_block(k6r, key, L, "decode") for key in ("ms", "plain_ms", "bound_ms",
                                                                 "was_ms")},
            "bound_by": _k6_bound_by(k6r, L, "decode"),
            "library_ms": _k6_block(k6r, "bf16_matmul_ms", L, "decode"),
        },
        # the attention kernels at head_dim 80 and 96 (csrc: the tile of the
        # next multiple of 64 on K5's Hopper body; K3's kernel and K12 on
        # the shared core at hd % 64 of 16, 32 or 48), at Falcon3-7B's
        # shapes (hd 256, G 3) and over their domain (DOMAIN_SHAPES: hd 8
        # to 136, G 48 and 64), at the work of one decode step (K5: one eval
        # block) of a 32-layer model at that head dim (28 at hd 256,
        # Falcon3-7B's): OPT-2.7B's at 80 (launches: the opt_2_7b phase's
        # and e2e's; at hd 256 the falcon3 phase's; none at the domain's)
        **{f"{name}_{tag}": {
            "route": "cuda", "replaces": f"qtpu/kernels/{ATTN_REPLACES[name]}",
            "source": "qtpu_torch/csrc/" + ("flash_attention.cu" if name == "flash_attention"
                                            else "kv_flash_decode.cu" if "flash" in name
                                            or "banded" in name else "kv_attention.cu"),
            "head_dim": r["hd"], "heads": r.get("H", r["KV"] * r.get("G", 1)),
            "kv_heads": r["KV"],
            "max_abs_err": r["max_abs_err"],
            **{key: (FALCON3_7B["num_layers"] if tag == "hd256" else HD_LAYERS) * r[key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": r["bound_by"],
        } for tag, rows in hdr.items() for name, r in rows.items()},
        # K1 and K4 at Falcon3-7B's widths (launches: the falcon3 phase's)
        **_falcon3_kernel_rows(f3),
        # K1's options at the work of one decode step of the fuse branch: L
        # calls each, norm_w at the qkv site and resid at the o site (M 8)
        **{f"dequant_matmul_{opt}": {
            "route": "cuda", "source": "qtpu_torch/csrc/dequant_matmul.cu",
            "replaces": "qtpu/kernels/pallas_dequant_matmul.py:385",
            "max_abs_err": max(r["max_abs_err"] for r in k1o.values()),
            **{key: L * k1o[row][key] for key in ("ms", "plain_ms", "bound_ms", "was_ms")},
            "bound_by": k1o[row]["bound_by"],
            "library_ms": None if k1o[row]["library_ms"] is None else L * k1o[row]["library_ms"],
        } for opt, row in (("norm_w", "norm_w_qkv"), ("resid", "resid_o"))},
        # K1's options on the Hopper route at the work of one fuse-branch
        # prefill (8 x 128 rows): L calls each, norm_w at qkv and resid at o;
        # was: the composed chain on the kernel; library: torch.matmul on the
        # bf16 weight with the norm, torch.addmm
        **{f"dequant_matmul_{opt}_wgmma": {
            "route": "cuda", "source": "qtpu_torch/csrc/dq_wgmma.cuh",
            "replaces": "qtpu/kernels/pallas_dequant_matmul.py:385",
            "max_abs_err": max(r["max_abs_err"] for k, r in k1o.items()
                               if k.startswith(f"{opt}_") and r.get("route") == "wgmma"),
            **{key: L * k1o[row][key] for key in ("ms", "plain_ms", "bound_ms", "was_ms",
                                                  "library_ms")},
            "bound_by": k1o[row]["bound_by"],
        } for opt, row in (("norm_w", f"norm_w_qkv_m{B * P}"), ("resid", f"resid_o_m{B * P}"))},
    }

    # K1's and K7's Hopper route (csrc/dq_wgmma.cuh) at the work of one
    # packed eval block (M 2048): L x (qkv, o, gateup, down) + lm_head;
    # library: torch.matmul on the weight dequantized to bf16 beforehand
    def block_sum(rows, key):
        return L * sum(rows[f"{s}_eval"][key] for s in K7_PER_LAYER) + rows["lm_head_eval"][key]

    route_sites = {}
    for name, rows, line in (("dequant_matmul_wgmma", k1_rows, 385),
                             ("codebook_matmul_wgmma", k7r, 324)):
        ctx["kernel_rows"][name] = {
            "route": "cuda", "source": "qtpu_torch/csrc/dq_wgmma.cuh",
            "replaces": f"qtpu/kernels/pallas_dequant_matmul.py:{line}",
            "max_abs_err": max(rows[f"{s}_{m}"]["max_abs_err"]
                               for s in K7_SITES for m in ("prefill", "eval")),
            **{key: block_sum(rows, key) for key in ("ms", "plain_ms", "bound_ms",
                                                     "library_ms")},
            "bound_by": "operations",
        }
        for site in K7_SITES:
            for m in ("prefill", "eval"):
                r = rows[f"{site}_{m}"]
                route_sites[f"{name.split('_')[0]}_{site}_{m}"] = {
                    "M": r["M"], "ms": r["ms"], "library_ms": r["library_ms"],
                    "over_library": r["ms"] / r["library_ms"],
                    "bound_share": r["bound_ms"] / r["ms"], "was_ms": r.get("was_ms"),
                    "route": r["route"]}
    # K1's options on the route at every timed M > 8, against their library call
    for n, r in k1o.items():
        if r.get("route") == "wgmma":
            route_sites[f"dequant_{n}"] = {
                "M": r["M"], "ms": r["ms"], "was_ms": r["was_ms"], "library_ms": r["library_ms"],
                "over_library": r["ms"] / r["library_ms"], "over_was": r["ms"] / r["was_ms"],
                "bound_share": r["bound_ms"] / r["ms"], "route": r["route"]}
    # K9 with its expert axis on the route (dq_wgmma.cuh) at every M > 8
    # case, against torch.bmm on the bf16 experts; the work of one serve_moe
    # prefill (8 x 128 rows): MOE_LAYERS x (gate, up, down)
    k9_route = {n: r for n, r in k9r.items() if r["M"] > 8}
    for n, r in k9_route.items():
        route_sites[f"moe_{n}"] = {
            "E": r["E"], "M": r["M"], "K": r["K"], "N": r["N"],
            "per_expert_input": r["per_expert_input"], "route": r["route"], "rule": r["rule"],
            "rel_err": r["rel_err"], "same_bits_two_calls": r["same_bits_two_calls"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "was_ms": r["was_ms"],
            "library_ms": r["library_ms"], "over_library": r["ms"] / r["library_ms"],
            "bound_ms": r["bound_ms"], "bound_share": r["bound_ms"] / r["ms"]}
    ctx["kernel_rows"]["moe_matmul_wgmma"] = {
        "route": "cuda", "source": "qtpu_torch/csrc/dq_wgmma.cuh",
        "replaces": "qtpu/kernels/pallas_moe_matmul.py:40",
        "max_abs_err": max(r["max_abs_err"] for r in k9_route.values()),
        **{key: MOE_LAYERS * (2 * k9r["gate_up_prefill"][key] + k9r["down_prefill"][key])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations",
    }
    # K6 on its int8 route (w8a8_matmul.cu) at the five sites, M 1024 and
    # 2048, against torch._int_mm on x_q and the bf16 matmul; the work of one
    # W8A8 prefill (M 1024): L x (q, k, v, o, gate, up, down) + lm_head
    for site in K6_SITES:
        for m in ("prefill", "eval"):
            r = k6r[f"{site}_{m}"]
            route_sites[f"w8a8_{site}_{m}"] = {
                "M": r["M"], "K": r["K"], "N": r["N"], "route": r["route"], "rule": r["rule"],
                "rel_err": r["rel_err"], "same_bits_two_calls": r["same_bits_two_calls"],
                "bits_equal_mma_body": r["bits_equal_earlier_body"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "was_ms": r["was_ms"],
                "library_ms": r["int_mm_ms"], "bf16_matmul_ms": r["bf16_matmul_ms"],
                "over_library": r["ms"] / r["int_mm_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_share": r["bound_ms"] / r["ms"]}
    ctx["kernel_rows"]["w8a8_matmul_wgmma"] = {
        "route": "cuda", "source": "qtpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "qtpu/kernels/pallas_int8_matmul.py:58",
        "max_abs_err": max(k6r[f"{s}_{m}"]["max_abs_err"] for s in K6_SITES
                           for m in ("prefill", "eval")),
        **{key: _k6_block(k6r, key, L, "prefill") for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": _k6_bound_by(k6r, L, "prefill"),
        "library_ms": _k6_block(k6r, "int_mm_ms", L, "prefill"),
    }
    worst = {}
    for name, v in route_sites.items():
        kernel = name.split("_")[0]
        worst[kernel] = max(worst.get(kernel, 0.0), v["over_library"])
    # the tensor-core decode GEMV (csrc/dq_gemv_tc.cuh) at every M <= 8 site
    # timed, and K5's Hopper body, each beside its earlier body on the same
    # bytes ("was"), its bound and its library call
    tc_sites = {}
    for kernel, rows in (("K1", {k: v for k, v in k1_rows.items() if k.endswith("_decode")}),
                         ("K6", {k: {**v, "library_ms": v["bf16_matmul_ms"]}
                                 for k, v in k6r.items() if k.endswith("_decode")}),
                         ("K13", {k: {**v, "library_ms": v["composed_chain_ms"]}
                                  for k, v in k13r.items()}),
                         ("K7", {k: v for k, v in k7r.items() if k.endswith("_decode")}),
                         ("K9", {k: v for k, v in k9r.items() if v["M"] <= 8}),
                         ("K4", {"layer": k4r}),
                         ("K1_options", {k: k1o[k] for k in ("norm_w_qkv", "resid_o")})):
        for name, r in rows.items():
            if "ms" not in r:
                continue
            tc_sites[f"{kernel}_{name}"] = {
                "route": r.get("route"), "ms": r["ms"], "was_ms": r.get("was_ms"),
                "bound_ms": r["bound_ms"], "library_ms": r.get("library_ms"),
                "over_library": r["ms"] / r["library_ms"] if r.get("library_ms") else None,
                "over_was": r["ms"] / r["was_ms"] if r.get("was_ms") else None,
                "bound_share": r["bound_ms"] / r["ms"]}
    for key, r in (("K5_eval", k5r), ("K5_mistral_hd128", k5r["mistral_hd128"])):
        tc_sites[key] = {"route": "wgmma", "ms": r["ms"], "was_ms": r["was_ms"],
                         "bound_ms": r["bound_ms"], "library_ms": r["library_ms"],
                         "over_library": r["ms"] / r["library_ms"],
                         "over_was": r["ms"] / r["was_ms"], "bound_share": r["bound_ms"] / r["ms"],
                         "tflops": r["tflops"]}
    emit({"phase": "kernels_decode_gemv_k5", "card": ctx["smi"], "sites": tc_sites})
    emit({"phase": "kernels_hopper_route", "card": ctx["smi"], "sites": route_sites,
          "worst_over_library": worst,
          "library": {"dequant": "torch.matmul on the dequantized weight",
                      "codebook": "torch.matmul on the dequantized weight",
                      "moe": "torch.bmm on the experts dequantized to bf16",
                      "w8a8": "torch._int_mm on x_q and the column-major int8 weight"}})
    t0 = time.perf_counter()
    extra_detail = _extras_kernel_rows(torch, ctx)
    emit({"phase": "kernels_extras", "card": ctx["smi"], "seconds": time.perf_counter() - t0,
          "detail": extra_detail})


EVAL_BLOCK = 2048  # test_block_size of the eval phase
# K6: (K, N) of TinyLlama-1.1B's W8A8 sites, and the M of each path
K6_SITES = {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632),
            "down": (5632, 2048), "lm_head": (2048, 32000)}
K6_M = {"decode": 8, "prefill": 1024, "eval": EVAL_BLOCK}
K6_PER_LAYER = {"q_o": 2, "k_v": 2, "gate_up": 2, "down": 1}  # calls per layer


def _k6_rows(torch, gen, dev):
    """K6 against its plain version at every W8A8 site of TinyLlama at
    decode, prefill and eval M (tolerance: the Pallas kernel's test, max
    |err| / max |ref| < 2e-2, and relative error < 2e-2), the route its
    counters saw against w8a8_route's rule (at M <= 8 refined by
    w8a8_gemv_route), two calls giving the same bits and the same bits as
    the earlier body (M > 8: the mma.sync body; M <= 8: the dp4a GEMV, at
    M 1 and 3 too): the int32 sums are exact and the epilogue's float order
    is the body's. Times: the kernel, the plain version, the earlier body on
    the same bytes ("was"), torch._int_mm on x quantized beforehand and the
    int8 weight made column-major beforehand (M >= 17 only), torch.matmul on
    the weight dequantized to bf16 beforehand, and the bound (int8 rate)."""
    from qtpu_torch.core.packing import dequantize_parts, quantize_pack
    from qtpu_torch.kernels import int8_matmul as k6

    rows = {}
    for site, (K, N) in K6_SITES.items():
        meta = (8, K, K, N)
        wbytes = K * N + 3 * N
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes)))
        qts = [quantize_pack(torch.randn(K, N, generator=gen, device=dev) * 0.02, 8, K)
               for _ in range(copies)]
        w_cm = [qt.data.t().contiguous().t() for qt in qts]  # column-major for _int_mm
        nlib = max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))
        w_bf = [dequantize_parts(qt.data, qt.scales, qt.zeros, 8, K) for qt in qts[:nlib]]
        for mname, M in K6_M.items():
            x = (torch.randn(M, K, generator=gen, device=dev) * 2).to(torch.bfloat16)
            q0 = qts[0]
            got, route = _route_taken(torch, k6.w8a8_matmul,
                                      lambda: k6.w8a8_matmul(x, q0.data, q0.scales, q0.zeros, meta))
            want = k6.w8a8_matmul_plain(x, q0.data, q0.scales, q0.zeros, meta)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max() / (want.float().abs().max() + 1e-6))
            rule = k6.w8a8_route(M, N, (q0.data.data_ptr(), q0.scales.data_ptr()))
            if rule == "gemv":
                rule = k6.w8a8_gemv_route(M, K, N, (x.data_ptr(), q0.data.data_ptr()))
            row = {"M": M, "K": K, "N": N, "err_max_over_max_ref": err,
                   "max_abs_err": float(diff.max()), "rel_err": rel_err(torch, got, want),
                   "bf16_equal_share": float((got == want).float().mean()), "tol": 2e-2,
                   "route": route, "rule": rule}
            if err >= 2e-2 or row["rel_err"] >= 2e-2 or not torch.isfinite(got.float()).all():
                raise AssertionError(f"K6 disagrees with its plain version: {row}")
            if route != row["rule"]:
                raise AssertionError(f"K6 ran the {route} body where its rule says {row['rule']}")
            earlier = k6.w8a8_matmul_mma if M > 8 else k6.w8a8_matmul_dp4a
            again = k6.w8a8_matmul(x, q0.data, q0.scales, q0.zeros, meta)
            body = earlier(x, q0.data, q0.scales, q0.zeros, meta)
            torch.cuda.synchronize()
            row["same_bits_two_calls"] = _bits_equal(torch, got, again)
            row["bits_equal_earlier_body"] = _bits_equal(torch, got, body)
            row["max_abs_diff_earlier_body"] = float((got.float() - body.float()).abs().max())
            if M <= 8:  # the dp4a body's bits at M 1 and 3 as well
                for m in (1, 3):
                    y = k6.w8a8_matmul(x[:m], q0.data, q0.scales, q0.zeros, meta)
                    y0 = k6.w8a8_matmul_dp4a(x[:m], q0.data, q0.scales, q0.zeros, meta)
                    torch.cuda.synchronize()
                    row[f"bits_equal_earlier_body_m{m}"] = _bits_equal(torch, y, y0)
            if not all(v for k, v in row.items() if k.startswith(("same_bits", "bits_equal"))):
                raise AssertionError(f"K6 differs call to call or from its earlier body: "
                                     f"{site} M {M} {row}")
            row["bound_ms"], row["bound_by"] = bound(M * K * 2 + wbytes + M * N * 2,
                                                     2 * M * K * N, INT8_OP_PER_S)
            row["ms"], row["timing"] = cuda_ms(
                torch, [lambda q=q: k6.w8a8_matmul(x, q.data, q.scales, q.zeros, meta)
                        for q in qts], wbytes)
            row["plain_ms"], _ = cuda_ms(
                torch, [lambda q=q: k6.w8a8_matmul_plain(x, q.data, q.scales, q.zeros, meta)
                        for q in qts], wbytes)
            row["was_ms"], _ = cuda_ms(
                torch, [lambda q=q: earlier(x, q.data, q.scales, q.zeros, meta) for q in qts],
                wbytes)
            row["was"] = ("w8a8_mma_kernel (mma.sync) on the same bytes, w8a8_matmul_mma"
                          if M > 8 else "the dp4a GEMV's three launches on the same bytes, "
                                        "w8a8_matmul_dp4a")
            row["int_mm_ms"] = None
            if M >= 17:
                xq, _ = k6.quantize_activations(x)
                row["int_mm_ms"], _ = cuda_ms(
                    torch, [lambda w=w: torch._int_mm(xq, w) for w in w_cm], K * N)
            row["bf16_matmul_ms"], _ = cuda_ms(
                torch, [lambda w=w: torch.matmul(x, w) for w in w_bf], K * N * 2)
            rows[f"{site}_{mname}"] = row
        del qts, w_cm, w_bf
    return rows


def _k6_block(rows, key, L, m="eval"):
    """A K6 column summed over the calls of one W8A8 eval block."""
    return L * sum(n * rows[f"{s}_{m}"][key] for s, n in K6_PER_LAYER.items()) + \
        rows[f"lm_head_{m}"][key]


def _k6_bound_by(rows, L, m="eval"):
    """Whether operations or bytes bound most of a W8A8 eval block's bound."""
    ops = L * sum(n * rows[f"{s}_{m}"]["bound_ms"] for s, n in K6_PER_LAYER.items()
                  if rows[f"{s}_{m}"]["bound_by"] == "operations")
    if rows[f"lm_head_{m}"]["bound_by"] == "operations":
        ops += rows[f"lm_head_{m}"]["bound_ms"]
    return "operations" if ops >= _k6_block(rows, "bound_ms", L, m) / 2 else "bytes"


# K7: (K, N) of TinyLlama-1.1B's fused codebook sites, their calls per layer
K7_SITES = {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 11264),
            "down": (5632, 2048), "lm_head": (2048, 32000)}
K7_M = {"decode": 8, "prefill": 1024, "eval": EVAL_BLOCK}
K7_GROUP = 128


def _codebook_site(torch, gen, dev, K, N, cb, group=K7_GROUP):
    """A [K, N] codebook site of random int4 codes and scales."""
    data = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev).to(torch.int8)
    scales = (torch.rand(K // group, N, generator=gen, device=dev) * 4e-3 + 1e-3)
    return data, scales.to(torch.bfloat16), cb


def _k7_rows(torch, gen, dev):
    """K7 against its plain version at every fused codebook site of
    TinyLlama at decode, prefill and eval M, on the POT levels (exact in
    bf16), and on the APOT levels (not exact) at one site per M (tolerance:
    the Pallas kernel's test, relative Frobenius < 2e-2 and atol 5% of the
    max), with times: the kernel, the plain version, torch.matmul on the
    weight dequantized to bf16 beforehand (the yardstick), and the bound."""
    from qtpu_torch.kernels import codebook_matmul as k7
    from qtpu_torch.quant.apot import full_apot_codebook
    from qtpu_torch.quant.pot import pot_codebook

    pot_cb = pot_codebook(4, device=dev)
    apot_cb = torch.from_numpy(full_apot_codebook(4, 2, 16)).to(dev)
    rows = {}

    def check(name, M, K, N, site, timed, group=K7_GROUP):
        data, scales, cb = site[0]
        meta = (4, group, K, N)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        got, route = _route_taken(torch, k7.codebook_matmul,
                                  lambda: k7.codebook_matmul(x, data, scales, cb, meta))
        want = k7.codebook_matmul_plain(x, data, scales, cb, meta)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        row = {"M": M, "K": K, "N": N, "group": group, "rel_err": rel_err(torch, got, want),
               "max_abs_err": float(diff.max()), "max_ref": float(want.float().abs().max()),
               "tol": "rel 2e-2, atol 5% of max |ref|", "route": route,
               "rule": _rule(k7.cb_route(M, N, group, (data.data_ptr(), scales.data_ptr())),
                             M, K, N, 4, group, (data.data_ptr(), scales.data_ptr()))}
        if (row["rel_err"] >= 2e-2 or row["max_abs_err"] > 0.05 * row["max_ref"]
                or not torch.isfinite(got.float()).all()):
            raise AssertionError(f"K7 disagrees with its plain version: {name} {row}")
        if route != row["rule"]:
            raise AssertionError(f"K7 ran the {route} body where its rule says {row['rule']}")
        if M > 8 or route == "gemv_tc":
            again = k7.codebook_matmul(x, data, scales, cb, meta)
            torch.cuda.synchronize()
            row["same_bits_two_calls"] = _bits_equal(torch, got, again)
            if not row["same_bits_two_calls"]:
                raise AssertionError(f"K7's two calls differ: {name} {row}")
        rows[name] = row
        if not timed:
            return
        wbytes = K * N / 2 + (K // K7_GROUP) * N * 2 + 64
        row["bound_ms"], row["bound_by"] = bound(wbytes + M * K * 2 + M * N * 2, 2 * M * K * N)
        row["ms"], row["timing"] = cuda_ms(
            torch, [lambda s=s: k7.codebook_matmul(x, *s, meta) for s in site], wbytes)
        row["plain_ms"], _ = cuda_ms(
            torch, [lambda s=s: k7.codebook_matmul_plain(x, *s, meta) for s in site], wbytes)
        if M <= 8:  # "was": dq_core's SIMT GEMV on the same bytes
            row["was_ms"], _ = cuda_ms(
                torch, [lambda s=s: k7.codebook_matmul_simt(x, *s, meta) for s in site], wbytes)
        nlib = max(1, min(len(site), math.ceil(2 * L2_BYTES / (K * N * 2))))
        wd = [k7.codebook_weight(*s, meta, torch.bfloat16) for s in site[:nlib]]
        row["library_ms"], _ = cuda_ms(torch, [lambda w=w: torch.matmul(x, w) for w in wd],
                                       K * N * 2)

    for sname, (K, N) in K7_SITES.items():
        wbytes = K * N / 2 + (K // K7_GROUP) * N * 2
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes)))
        site = [_codebook_site(torch, gen, dev, K, N, pot_cb) for _ in range(copies)]
        for mname, M in K7_M.items():
            check(f"{sname}_{mname}", M, K, N, site, True)
        if sname == "gateup":
            apot_site = [_codebook_site(torch, gen, dev, K, N, apot_cb)]
            for mname, M in K7_M.items():
                check(f"{sname}_{mname}_apot", M, K, N, apot_site, False)
        del site
    for M in (3, 8, 77, 1000, 1024):  # ragged M, and the serve CLI's default group of 64
        for group in (64, 128):
            check(f"m{M}_g{group}", M, 2048, 2560,
                  [_codebook_site(torch, gen, dev, 2048, 2560, pot_cb, group)], False, group)
    return rows


K7_PER_LAYER = ("qkv", "o", "gateup", "down")


def _k7_step(rows, key, L, m="decode"):
    """A K7 column summed over the calls of one decode step (or block)."""
    return L * sum(rows[f"{s}_{m}"][key] for s in K7_PER_LAYER) + rows[f"lm_head_{m}"][key]


def _k8_row(torch, gen, dev, cfg):
    """K8 against its plain version on the serve cell's bf16 cache (B 8,
    S 176, one slot inactive at pos = S), with and without a window of 64:
    the cache after the write equal to the plain write, the output within
    rtol/atol 3e-2 (the Pallas kernel's test); times over the L layers:
    kernel, plain version (eager), SDPA on the cache after a plain write
    (the yardstick) and the bound."""
    from qtpu_torch.kernels import kv_attention as k8

    B, S, L = SERVE_B, 176, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_all = torch.randn(L, B, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v_all = torch.randn(L, B, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
    row = {"cluster": _cluster(torch, k8, B, KV, S)}
    for window in (0, 64):
        kc, vc, kp, vp = k_all.clone(), v_all.clone(), k_all.clone(), v_all.clone()
        kw, vw = k_all.clone(), v_all.clone()
        got = k8.decode_attention_write_bf16(q, kn, vn, kc, vc, pos, 5, window=window)
        want = k8.decode_attention_write_bf16_plain(q, kn, vn, kp, vp, pos, 5, window=window)
        k8.decode_attention_write_bf16_simt(q, kn, vn, kw, vw, pos, 5, window=window)
        torch.cuda.synchronize()
        gt, wt = got[:-1].float(), want[:-1].float()  # the inactive slot is garbage by contract
        r = {"max_abs_err": float((gt - wt).abs().max()), "rel_err": rel_err(torch, gt, wt),
             "cache_equal": bool(torch.equal(kc, kp) and torch.equal(vc, vp)),
             "write_equal_was": bool(torch.equal(kc, kw) and torch.equal(vc, vw)),
             "finite_inactive_row": bool(torch.isfinite(got[-1].float()).all()),
             "tol": "cache equal (and equal to the earlier body's); rtol/atol 3e-2"}
        row[f"window{window}"] = r
        del kw, vw
        if (not r["cache_equal"] or not r["write_equal_was"] or not r["finite_inactive_row"]
                or not torch.allclose(gt, wt, rtol=3e-2, atol=3e-2)):
            raise AssertionError(f"K8 disagrees with its plain version: {row}")
    rows_read = sum(min(int(p), S - 1) + 1 for p in pos.tolist())
    active = sum(1 for p in pos.tolist() if p < S)
    nbytes = rows_read * KV * hd * 2 * 2 + active * KV * hd * 2 * 2 * 2 + 2 * B * H * hd * 2
    row["bound_ms"], row["bound_by"] = bound(nbytes, rows_read * H * hd * 4)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda l=l: k8.decode_attention_write_bf16(q, kn, vn, k_all, v_all, pos, l)
                for l in range(L)], nbytes)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k8.decode_attention_write_bf16_plain(q, kn, vn, k_all, v_all, pos, l)
                for l in range(L)], nbytes, reps=L, graph=False)
    row["was_ms"], _ = cuda_ms(
        torch, [lambda l=l: k8.decode_attention_write_bf16_simt(q, kn, vn, k_all, v_all, pos, l)
                for l in range(L)], nbytes)
    mask = k8.cache_mask(pos[:, None], S)[:, None]  # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], k_all[l], v_all[l], attn_mask=mask,
                                 enable_gqa=True) for l in range(L)], nbytes)
    row["library_call"] = "scaled_dot_product_attention(enable_gqa=True) on the written cache"
    return row


MOE_LAYERS = 4  # serve_moe's depth: 4 of Mixtral-8x7B's 32 layers, cut for the smoke's time
MOE_GROUP = 128
# K9's cases: (E, K, N, M, per-expert input) of Mixtral-8x7B's expert sites
# (gate and up share one shape) at decode and prefill M, and one expert site
# of Qwen2-57B-A14B (64 experts, intermediate 2560)
K9_CASES = {
    "gate_up_decode": (8, 4096, 14336, 8, False), "down_decode": (8, 14336, 4096, 8, True),
    "gate_up_prefill": (8, 4096, 14336, 1024, False),
    "down_prefill": (8, 14336, 4096, 1024, True),
    "qwen2_57b_gate_up_decode": (64, 3584, 2560, 8, False),
    "qwen2_57b_gate_up_prefill": (64, 3584, 2560, 1024, False),
}
K10_SLOTS = (1, 6, 3, 6)  # the 2-slot engine's 2 tokens x top-2, a repeated expert


def _k2_times(torch, gen, dev, cfg, kn, vn, cache, pos):
    """K2's times on the serve cell's cache, each pair in turns (a, b, b,
    a) in this run: 22 launches in a CUDA graph, K2 with programmatic
    dependent launch ("ms"), the same kernel launched without it
    ("serial_ms") and the earlier kernel ("was_ms"); and the order of a W4
    decode step, per layer K1 at the fused qkv site (M 8), RoPE on q and k,
    v made contiguous (the kernel K2 follows), K2 and K3, over the 22
    layers in a graph, with K2 launched with and without the attribute
    ("step_ms_pdl", "step_ms_serial")."""
    from qtpu_torch.kernels import dequant_matmul as k1
    from qtpu_torch.kernels import kv_attention as k23
    from qtpu_torch.models.ops import apply_rope, rope_tables

    L = cfg.num_layers
    B, KV, hd, H = kn.shape[0], cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    launches = {"ms": k23.cache_band_write, "serial_ms": k23.cache_band_write_serial,
                "was_ms": k23.cache_band_write_simt}

    def turns(calls_of, a, b):
        t = {a: [], b: []}
        for key in (a, b, b, a):
            t[key].append(cuda_ms(torch, calls_of(key), 0, reps=4 * L)[0])
        return {k: sum(v) / len(v) for k, v in t.items()}

    out = {}
    for other in ("serial_ms", "was_ms"):
        out.update(turns(lambda key: [lambda l=l, f=launches[key]: f(kn, vn, *cache, pos, l)
                                      for l in range(L)], "ms", other))
    qkv_n = cfg.q_dim + 2 * cfg.kv_dim
    site = _packed(torch, L, cfg.hidden_size, qkv_n, 4, 128, gen, dev)
    meta = (4, 128, cfg.hidden_size, qkv_n)
    x = torch.randn(B, 1, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_tables(pos[:, None].clamp(max=cache[0].shape[3] - 1), hd, cfg.rope_theta)

    def layer(l, band):
        qkv = k1.quantized_matmul(x, site[0][l], site[1][l], site[2][l], meta)
        q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        q = apply_rope(q.reshape(B, 1, H, hd), cos, sin)
        k = apply_rope(k.reshape(B, 1, KV, hd), cos, sin).contiguous()
        v = v.reshape(B, 1, KV, hd).contiguous()
        band(k, v, *cache, pos, l)
        return k23.decode_attention(q[:, 0].contiguous(), *cache, pos, l)

    step = turns(lambda key: [lambda l=l, f=launches[key]: layer(l, f) for l in range(L)],
                 "ms", "serial_ms")
    out["step_ms_pdl"] = L * step["ms"]
    out["step_ms_serial"] = L * step["serial_ms"]
    out["timing"] = ("graph; pairs in turns (a, b, b, a); step: K1 qkv, RoPE, v contiguous, "
                     f"K2, K3 on each of the {L} layers")
    return out


def _expert_site(torch, gen, dev, E, K, N, group=MOE_GROUP):
    """E experts of random [K, N] weights packed RTN W4, [E, ...] leaves."""
    from qtpu_torch.core.packing import quantize_pack

    parts = [quantize_pack(torch.randn(K, N, generator=gen, device=dev) * 0.02, 4, group)
             for _ in range(E)]
    return tuple(torch.stack([getattr(p, f) for p in parts]) for f in ("data", "scales", "zeros"))


def _dequant_experts(torch, site):
    from qtpu_torch.core.packing import dequantize_parts

    return torch.stack([dequantize_parts(site[0][e], site[1][e], site[2][e], 4, MOE_GROUP)
                        for e in range(site[0].shape[0])])


def _k9_rows(torch, gen, dev):
    """K9 against its plain version at Mixtral-8x7B's expert sites (decode M
    = 8, prefill M = 1024) and one Qwen2-57B-A14B site (tolerance: K1's,
    relative error < 2e-2), the route its counters saw against moe_route's
    rule, and at M > 8 two calls giving the same bits, with times: the
    kernel, the plain version, the mma.sync body on the same bytes (M > 8,
    "was"), torch.bmm on the experts dequantized to bf16 beforehand, and the
    bound (every expert's packed bytes and all products)."""
    from qtpu_torch.kernels import moe_matmul as k9

    rows, shape = {}, None
    for name, (E, K, N, M, per_expert) in K9_CASES.items():
        if (E, K, N) != shape:  # one site's weights on the card at a time
            shape, site, wd = (E, K, N), None, None
            site = _expert_site(torch, gen, dev, E, K, N)
            wd = _dequant_experts(torch, site)
        meta = (4, MOE_GROUP, K, N)
        x = torch.randn(*((E,) if per_expert else ()), M, K, generator=gen, device=dev)
        x = x.to(torch.bfloat16)
        got, route = _route_taken(
            torch, k9.moe_matmul,
            lambda: k9.moe_matmul(x, *site, meta, per_expert_input=per_expert))
        want = k9.moe_matmul_plain(x, *site, meta, per_expert_input=per_expert)
        torch.cuda.synchronize()
        ptrs = [t.data_ptr() for t in site]
        row = {"E": E, "M": M, "K": K, "N": N, "per_expert_input": per_expert,
               "rel_err": rel_err(torch, got, want),
               "max_abs_err": float((got.float() - want.float()).abs().max()), "tol_rel": 2e-2,
               "route": route,
               "rule": _rule(k9.moe_route(M, K, N, 4, MOE_GROUP, ptrs, per_expert), M, K, N, 4,
                             MOE_GROUP, ptrs)}
        if row["rel_err"] >= 2e-2 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K9 disagrees with its plain version: {name} {row}")
        if route != row["rule"]:
            raise AssertionError(f"K9 ran the {route} body where its rule says {row['rule']}")
        if M > 8 or route == "gemv_tc":
            again = k9.moe_matmul(x, *site, meta, per_expert_input=per_expert)
            torch.cuda.synchronize()
            row["same_bits_two_calls"] = _bits_equal(torch, got, again)
            if not row["same_bits_two_calls"]:
                raise AssertionError(f"K9's two calls differ: {name} {row}")
        wbytes = E * (K * N / 2 + (K // MOE_GROUP) * N * 3)
        row["bound_ms"], row["bound_by"] = bound(wbytes + x.numel() * 2 + E * M * N * 2,
                                                 2 * E * M * K * N)
        row["ms"], row["timing"] = cuda_ms(
            torch, [lambda: k9.moe_matmul(x, *site, meta, per_expert_input=per_expert)], wbytes)
        row["plain_ms"], _ = cuda_ms(
            torch, [lambda: k9.moe_matmul_plain(x, *site, meta, per_expert_input=per_expert)],
            wbytes)
        if M > 8:
            row["was_ms"], _ = cuda_ms(
                torch, [lambda: k9.moe_matmul_mma(x, *site, meta, per_expert_input=per_expert)],
                wbytes)
            row["was"] = "dq_mma_body (mma.sync) per expert on the same bytes, moe_matmul_mma"
        else:
            row["was_ms"], _ = cuda_ms(
                torch, [lambda: k9.moe_matmul_simt(x, *site, meta, per_expert_input=per_expert)],
                wbytes)
            row["was"] = "dq_core's SIMT GEMV on the same bytes, moe_matmul_simt"
        xb = x if per_expert else x.expand(E, M, K)
        row["library_ms"], _ = cuda_ms(torch, [lambda: torch.bmm(xb, wd)], wd.numel() * 2)
        rows[name] = row
    return rows


def _k10_rows(torch, gen, dev):
    """K10 against its plain version at 4 routed slots of Mixtral-8x7B's
    gate/up and down sites (tolerance: max |err| / max |ref| < 2e-2, the
    Pallas kernel's test), the route its counters saw against
    gathered_route's rule (the tensor-core body, one weight stream per
    distinct routed expert) with the cluster split the wrapper picks, two
    calls giving the same bits, and times: the kernel, dq_core's GEMV on the
    same bytes ("was", moe_gathered_matmul_simt: one slot a row tile), the
    plain version (eager: it reads the expert ids on the host), torch.bmm
    on the routed experts' bf16 weights gathered beforehand, and the bound
    (the distinct routed experts' packed bytes)."""
    from qtpu_torch.kernels import moe_matmul as k9
    from qtpu_torch.kernels.dequant_matmul import GEMV_TC_COLS, gemv_tc_split

    rows = {}
    eidx = torch.tensor(K10_SLOTS, dtype=torch.int32, device=dev)
    Gs, distinct = len(K10_SLOTS), len(set(K10_SLOTS))
    w = k9.moe_gathered_matmul
    for name, (K, N) in {"gate_up": (4096, 14336), "down": (14336, 4096)}.items():
        site = _expert_site(torch, gen, dev, 8, K, N)
        meta = (4, MOE_GROUP, K, N)
        x = torch.randn(Gs, K, generator=gen, device=dev).to(torch.bfloat16)
        t0 = w.gemv_tc_launches
        got = w(x, eidx, *site, meta)
        want = k9.moe_gathered_matmul_plain(x, eidx, *site, meta)
        was = k9.moe_gathered_matmul_simt(x, eidx, *site, meta)
        again = w(x, eidx, *site, meta)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ptrs = [t.data_ptr() for t in site]
        row = {"Gs": Gs, "experts": list(K10_SLOTS), "K": K, "N": N,
               "err_max_over_max_ref": float(diff.max() / (want.float().abs().max() + 1e-6)),
               "rel_err": rel_err(torch, got, want), "max_abs_err": float(diff.max()),
               "rel_err_vs_was": rel_err(torch, got, was),
               "tol": "max |err| / max |ref| < 2e-2",
               "route": "gemv_tc" if w.gemv_tc_launches > t0 else "gemv",
               "rule": k9.gathered_route(Gs, K, N, 4, MOE_GROUP, ptrs),
               "split": gemv_tc_split(x.device, K, N, MOE_GROUP,
                                      tiles=-(-N // GEMV_TC_COLS) * Gs),
               "same_bits_two_calls": _bits_equal(torch, got, again)}
        if row["err_max_over_max_ref"] >= 2e-2 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K10 disagrees with its plain version: {name} {row}")
        if row["route"] != row["rule"] or row["route"] != "gemv_tc":
            raise AssertionError(f"K10 ran the {row['route']} body, its rule says {row['rule']}")
        if not row["same_bits_two_calls"]:
            raise AssertionError(f"K10's two calls differ: {name} {row}")
        wbytes = distinct * (K * N / 2 + (K // MOE_GROUP) * N * 3)
        row["bound_ms"], row["bound_by"] = bound(wbytes + Gs * (K + N) * 2 + Gs * 4,
                                                 2 * Gs * K * N)
        row["ms"], row["timing"] = cuda_ms(torch, [lambda: w(x, eidx, *site, meta)], wbytes)
        row["was_ms"], _ = cuda_ms(
            torch, [lambda: k9.moe_gathered_matmul_simt(x, eidx, *site, meta)], wbytes)
        row["was"] = "dq_core's SIMT GEMV on the same bytes, moe_gathered_matmul_simt"
        row["plain_ms"], _ = cuda_ms(
            torch, [lambda: k9.moe_gathered_matmul_plain(x, eidx, *site, meta)], wbytes,
            reps=8, graph=False)
        wsel = _dequant_experts(torch, site)[eidx.long()]  # [Gs, K, N] bf16
        row["library_ms"], _ = cuda_ms(torch, [lambda: torch.bmm(x[:, None], wsel)],
                                       wsel.numel() * 2)
        rows[name] = row
        del site, wsel
    return rows


def _moe_step(rows, key, kind="grouped"):
    """A K9 (grouped) or K10 (gathered) column summed over the expert
    matmuls of one decode step of serve_moe's model: gate, up and down on
    each of its layers."""
    if kind == "grouped":
        return MOE_LAYERS * (2 * rows["gate_up_decode"][key] + rows["down_decode"][key])
    return MOE_LAYERS * (2 * rows["gate_up"][key] + rows["down"][key])


def _k11_row(torch, gen, dev):
    """K11 against its plain version on the serve_moe cell's int8 cache
    (Mixtral-8x7B: B 8, KV 8, G 4, hd 128, S 176, one slot inactive at
    pos = S; 32 layers, so the layers cycled exceed the L2), without and
    with a window of 64: the codes and scales written equal to the plain
    write's, the output within 2e-2 relative error of the plain version and
    rtol/atol 2e-2 of f32 math (the Pallas kernel's test);
    times: kernel, plain version (eager), SDPA(enable_gqa) on the cache
    dequantized to bf16 beforehand (the yardstick) and the bound."""
    from qtpu_torch.kernels import kv_attention as k11
    from qtpu_torch.models.config import MIXTRAL_8X7B as cfg
    from qtpu_torch.serve.kvcache import dequantize_kv

    B, S, L = SERVE_B, 176, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
             for _ in range(2)]
    cache += [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01 for _ in range(2)]
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
    row = {"cluster": _cluster(torch, k11, B, KV, S)}
    for window in (0, 64):
        kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
        got = k11.decode_attention_write(q, kn, vn, *kc, pos, 5, window=window)
        want = k11.decode_attention_write_plain(q, kn, vn, *pc, pos, 5, window=window)
        kw = [t.clone() for t in cache]
        k11.decode_attention_write_simt(q, kn, vn, *kw, pos, 5, window=window)
        write_equal_was = all(bool(torch.equal(a, b)) for a, b in zip(kc, kw))
        del kw
        # f32 math of the same function on the written cache: the reference
        # test_pallas_kernels.py holds the TPU kernel to (rtol/atol 2e-2)
        want32 = k11.decode_attention_write_plain(q.float(), kn, vn, *pc, pos, 5, window=window)
        torch.cuda.synchronize()
        # the last row (pos = S, an inactive batch slot) is garbage by contract
        gt, wt, w32 = got[:-1].float(), want[:-1].float(), want32[:-1]
        r = {"max_abs_err": float((gt - wt).abs().max()), "rel_err": rel_err(torch, gt, wt),
             "max_abs_err_vs_f32": float((gt - w32).abs().max()),
             "cache_equal": all(bool(torch.equal(a, b)) for a, b in zip(kc, pc)),
             "write_equal_was": write_equal_was,
             "finite_inactive_row": bool(torch.isfinite(got[-1].float()).all()),
             "tol": "codes and scales equal (and equal to the earlier body's); rel 2e-2 vs "
                    "plain; rtol/atol 2e-2 vs f32 math"}
        row[f"window{window}"] = r
        del kc, pc
        if (not r["cache_equal"] or not write_equal_was or not r["finite_inactive_row"]
                or r["rel_err"] >= 2e-2 or not torch.allclose(gt, w32, rtol=2e-2, atol=2e-2)):
            raise AssertionError(f"K11 disagrees with its plain version: {row}")
    rows_read = sum(min(int(p), S - 1) + 1 for p in pos.tolist())
    active = sum(1 for p in pos.tolist() if p < S)
    nbytes = (rows_read * KV * (2 * hd + 2 * 4) + active * KV * (2 * hd * 2 + 2 * hd + 2 * 4)
              + 2 * B * H * hd * 2 + B * 4)
    row["bound_ms"], row["bound_by"] = bound(nbytes, rows_read * H * hd * 4)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda l=l: k11.decode_attention_write(q, kn, vn, *cache, pos, l)
                for l in range(L)], nbytes)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k11.decode_attention_write_plain(q, kn, vn, *cache, pos, l)
                for l in range(L)], nbytes, reps=L, graph=False)
    row["was_ms"], _ = cuda_ms(
        torch, [lambda l=l: k11.decode_attention_write_simt(q, kn, vn, *cache, pos, l)
                for l in range(L)], nbytes)
    kd = dequantize_kv(cache[0][:4], cache[2][:4])
    vd = dequantize_kv(cache[1][:4], cache[3][:4])
    mask = k11.cache_mask(pos[:, None], S)[:, None]  # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask, enable_gqa=True)
                for l in range(4)], nbytes)
    row["library_call"] = "scaled_dot_product_attention(enable_gqa=True) on the cache dequantized to bf16"
    return row


def _k5_rows(torch, gen, dev, cfg):
    """K5 against its plain version at the eval shape (one layer of a
    TinyLlama eval block: B 1, H 32, KV 4, S 2048, hd 64) without and with a
    window of 256, at a ragged S = 1000 and at Mistral-7B's widths (hd 128,
    H 32, KV 8, S 2048, and its window of 4096 at S 4100); each on the route
    flash_route names (the Hopper body) and near the mma.sync body; then
    times at the eval shape and the Mistral-7B shape: the kernel, its
    mma.sync body on the same bytes ("was"), the plain version, SDPA (the
    yardstick, never on the path) and the bound from this run's shapes."""
    from qtpu_torch.kernels import flash_attention as k5

    def qkv(H, KV, S, hd):
        q = (torch.randn(1, H, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        k = (torch.randn(1, KV, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        v = torch.randn(1, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        return q, k, v

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cases = {}
    for name, (h, kv, S, d, window) in {
        "eval_shape": (H, KV, EVAL_BLOCK, hd, 0),
        "window256": (H, KV, EVAL_BLOCK, hd, 256),
        "ragged_s1000": (H, KV, 1000, hd, 0),
        "hd128": (32, 8, EVAL_BLOCK, 128, 0),
        "mistral_window4096_s4100": (32, 8, 4100, 128, 4096),
    }.items():
        q, k, v = qkv(h, kv, S, d)
        w0 = k5.flash_attention.wgmma_launches
        got = k5.flash_attention(q, k, v, window)
        route = "wgmma" if k5.flash_attention.wgmma_launches > w0 else "mma"
        want = k5.flash_attention_plain(q, k, v, window)
        was = k5.flash_attention_mma(q, k, v, window)
        torch.cuda.synchronize()
        err = rel_err(torch, got, want)
        cases[name] = {"H": h, "KV": kv, "S": S, "hd": d, "window": window, "rel_err": err,
                       "max_abs_err": float((got.float() - want.float()).abs().max()),
                       "rel_err_vs_mma_body": rel_err(torch, got, was), "route": route,
                       "rule": k5.flash_route(d, [t.data_ptr() for t in (q, k, v)],
                                              [s for t in (q, k, v) for s in t.stride()[:3]]),
                       "tol_rel": 2e-2}
        if err >= 2e-2 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K5 disagrees with its plain version: {cases[name]}")
        if route != cases[name]["rule"] or route != "wgmma":
            raise AssertionError(f"K5 ran the {route} body: {cases[name]}")
    row = {"cases": cases}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (h, kv, S, d) in (("eval", (H, KV, EVAL_BLOCK, hd)),
                               ("mistral_hd128", (32, 8, EVAL_BLOCK, 128))):
        io_bytes = 2 * (2 * h * S * d + 2 * kv * S * d)  # q, o and k, v in bf16
        pairs = S * (S + 1) // 2  # (query, key) pairs the causal mask keeps
        r = {"H": h, "KV": kv, "S": S, "hd": d}
        r["bound_ms"], r["bound_by"] = bound(io_bytes, 4 * h * d * pairs)
        n = max(1, min(8, math.ceil(2 * L2_BYTES / io_bytes)))
        sets = [qkv(h, kv, S, d) for _ in range(n)]
        r["ms"], r["timing"] = cuda_ms(
            torch, [lambda s=s: k5.flash_attention(*s, 0) for s in sets], io_bytes)
        r["was_ms"], _ = cuda_ms(
            torch, [lambda s=s: k5.flash_attention_mma(*s, 0) for s in sets], io_bytes)
        r["was"] = "the mma.sync body on the same bytes, flash_attention_mma"
        r["plain_ms"], _ = cuda_ms(
            torch, [lambda s=s: k5.flash_attention_plain(*s, 0) for s in sets], io_bytes)
        r["library_ms"], _ = cuda_ms(
            torch, [lambda s=s: sdpa(*s, is_causal=True, enable_gqa=True) for s in sets],
            io_bytes)
        r["library_call"] = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
        r["tflops"] = 4 * h * d * pairs / (r["ms"] * 1e-3) / 1e12
        if key == "eval":
            row.update(r)
        else:
            row[key] = r
        del sets
    return row


# The attention kernels at the head dims qtpu runs beside 64 and 128: (H, KV)
# of the shapes held and timed at each. MHA: OPT-2.7B's 32 heads of 80 (the
# opt_2_7b phase's shapes) and 32 heads of 96; GQA: the e2e llamas' 32 heads
# over 8 kv heads.
HD_MHA = (32, 32)
HD_GQA = (32, 8)
HD_LAYERS = 32  # the rows' step: OPT-2.7B's 32 layers
# the TPU kernel each attention entry replaces (qtpu/kernels/...)
ATTN_REPLACES = {
    "flash_attention": "pallas_flash_attention.py:86",
    "decode_attention": "pallas_kv_attention.py:1147",
    "decode_attention_write": "pallas_kv_attention.py:313",
    "decode_attention_layer": "pallas_kv_attention.py:404",
    "decode_attention_flash": "pallas_kv_attention.py:804",
    "decode_attention_write_bf16": "pallas_kv_attention.py:262",
    "decode_attention_write_banded": "pallas_kv_attention.py:554",
    "decode_attention_write_banded_stacked": "pallas_kv_attention.py:907",
}


def _k5_hd_row(torch, gen, dev, hd, heads=HD_MHA, cases=None):
    """K5 at head_dim hd on the Hopper body (the tile of the next multiple
    of 64): an eval block of a 32-head MHA model (B 1, S 2048; OPT-2.7B's at
    hd 80; `heads` (H, KV) another model's) without and with a window of 256,
    a ragged S of 1000 and a prefill of 8 x 128 (`cases`: those named),
    each within 2e-2 relative error of the plain version and on the route
    flash_route names; then times at the eval block: kernel, mma.sync body
    ("was"), plain version, SDPA(is_causal) and the bound from the true hd's
    operations."""
    from qtpu_torch.kernels import flash_attention as k5

    H, KV = heads

    def qkv(B, S):
        q = (torch.randn(B, H, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        k = (torch.randn(B, KV, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        v = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        return q, k, v

    row = {"H": H, "KV": KV, "hd": hd, "cases": {}}
    every = {"eval_block": (1, EVAL_BLOCK, 0), "window256": (1, EVAL_BLOCK, 256),
             "ragged_s1000": (1, 1000, 0), "prefill_8x128": (8, 128, 0)}
    for name, (B, S, window) in every.items():
        if cases is not None and name not in cases:
            continue
        q, k, v = qkv(B, S)
        w0 = k5.flash_attention.wgmma_launches
        got = k5.flash_attention(q, k, v, window)
        route = "wgmma" if k5.flash_attention.wgmma_launches > w0 else "mma"
        want = k5.flash_attention_plain(q, k, v, window)
        torch.cuda.synchronize()
        c = {"B": B, "S": S, "window": window, "rel_err": rel_err(torch, got, want),
             "max_abs_err": float((got.float() - want.float()).abs().max()), "route": route,
             "tol_rel": 2e-2}
        row["cases"][name] = c
        if c["rel_err"] >= 2e-2 or not torch.isfinite(got.float()).all() or route != "wgmma":
            raise AssertionError(f"K5 at head_dim {hd} disagrees or left its Hopper body: {c}")
    row["max_abs_err"] = max(c["max_abs_err"] for c in row["cases"].values())
    S = EVAL_BLOCK
    io_bytes = 2 * (2 * H * S * hd + 2 * KV * S * hd)
    pairs = S * (S + 1) // 2
    row["bound_ms"], row["bound_by"] = bound(io_bytes, 4 * H * hd * pairs)
    # the padded tile: P V at N = the next multiple of 64, Q K^T at hd
    hp = -(-hd // 64) * 64
    row["padded_ops_over_bound"] = (hd + hp) / (2 * hd)
    n = max(1, min(8, math.ceil(2 * L2_BYTES / io_bytes)))
    sets = [qkv(1, S) for _ in range(n)]
    row["ms"], row["timing"] = cuda_ms(torch, [lambda s=s: k5.flash_attention(*s, 0) for s in sets],
                                       io_bytes)
    row["was_ms"], _ = cuda_ms(torch, [lambda s=s: k5.flash_attention_mma(*s, 0) for s in sets],
                               io_bytes)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda s=s: k5.flash_attention_plain(*s, 0) for s in sets], io_bytes)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda s=s: sdpa(*s, is_causal=True, enable_gqa=True) for s in sets], io_bytes)
    row["library_call"] = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    row["tflops"] = 4 * H * hd * pairs / (row["ms"] * 1e-3) / 1e12
    return row


def _decode_hd_row(torch, gen, dev, hd, kind, heads=None):
    """One of K3's kernel's entries at head_dim hd against its plain
    version, at the serve cell's cache (B 8, S 176, one slot inactive at pos
    = S), without and with a window of 64, 8 layers cycled: kind "layer"
    (the one-layer entry, OPT-2.7B's int8 decode: MHA), "bf16" (K8, its bf16
    decode: MHA), "k3" (K3 on the stacked int8 cache: GQA) or "k11" (K11:
    GQA); `heads` (H, KV): another model's, for every kind. The int8 entries within 2e-2 relative error of the plain version
    and rtol/atol 2e-2 of f32 math, K8 within rtol/atol 3e-2, the writes
    equal to the plain ones (K8, K11), the cache read only (the others).
    Times: kernel, plain version (eager), SDPA on the cache (dequantized to
    bf16 beforehand) and the bound."""
    from qtpu_torch.kernels import kv_attention as k23
    from qtpu_torch.serve.kvcache import dequantize_kv

    B, S, L = SERVE_B, 176, 8
    H, KV = heads or (HD_MHA if kind in ("layer", "bf16") else HD_GQA)
    bf = kind == "bf16"
    if bf:
        cache = [torch.randn(L, B, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2)]
    else:
        cache = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen,
                               device=dev).to(torch.int8) for _ in range(2)]
        cache += [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01
                  for _ in range(2)]
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)

    def call(c, l, window=0, plain=False, qq=q):
        if kind == "layer":
            if plain:
                return k23.decode_attention_plain(qq, *c, pos, l, window=window)
            return k23.decode_attention_layer(qq, *(t[l] for t in c), pos, window=window)
        if kind == "k3":
            fn = k23.decode_attention_plain if plain else k23.decode_attention
            return fn(qq, *c, pos, l, window=window)
        fn = {"bf16": (k23.decode_attention_write_bf16, k23.decode_attention_write_bf16_plain),
              "k11": (k23.decode_attention_write, k23.decode_attention_write_plain)}[kind][plain]
        return fn(qq, kn, vn, *c, pos, l, window=window)

    row = {"kind": kind, "B": B, "H": H, "KV": KV, "hd": hd, "S": S,
           "cluster": _cluster(torch, k23, B, KV, S)}
    for window in (0, 64):
        kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
        got = call(kc, 3, window)
        want = call(pc, 3, window, plain=True)
        torch.cuda.synchronize()
        # the last row (pos = S, an inactive batch slot) is garbage by contract
        gt, wt = got[:-1].float(), want[:-1].float()
        r = {"max_abs_err": float((gt - wt).abs().max()), "rel_err": rel_err(torch, gt, wt),
             "cache_as_plain": all(bool(torch.equal(a, b)) for a, b in zip(kc, pc))}
        if bf:
            ok = bool(torch.allclose(gt, wt, rtol=3e-2, atol=3e-2))
            r["tol"] = "cache equal to the plain write; rtol/atol 3e-2"
        else:
            w32 = call(pc, 3, window, plain=True, qq=q.float())[:-1].float()
            r["max_abs_err_vs_f32"] = float((gt - w32).abs().max())
            ok = r["rel_err"] < 2e-2 and bool(torch.allclose(gt, w32, rtol=2e-2, atol=2e-2))
            r["tol"] = ("cache as the plain version leaves it; rel 2e-2 vs plain; "
                        "rtol/atol 2e-2 vs f32")
        row[f"window{window}"] = r
        del kc, pc
        if not ok or not r["cache_as_plain"] or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{kind} at head_dim {hd} disagrees with its plain version: {row}")
    row["max_abs_err"] = max(row[f"window{w}"]["max_abs_err"] for w in (0, 64))
    rows_read = sum(min(int(p), S - 1) + 1 for p in pos.tolist())
    active = sum(1 for p in pos.tolist() if p < S)
    per_row = 2 * hd * 2 if bf else 2 * hd + 2 * 4
    written = 0 if kind in ("layer", "k3") else active * KV * (
        2 * hd * 2 + (2 * hd * 2 if bf else 2 * hd + 2 * 4))  # new rows read and written
    nbytes = rows_read * KV * per_row + written + 2 * B * H * hd * 2 + B * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, rows_read * H * hd * 4)
    row["ms"], row["timing"] = cuda_ms(torch, [lambda l=l: call(cache, l) for l in range(L)],
                                       nbytes)
    row["plain_ms"], _ = cuda_ms(torch, [lambda l=l: call(cache, l, plain=True) for l in range(L)],
                                 nbytes, reps=L, graph=False)
    if bf:
        kd, vd = cache[0][:4], cache[1][:4]
    else:
        kd = dequantize_kv(cache[0][:4], cache[2][:4])
        vd = dequantize_kv(cache[1][:4], cache[3][:4])
    mask = k23.cache_mask(pos[:, None], S)[:, None]  # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask, enable_gqa=True)
                for l in range(4)], nbytes)
    row["library_call"] = ("scaled_dot_product_attention(enable_gqa=True) on the cache"
                           + ("" if bf else " dequantized to bf16"))
    return row


def _k12_hd_rows(torch, gen, dev, hd, heads=HD_GQA, S=None, flash_only=False):
    """K12's three entries at head_dim hd (the e2e llamas' GQA; `heads` (H,
    KV) another model's): the flash entry at B 8, S 32768 (or S; seven
    sequences in [S - 64, S), one inactive), and unless flash_only the
    stacked one on layer 5 of 8 and the banded one at the serve cell's
    cache (S 176); each against the plain version (_k12_case), with times:
    kernel, plain version (eager), SDPA on the cache dequantized to bf16
    and the bound."""
    from qtpu_torch.kernels import kv_attention as k12
    from qtpu_torch.serve.kvcache import dequantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV = heads
    G, rows = H // KV, {}
    S = S or LONG_S
    pos = [S - 64, S - 55, S - 46, S - 37, S - 28, S - 19, S - 1, S + 3]
    row, (cache, q, kn, vn, pos_t, entry) = _k12_case(torch, gen, dev, SERVE_B, KV, G, hd, S,
                                                      pos, 0)
    one = [t[0] for t in cache]
    row["ms"], row["timing"] = cuda_ms(torch, [lambda: entry(q, kn, vn, *one, pos_t)],
                                       row["bytes"], reps=20)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda: k12.flash_decode_plain(q, kn, vn, *one, pos_t)], row["bytes"], reps=3,
        graph=False)
    kd, vd = dequantize_kv(one[0], one[2]), dequantize_kv(one[1], one[3])
    mask = (torch.arange(S, device=dev)[None, :] < pos_t[:, None])[:, None, None, :]
    row["library_ms"], _ = cuda_ms(
        torch, [lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True)],
        row["bytes"], reps=20)
    rows["decode_attention_flash"] = row
    del cache, one, kd, vd
    torch.cuda.empty_cache()
    if flash_only:
        return rows
    L, S = 8, 176
    pos = [128, 130, 135, 140, 150, 160, 170, S]
    row, (cache, q, kn, vn, pos_t, entry) = _k12_case(torch, gen, dev, SERVE_B, KV, G, hd, S,
                                                      pos, 0, L=L, layer=5)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda l=l: entry(q, kn, vn, *cache, pos_t, l) for l in range(L)], row["bytes"])
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k12.flash_decode_plain(q, kn, vn, *(t[l] for t in cache), pos_t)
                for l in range(L)], row["bytes"], reps=L, graph=False)
    kd, vd = dequantize_kv(cache[0][:4], cache[2][:4]), dequantize_kv(cache[1][:4], cache[3][:4])
    mask = (torch.arange(S, device=dev)[None, :] < pos_t[:, None])[:, None, None, :]
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask, enable_gqa=True)
                for l in range(4)], row["bytes"])
    rows["decode_attention_write_banded_stacked"] = row
    brow, _ = _k12_case(torch, gen, dev, SERVE_B, KV, G, hd, S, pos, 0)
    banded = k12.decode_attention_write_banded
    brow["ms"], brow["timing"] = cuda_ms(
        torch, [lambda l=l: banded(q, kn, vn, *(t[l] for t in cache), pos_t) for l in range(L)],
        row["bytes"])
    brow.update(plain_ms=row["plain_ms"], library_ms=row["library_ms"])
    rows["decode_attention_write_banded"] = brow
    return rows


# the attention kernels' whole domain (hd a multiple of 8 from 8 to 256, any
# G) in the kernels phase: tag -> (hd, (H, KV)); hd 8-136 at the e2e llamas'
# GQA (G 4), G 48 and 64 on one kv head; hd 256 at Falcon3-7B's heads (G 3)
DOMAIN_SHAPES = {"hd8": (8, HD_GQA), "hd24": (24, HD_GQA), "hd40": (40, HD_GQA),
                 "hd72": (72, HD_GQA), "hd136": (136, HD_GQA), "g48_hd64": (64, (48, 1)),
                 "g64_hd64": (64, (64, 1)), "g48_hd128": (128, (48, 1)),
                 "g64_hd128": (128, (64, 1))}
FALCON3_HEADS = (12, 4)  # Falcon3-7B: 12 q heads, 4 kv heads of 256
DOMAIN_K12_S = 4096  # K12's flash entry at the domain shapes (S % 2048 == 0)


def _head_dim_rows(torch, gen, dev):
    """Every attention kernel at head_dim 80 and 96 (kernels phase), at
    Falcon3-7B's shapes (hd 256, G 3: the flash entry of K12 at S 32768)
    and over the domain (DOMAIN_SHAPES: K5 at the eval block causal and
    windowed, K12's flash entry at S 4096): K5, the four entries of K3's
    kernel and K12's entries, each against its plain version with its times
    (_k5_hd_row, _decode_hd_row, _k12_hd_rows). Returns {tag: {kernel:
    row}}, tags "hd80", "hd96", "hd256" and DOMAIN_SHAPES'."""
    out = {}
    shapes = {"hd80": (80, None), "hd96": (96, None), "hd256": (256, FALCON3_HEADS),
              **DOMAIN_SHAPES}
    for tag, (hd, heads) in shapes.items():
        domain = tag in DOMAIN_SHAPES
        rows = {"flash_attention": _k5_hd_row(
            torch, gen, dev, hd, heads or HD_MHA,
            cases=("eval_block", "window256") if domain else None)}
        for name, kind in (("decode_attention_layer", "layer"),
                           ("decode_attention_write_bf16", "bf16"),
                           ("decode_attention", "k3"), ("decode_attention_write", "k11")):
            rows[name] = _decode_hd_row(torch, gen, dev, hd, kind, heads)
        rows.update(_k12_hd_rows(torch, gen, dev, hd, heads or HD_GQA,
                                 S=DOMAIN_K12_S if domain else LONG_S, flash_only=domain))
        out[tag] = rows
        torch.cuda.empty_cache()
    return out


def _falcon3_matmul_rows(torch, ctx, gen, dev):
    """K1 at Falcon3-7B's sites (FALCON3_7B, W4 g128: qkv, o, gateup, down,
    lm_head) at decode (M 8), the serve prefill (M 1024) and the eval block
    (M 2048), and K4 at its MLP (D 3072, F 23040, M 8), each against its
    plain version at its band (K1 2e-2, K4 3e-2) with its times and bound
    (_k1_case, _k4_row). Returns {"<site>_<m>": row, "fused_mlp": row}."""
    c = FALCON3_7B
    D, F, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    q, kv = c["num_heads"] * hd, c["num_kv_heads"] * hd
    sites = {"qkv": (D, q + 2 * kv), "o": (q, D), "gateup": (D, 2 * F), "down": (F, D),
             "lm_head": (D, c["vocab_size"])}
    rows = {}
    for m, M in (("decode", SERVE_B), ("prefill", SERVE_B * SERVE_PROMPT), ("eval", EVAL_BLOCK)):
        for site, (K, N) in sites.items():
            rows[f"{site}_{m}"] = _k1_case(torch, ctx, gen, dev, M, K, N, 4, 128)
            torch.cuda.empty_cache()
    rows["fused_mlp"] = _k4_row(torch, gen, dev, SERVE_B, D, F, c["num_layers"])
    return rows


def _falcon3_kernel_rows(rows):
    """The kernels line's rows of _falcon3_matmul_rows, at Falcon3-7B's 28
    layers: K1 at the work of one decode step (L x (qkv + o) + lm_head, M
    8), K1 on the Hopper route at one eval block (L x (qkv, o, gateup, down)
    + lm_head, M 2048) and K4 at one decode step (L calls, M 8)."""
    L = FALCON3_7B["num_layers"]
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    k1 = {"route": "cuda", "replaces": "qtpu/kernels/pallas_dequant_matmul.py:385"}
    k4 = rows["fused_mlp"]

    def total(key, m, sites):
        return L * sum(rows[f"{s}_{m}"][key] for s in sites) + rows[f"lm_head_{m}"][key]

    return {
        "dequant_matmul_falcon3": {
            **k1, "source": "qtpu_torch/csrc/dequant_matmul.cu",
            "max_abs_err": max(rows[f"{s}_decode"]["max_abs_err"] for s in ("qkv", "o", "lm_head")),
            **{key: total(key, "decode", ("qkv", "o")) for key in keys}, "bound_by": "bytes"},
        "dequant_matmul_wgmma_falcon3": {
            **k1, "source": "qtpu_torch/csrc/dq_wgmma.cuh",
            "max_abs_err": max(r["max_abs_err"] for n, r in rows.items()
                               if n.endswith(("_prefill", "_eval"))),
            **{key: total(key, "eval", ("qkv", "o", "gateup", "down")) for key in keys},
            "bound_by": "operations"},
        "fused_mlp_falcon3": {
            "route": "cuda", "source": "qtpu_torch/csrc/fused_mlp.cu",
            "replaces": "qtpu/kernels/pallas_fused_mlp.py:221", "max_abs_err": k4["max_abs_err"],
            **{key: L * k4[key] for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": k4["bound_by"], "library_ms": None},
    }


LONG_S = 32768  # the long_ctx cell's cache: max_seq_len 32752 + decode_block 16
GPT2_LAYERS = 12  # GPT2_SMALL and OPT_125M


def _cluster(torch, mod, B, KV, S):
    """The cluster size K3's kernel launches with at these shapes."""
    return mod.decode_cluster(torch.cuda.get_device_properties(0).multi_processor_count, B, KV, S)


def _rows_kept(pos, S, window):
    """Cache rows K12 reads for these positions: s < pos (the whole of S for
    pos >= S), and s > pos - window when window > 0."""
    n = 0
    for p in pos:
        hi = max(0, min(p, S))
        lo = max(0, p - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def _k12_case(torch, gen, dev, B, KV, G, hd, S, pos, window, L=1, layer=0):
    """K12 against its plain version on one cache layer: the codes and
    scales written equal, the output within 3e-2 relative error (the Pallas
    kernels' test tolerance; both sides compute in f32). L > 1 runs the
    stacked entry on layer `layer`, else the flash entry (S % 2048 == 0) or
    the banded one. Returns (row, inputs)."""
    from qtpu_torch.kernels import kv_attention as k12

    cache = [torch.empty(L, B, KV, S, hd, dtype=torch.int8, device=dev).random_(
        -127, 128, generator=gen) for _ in range(2)]
    cache += [torch.empty(L, B, KV, S, device=dev).uniform_(0.01, 0.06, generator=gen)
              for _ in range(2)]
    q = torch.randn(B, KV * G, hd, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
    if L > 1:
        entry = k12.decode_attention_write_banded_stacked
        got = entry(q, kn, vn, *kc, pos_t, layer, window=window)
    else:
        entry = (k12.decode_attention_flash if S % k12.FLASH_SBLK == 0
                 else k12.decode_attention_write_banded)
        got = entry(q, kn, vn, *(t[0] for t in kc), pos_t, window=window)
    want = k12.flash_decode_plain(q, kn, vn, *(t[layer] for t in pc), pos_t, window=window)
    kw = [t[layer].clone() for t in cache]
    if hd in k12.SIMT_FLASH_HEAD_DIMS and G <= 32:  # the earlier split body
        k12.flash_decode_simt(q, kn, vn, *kw, pos_t, window=window)
    else:  # no earlier body at this shape: its write is the plain version's
        kw = [t[layer] for t in pc]
    torch.cuda.synchronize()
    row = {"entry": entry.__name__, "B": B, "KV": KV, "G": G, "hd": hd, "S": S, "L": L,
           "window": window, "pos": pos,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "rel_err": rel_err(torch, got, want),
           "cache_equal": all(bool(torch.equal(a, b)) for a, b in zip(kc, pc)),
           "write_equal_was": all(bool(torch.equal(a[layer], b)) for a, b in zip(kc, kw)),
           "finite": bool(torch.isfinite(got.float()).all()),
           "tol": "codes and scales equal (and equal to the earlier body's); rel 3e-2 vs plain"}
    del kc, pc, kw
    if (not row["cache_equal"] or not row["write_equal_was"] or not row["finite"]
            or row["rel_err"] >= 3e-2):
        raise AssertionError(f"K12 disagrees with its plain version: {row}")
    rows = _rows_kept(pos, S, window)
    active = sum(1 for p in pos if 0 <= p < S)
    H = KV * G
    row["bytes"] = (rows * KV * (2 * hd + 2 * 4) + active * KV * (2 * hd + 2 * 4)
                    + 2 * B * KV * hd * 2 + 2 * B * H * hd * 2 + B * 4)
    row["bound_ms"], row["bound_by"] = bound(row["bytes"], (rows + B) * H * hd * 4)
    return row, (cache, q, kn, vn, pos_t, entry)


def _k12_rows(torch, gen, dev):
    """K12's three entries against the plain version, with times: the
    long_ctx cell's layer (TinyLlama B 8, KV 4, G 8, hd 64, S 32768, seven
    sequences in [S - 64, S) and one inactive at S + 3) on the flash entry;
    Mistral-7B widths (B 4, KV 8, G 4, hd 128, S 32768, window 4096) on the
    flash entry; the banded entry and the stacked one at the serve cell's
    cache (B 8, S 176, 22 layers cycled). Beside each: the plain version
    (eager), SDPA(enable_gqa) on the cache dequantized to bf16 beforehand
    (the yardstick), the bound, and for the long cases K11 on a stacked
    cache of the same layer (what the stacked layout's decode pays there)."""
    from qtpu_torch.kernels import kv_attention as k12
    from qtpu_torch.serve.kvcache import dequantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    S = LONG_S
    spread = [S - 64, S - 55, S - 46, S - 37, S - 28, S - 19, S - 1]
    rows = {}
    for name, (B, KV, G, hd, pos, window) in {
        "tinyllama_s32768": (8, 4, 8, 64, spread + [S + 3], 0),
        "mistral_window4096": (4, 8, 4, 128, spread[:4], 4096),
    }.items():
        row, (cache, q, kn, vn, pos_t, entry) = _k12_case(torch, gen, dev, B, KV, G, hd, S, pos,
                                                          window)
        row["blocks_per_sm"] = k12.flash_blocks_per_sm(0, hd)  # the split body's occupancy
        row["nsplit"] = k12.flash_splits(torch.cuda.get_device_properties(0).multi_processor_count,
                                         row["blocks_per_sm"], B, KV, min(S, window or S))
        one = [t[0] for t in cache]
        row["ms"], row["timing"] = cuda_ms(
            torch, [lambda: entry(q, kn, vn, *one, pos_t, window=window)], row["bytes"], reps=20)
        row["plain_ms"], _ = cuda_ms(
            torch, [lambda: k12.flash_decode_plain(q, kn, vn, *one, pos_t, window=window)],
            row["bytes"], reps=3, graph=False)
        row["was_ms"], _ = cuda_ms(
            torch, [lambda: k12.flash_decode_simt(q, kn, vn, *one, pos_t, window=window)],
            row["bytes"], reps=20)
        row["k11_stacked_ms"], _ = cuda_ms(
            torch, [lambda: k12.decode_attention_write(q, kn, vn, *cache, pos_t, 0,
                                                       window=window)], row["bytes"], reps=5)
        kd, vd = dequantize_kv(one[0], one[2]), dequantize_kv(one[1], one[3])
        mask = torch.arange(S, device=dev)[None, :] < pos_t[:, None]
        if window:
            mask &= torch.arange(S, device=dev)[None, :] > pos_t[:, None] - window
        mask = mask[:, None, None, :]
        row["library_ms"], _ = cuda_ms(
            torch, [lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True)],
            row["bytes"], reps=20)
        row["library_call"] = ("scaled_dot_product_attention(enable_gqa=True) on the cache "
                               "dequantized to bf16")
        rows[name] = row
        del cache, one, kd, vd
        torch.cuda.empty_cache()
    # the banded entries at the serve cell's cache: 22 layers cycled
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg

    L, S = cfg.num_layers, 176
    pos = [128, 130, 135, 140, 150, 160, 170, S]
    row, (cache, q, kn, vn, pos_t, entry) = _k12_case(
        torch, gen, dev, SERVE_B, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
        cfg.head_dim, S, pos, 0, L=L, layer=5)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda l=l: entry(q, kn, vn, *cache, pos_t, l) for l in range(L)], row["bytes"])
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k12.flash_decode_plain(q, kn, vn, *(t[l] for t in cache), pos_t)
                for l in range(L)], row["bytes"], reps=L, graph=False)
    row["was_ms"], _ = cuda_ms(
        torch, [lambda l=l: k12.flash_decode_simt(q, kn, vn, *(t[l] for t in cache), pos_t)
                for l in range(L)], row["bytes"])
    kd, vd = dequantize_kv(cache[0][:4], cache[2][:4]), dequantize_kv(cache[1][:4], cache[3][:4])
    mask = (torch.arange(S, device=dev)[None, :] < pos_t[:, None])[:, None, None, :]
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask, enable_gqa=True)
                for l in range(4)], row["bytes"])
    rows["stacked_s176"] = row
    # the banded entry checked on a layer of its own, timed on the stacked
    # cache's 22 layer views (the same kernel; plain and SDPA as above)
    brow, _ = _k12_case(torch, gen, dev, SERVE_B, cfg.num_kv_heads,
                        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, S, pos, 0)
    banded = k12.decode_attention_write_banded
    brow["ms"], brow["timing"] = cuda_ms(
        torch, [lambda l=l: banded(q, kn, vn, *(t[l] for t in cache), pos_t) for l in range(L)],
        row["bytes"])
    brow.update(plain_ms=row["plain_ms"], library_ms=row["library_ms"], was_ms=row["was_ms"])
    rows["banded_s176"] = brow
    return rows


def _row9_row(torch, gen, dev):
    """The one-layer decode attention (pallas_decode_attention's function,
    K3's kernel on a [1, ...] view) at GPT-2's serve shape: B 8, KV 12, G 1,
    hd 64, S 176, one slot inactive at pos = S; 12 layers cycled. Within 2e-2
    of the plain version and rtol/atol 2e-2 of f32 math; the cache is read
    only. Times: kernel, plain, SDPA on the cache dequantized beforehand,
    the bound."""
    from qtpu_torch.kernels import kv_attention as k23
    from qtpu_torch.models.config import GPT2_SMALL as cfg
    from qtpu_torch.serve.kvcache import dequantize_kv

    L, B, S = GPT2_LAYERS, SERVE_B, 176
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
             for _ in range(2)]
    cache += [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01 for _ in range(2)]
    before = [t.clone() for t in cache]
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([128, 130, 135, 140, 150, 160, 170, S], dtype=torch.int32, device=dev)
    got = k23.decode_attention_layer(q, *(t[3] for t in cache), pos)
    want = k23.decode_attention_plain(q, *cache, pos, 3)
    want32 = k23.decode_attention_plain(q.float(), *cache, pos, 3)
    torch.cuda.synchronize()
    gt, wt, w32 = got[:-1].float(), want[:-1].float(), want32[:-1]
    row = {"B": B, "KV": KV, "G": H // KV, "hd": hd, "S": S,
           "max_abs_err": float((gt - wt).abs().max()), "rel_err": rel_err(torch, gt, wt),
           "max_abs_err_vs_f32": float((gt - w32).abs().max()),
           "read_only": all(bool(torch.equal(a, b)) for a, b in zip(cache, before)),
           "tol": "rel 2e-2 vs plain; rtol/atol 2e-2 vs f32 math"}
    del before
    if (row["rel_err"] >= 2e-2 or not row["read_only"]
            or not torch.allclose(gt, w32, rtol=2e-2, atol=2e-2)):
        raise AssertionError(f"the one-layer decode attention disagrees: {row}")
    rows_read = sum(min(int(p), S - 1) + 1 for p in pos.tolist())
    nbytes = rows_read * KV * (2 * hd + 2 * 4) + 2 * B * H * hd * 2 + B * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, rows_read * H * hd * 4)
    row["ms"], row["timing"] = cuda_ms(
        torch, [lambda l=l: k23.decode_attention_layer(q, *(t[l] for t in cache), pos)
                for l in range(L)], nbytes)
    row["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k23.decode_attention_plain(q, *cache, pos, l) for l in range(L)],
        nbytes)
    row["was_ms"], _ = cuda_ms(  # K3's earlier body on the same layer views
        torch, [lambda l=l: k23.decode_attention_simt(q, *cache, pos, l) for l in range(L)],
        nbytes)
    row["cluster"] = _cluster(torch, k23, B, KV, S)
    kd, vd = dequantize_kv(cache[0][:4], cache[2][:4]), dequantize_kv(cache[1][:4], cache[3][:4])
    mask = k23.cache_mask(pos[:, None], S)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l], attn_mask=mask)
                for l in range(4)], nbytes)
    row["library_call"] = "scaled_dot_product_attention on the cache dequantized to bf16"
    return row


K13_GROUP = 128
# (model, bits, M) of the K13 rows: the TinyLlama layer of the boundary cell
# at M 1, 8, 32 in W4 and W8, and one Llama-2-7B layer at M 8 in W4
K13_CASES = (("TinyLlama-1.1B", 4, 1), ("TinyLlama-1.1B", 4, 8), ("TinyLlama-1.1B", 4, 32),
             ("TinyLlama-1.1B", 8, 1), ("TinyLlama-1.1B", 8, 8), ("TinyLlama-1.1B", 8, 32),
             ("Llama-2-7B", 4, 8))


def _boundary_shapes(cfg):
    """(K, N) of the o, gateup, down and qkv sites of a layer of cfg."""
    D, F, Q = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    return ((Q, D), (D, 2 * F), (F, D), (D, Q + 2 * cfg.kv_dim))


def _site_bytes(K, N, bits, group):
    return K * N * bits / 8 + (K // group) * N * 3  # packed codes, bf16 scales, uint8 zeros


def _k13_case(torch, gen, dev, name, cfg, bits, M):
    """K13 at one layer of cfg (layers l and l + 1 of freshly packed stacks,
    enough copies to exceed L2), against its plain version (relative error
    of y2 - x and of qkv, 2e-2), the tiles its counters saw against
    boundary_route's rule, two calls giving the same bits, with the times of
    the kernel, the plain version, its earlier body on the same views (the
    dq_core tiles, layer_boundary_dq: "was") and the chains it replaces: the
    composed K1(o) + residual + K4 + rms_norm + K1(qkv) of the default
    decode step, and K1(o, resid) + K4 + K1(qkv, norm_w) of the fuse
    branch."""
    from qtpu_torch.kernels import fused_mlp as k4
    from qtpu_torch.kernels import layer_boundary as k13
    from qtpu_torch.kernels.dequant_matmul import quantized_matmul as k1
    from qtpu_torch.models.ops import rms_norm

    g = K13_GROUP
    shapes = _boundary_shapes(cfg)
    D, F, Q, Nq = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, shapes[3][1]
    wbytes = sum(_site_bytes(K, N, bits, g) for K, N in shapes)
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / wbytes)))
    stacks = [_packed(torch, copies + 1, K, N, bits, g, gen, dev) for K, N in shapes]
    metas = tuple((bits, g, K, N) for K, N in shapes)
    attn = torch.randn(M, Q, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)
    mn = (1.0 + 0.1 * torch.randn(copies + 1, D, generator=gen, device=dev)).to(torch.bfloat16)
    an = (1.0 + 0.1 * torch.randn(copies + 1, D, generator=gen, device=dev)).to(torch.bfloat16)

    def view(k, i):
        return dict(zip(("data", "scales", "zeros"), (t[i] for t in stacks[k])))

    def call(fn, i):
        return fn(attn, x, mn[i], an[i + 1], view(0, i), view(1, i), view(2, i), view(3, i + 1),
                  metas, eps=cfg.norm_eps)

    def chain(i, fuse):
        o, gu, dn, q = view(0, i), view(1, i), view(2, i), view(3, i + 1)
        if fuse:
            y = k1(attn, o["data"], o["scales"], o["zeros"], metas[0], resid=x)
        else:
            y = x + k1(attn, o["data"], o["scales"], o["zeros"], metas[0])
        y2 = k4.fused_mlp(y, mn[i], gu["data"], gu["scales"], gu["zeros"], dn["data"],
                          dn["scales"], dn["zeros"], metas[1], metas[2], eps=cfg.norm_eps)
        if fuse:
            return y2, k1(y2, q["data"], q["scales"], q["zeros"], metas[3], norm_w=an[i + 1],
                          eps=cfg.norm_eps)
        return y2, k1(rms_norm(y2, an[i + 1], cfg.norm_eps), q["data"], q["scales"], q["zeros"],
                      metas[3])

    n0, t0 = k13.layer_boundary.launches, k13.layer_boundary.gemv_tc_launches
    y2, qkv = call(k13.layer_boundary, 0)
    want_y2, want_qkv = call(k13.layer_boundary_plain, 0)
    again = call(k13.layer_boundary, 0)
    was_y2, was_qkv = call(k13.layer_boundary_dq, 0)
    torch.cuda.synchronize()
    if k13.layer_boundary.launches != n0 + 2:
        raise AssertionError("K13 did not count its launches")
    route = "gemv_tc" if k13.layer_boundary.gemv_tc_launches == t0 + 2 else "gemv"
    ptrs = [attn.data_ptr()] + [t[0].data_ptr() for t in stacks[0] + stacks[1] + stacks[2]] + \
        [t[1].data_ptr() for t in stacks[3]]
    err_y, err_q = rel_err(torch, y2.float() - x.float(), want_y2.float() - x.float()), \
        rel_err(torch, qkv, want_qkv)
    tc = route == "gemv_tc"
    row = {"model": name, "bits": bits, "group": g, "M": M, "D": D, "F": F, "Q": Q,
           "Nq": Nq, "route": route, "rule": k13.boundary_route(metas, ptrs),
           "grid_blocks": k13._grid(dev.index or 0, bits, g, tc),
           "grid_blocks_was": k13._grid(dev.index or 0, bits, g, False),
           "plan": k13.plan(metas, M, k13._grid(dev.index or 0, bits, g, tc), tc),
           "rel_err_y2_minus_x": err_y, "rel_err_qkv": err_q,
           "rel_err_vs_was": max(rel_err(torch, y2.float() - x.float(),
                                         was_y2.float() - x.float()),
                                 rel_err(torch, qkv, was_qkv)),
           "same_bits_two_calls": _bits_equal(torch, y2, again[0])
           and _bits_equal(torch, qkv, again[1]),
           "max_abs_err": max(float((y2.float() - want_y2.float()).abs().max()),
                              float((qkv.float() - want_qkv.float()).abs().max())),
           "tol_rel": 2e-2, "weight_mb": wbytes / 1e6}
    ok = all(bool(torch.isfinite(t.float()).all()) for t in (y2, qkv))
    if err_y >= 2e-2 or err_q >= 2e-2 or row["rel_err_vs_was"] >= 2e-2 or not ok:
        raise AssertionError(f"K13 disagrees with its plain version or its earlier body: {row}")
    if route != row["rule"] or route != "gemv_tc" or not row["same_bits_two_calls"]:
        raise AssertionError(f"K13 ran the {route} tiles where its rule says {row['rule']}, "
                             f"or differs call to call: {row}")
    nbytes = wbytes + M * (Q + D) * 2 + M * (D + Nq) * 2 + 2 * D * 2
    ops = 2 * M * sum(K * N for K, N in shapes)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
    row["ms"], row["timing"] = cuda_ms(torch, [lambda i=i: call(k13.layer_boundary, i)
                                               for i in range(copies)], wbytes)
    row["plain_ms"], _ = cuda_ms(torch, [lambda i=i: call(k13.layer_boundary_plain, i)
                                         for i in range(copies)], wbytes)
    row["was_ms"], _ = cuda_ms(torch, [lambda i=i: call(k13.layer_boundary_dq, i)
                                       for i in range(copies)], wbytes)
    row["was"] = "the dq_core tiles (dq_tile) on the same views, layer_boundary_dq"
    row["composed_chain_ms"], _ = cuda_ms(torch, [lambda i=i: chain(i, False)
                                                  for i in range(copies)], wbytes)
    row["fuse_chain_ms"], _ = cuda_ms(torch, [lambda i=i: chain(i, True)
                                              for i in range(copies)], wbytes)
    row["library_ms"] = None  # no one PyTorch call computes the layer boundary
    del stacks
    return row


def _k13_rows(torch, gen, dev):
    from qtpu_torch.models.config import LLAMA2_7B, TINYLLAMA_1_1B

    cfgs = {"TinyLlama-1.1B": TINYLLAMA_1_1B, "Llama-2-7B": LLAMA2_7B}
    rows = {f"{m}_w{bits}_m{M}": _k13_case(torch, gen, dev, m, cfgs[m], bits, M)
            for m, bits, M in K13_CASES}
    torch.cuda.empty_cache()
    return rows


def _k1_option_rows(torch, gen, dev, cfg):
    """K1 with norm_w at the TinyLlama qkv site and with resid at its o site
    (M 8, W4 g128), each beside K1 alone on the same input, the composed ops
    it replaces (rms_norm + K1; K1 + add) and its plain version; library for
    resid: torch.addmm on the weight dequantized to bf16. The same at M 16,
    32, 64, 1024 and 2048 on the Hopper route. Untimed checks at M 1, 8, 32
    and 300, W4 and W8, asymmetric and symmetric, both options."""
    from qtpu_torch.core.packing import dequantize_parts
    from qtpu_torch.kernels.dequant_matmul import quantized_matmul as k1
    from qtpu_torch.kernels.dequant_matmul import quantized_matmul_plain, quantized_matmul_simt
    from qtpu_torch.models.ops import rms_norm

    D, g, B = cfg.hidden_size, 128, SERVE_B
    qkv_n = cfg.q_dim + 2 * cfg.kv_dim
    rows = {}
    for name, (K, N), opt in (("norm_w_qkv", (D, qkv_n), "norm_w"), ("resid_o", (cfg.q_dim, D), "resid")):
        wbytes = _site_bytes(K, N, 4, g)
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes)))
        data, scales, zeros = _packed(torch, copies, K, N, 4, g, gen, dev)
        meta = (4, g, K, N)
        x = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
        nw = (1.0 + 0.1 * torch.randn(copies, K, generator=gen, device=dev)).to(torch.bfloat16)
        r = torch.randn(B, N, generator=gen, device=dev).to(torch.bfloat16)

        def kw(i):
            return {"norm_w": nw[i], "eps": cfg.norm_eps} if opt == "norm_w" else {"resid": r}

        got = k1(x, data[0], scales[0], zeros[0], meta, **kw(0))
        want = quantized_matmul_plain(x, data[0], scales[0], zeros[0], meta, **kw(0))
        torch.cuda.synchronize()
        err = rel_err(torch, got, want)
        row = {"M": B, "K": K, "N": N, "bits": 4, "group": g, "option": opt, "rel_err": err,
               "max_abs_err": float((got.float() - want.float()).abs().max()), "tol_rel": 2e-2}
        if err >= 2e-2 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K1 with {opt} disagrees with its plain version: {row}")
        nbytes = wbytes + B * K * 2 + B * N * 2 * (2 if opt == "resid" else 1) + (K * 2 if opt == "norm_w" else 0)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * B * K * N)
        row["ms"], row["timing"] = cuda_ms(
            torch, [lambda i=i: k1(x, data[i], scales[i], zeros[i], meta, **kw(i))
                    for i in range(copies)], wbytes)
        row["was_ms"], _ = cuda_ms(
            torch, [lambda i=i: quantized_matmul_simt(x, data[i], scales[i], zeros[i], meta,
                                                      **kw(i)) for i in range(copies)], wbytes)
        row["was"] = "dq_core's SIMT GEMV on the same bytes, quantized_matmul_simt"
        row["k1_alone_ms"], _ = cuda_ms(
            torch, [lambda i=i: k1(x, data[i], scales[i], zeros[i], meta) for i in range(copies)],
            wbytes)
        if opt == "norm_w":
            composed = [lambda i=i: k1(rms_norm(x, nw[i], cfg.norm_eps), data[i], scales[i],
                                       zeros[i], meta) for i in range(copies)]
        else:
            composed = [lambda i=i: r + k1(x, data[i], scales[i], zeros[i], meta)
                        for i in range(copies)]
        row["composed_ms"], _ = cuda_ms(torch, composed, wbytes)
        row["plain_ms"], _ = cuda_ms(
            torch, [lambda i=i: quantized_matmul_plain(x, data[i], scales[i], zeros[i], meta,
                                                       **kw(i)) for i in range(copies)], wbytes)
        row["library_ms"] = None
        if opt == "resid":
            nlib = max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))
            wd = [dequantize_parts(data[i], scales[i], zeros[i], 4, g) for i in range(nlib)]
            row["library_ms"], _ = cuda_ms(torch, [lambda i=i: torch.addmm(r, x, wd[i])
                                                   for i in range(nlib)], K * N * 2)
            row["library_call"] = "torch.addmm on the weight dequantized to bf16"
        rows[name] = row
    # above 8 rows the options take the Hopper route (csrc/dq_wgmma.cuh's OPT
    # instances): the fuse branch's decode at 16-64 rows, its prefill (M
    # 1024) and an eval-sized block (M 2048), each against the plain version,
    # the composed chain it replaces ("was": rms_norm + K1, K1 + add) and the
    # library yardstick (torch.matmul on the bf16 weight plus the norm or add)
    for opt, (K, N), site in (("norm_w", (D, qkv_n), "qkv"), ("resid", (cfg.q_dim, D), "o")):
        wbytes = _site_bytes(K, N, 4, g)
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes)))
        data, scales, zeros = _packed(torch, copies, K, N, 4, g, gen, dev)
        meta = (4, g, K, N)
        nw = (1.0 + 0.1 * torch.randn(copies, K, generator=gen, device=dev)).to(torch.bfloat16)
        nlib = max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))
        wd = [dequantize_parts(data[i], scales[i], zeros[i], 4, g) for i in range(nlib)]
        for M in (16, 32, 64, 1024, EVAL_BLOCK):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            r = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)

            def kw(i):
                return {"norm_w": nw[i], "eps": cfg.norm_eps} if opt == "norm_w" else {"resid": r}

            w0 = k1.wgmma_launches
            got = k1(x, data[0], scales[0], zeros[0], meta, **kw(0))
            route = "wgmma" if k1.wgmma_launches > w0 else "other"
            want = quantized_matmul_plain(x, data[0], scales[0], zeros[0], meta, **kw(0))
            torch.cuda.synchronize()
            base = r.float() if opt == "resid" else 0.0
            err = rel_err(torch, got.float() - base, want.float() - base)
            row = {"M": M, "K": K, "N": N, "bits": 4, "group": g, "option": opt, "site": site,
                   "route": route, "rel_err": err, "tol_rel": 2e-2,
                   "max_abs_err": float((got.float() - want.float()).abs().max())}
            if err >= 2e-2 or route != "wgmma" or not torch.isfinite(got.float()).all():
                raise AssertionError(f"K1 with {opt} at M {M} on the Hopper route: {row}")
            nbytes = (wbytes + M * K * 2 + M * N * 2 * (2 if opt == "resid" else 1)
                      + (K * 2 if opt == "norm_w" else 0))
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * M * K * N)
            row["ms"], row["timing"] = cuda_ms(
                torch, [lambda i=i: k1(x, data[i], scales[i], zeros[i], meta, **kw(i))
                        for i in range(copies)], wbytes)
            if opt == "norm_w":
                chain = [lambda i=i: k1(rms_norm(x, nw[i], cfg.norm_eps), data[i], scales[i],
                                        zeros[i], meta) for i in range(copies)]
                lib = [lambda i=i: torch.matmul(rms_norm(x, nw[i], cfg.norm_eps), wd[i])
                       for i in range(nlib)]
                row["library_call"] = "rms_norm, then torch.matmul on the bf16 weight"
            else:
                chain = [lambda i=i: r + k1(x, data[i], scales[i], zeros[i], meta)
                         for i in range(copies)]
                lib = [lambda i=i: torch.addmm(r, x, wd[i]) for i in range(nlib)]
                row["library_call"] = "torch.addmm on the bf16 weight"
            row["was_ms"], _ = cuda_ms(torch, chain, wbytes)
            row["was"] = "the composed chain on the kernel: rms_norm + K1 / K1 + add"
            row["plain_ms"], _ = cuda_ms(
                torch, [lambda i=i: quantized_matmul_plain(x, data[i], scales[i], zeros[i], meta,
                                                           **kw(i)) for i in range(copies)],
                wbytes)
            row["library_ms"], _ = cuda_ms(torch, lib, K * N * 2)
            rows[f"{opt}_{site}_m{M}"] = row
        del data, scales, zeros, wd
        torch.cuda.empty_cache()
    # the other packings and row counts the options take (untimed)
    K, N = D, qkv_n
    for bits in (4, 8):
        for sym in (False, True):
            data, scales, zeros = _packed(torch, 1, K, N, bits, g, gen, dev, sym)
            z = None if zeros is None else zeros[0]
            for M in (1, 8, 32, 300):
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                nw = (1.0 + 0.1 * torch.randn(K, generator=gen, device=dev)).to(torch.bfloat16)
                r = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
                args = (x, data[0], scales[0], z, (bits, g, K, N))
                got = k1(*args, norm_w=nw, resid=r, eps=cfg.norm_eps)
                want = quantized_matmul_plain(*args, norm_w=nw, resid=r, eps=cfg.norm_eps)
                torch.cuda.synchronize()
                err = rel_err(torch, got - r, want - r)
                key = f"both_w{bits}{'s' if sym else 'a'}_m{M}"
                rows[key] = {"rel_err_minus_resid": err, "tol_rel": 2e-2,
                             "max_abs_err": float((got.float() - want.float()).abs().max())}
                if err >= 2e-2 or not torch.isfinite(got.float()).all():
                    raise AssertionError(f"K1 with both options disagrees: {key} {rows[key]}")
    return rows


def phase_e2e(torch, ctx):
    """2 layers at TinyLlama widths: the card (kernels) against the CPU
    (plain versions), same packed weights, prefill + 4 decode steps: RTN W4
    on the int8 KV cache (K1-K4), and POT W4 on the bf16 cache (K7, K8; the
    POT scale search runs on the card, its bytes go to both)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    cfg = TINYLLAMA_1_1B.replace(num_layers=2)
    B, T, steps = 4, 32, 4
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(3))
    parts, t0 = {}, time.perf_counter()
    for method, kv, build_dev in (("rtn", "int8", "cpu"), ("pot", "bfloat16", "cuda")):
        params = llama.init_params(cfg, seed=7, device=build_dev)
        params, qmeta = fuse_packed_sites(*pack_model(params, method,
                                                      {"w_bit": 4, "q_group_size": 128}))
        params = map_tree(params, lambda t: t.cpu())

        def run(dev, feed=None):
            p = map_tree(params, lambda t: t.to(dev))
            cache = init_cache(cfg, B, T + steps + 8, quantized=kv == "int8", device=dev)
            logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta)
            outs = [logits.float().cpu()]
            toks = []
            posn = torch.full((B,), T, dtype=torch.int32, device=dev)
            for i in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[i].to(dev)
                toks.append(tok.cpu())
                logits, cache = decode_step(p, tok, posn, cache, cfg, qmeta)
                outs.append(logits.float().cpu())
                posn = posn + 1
            return outs, toks

        # teacher-forced: the card is fed the CPU run's greedy tokens
        _reset_counts()
        cpu, toks = run("cpu")
        gpu, _ = run("cuda", toks)
        counts = _counts()
        errs = [rel_err(torch, a, b) for a, b in zip(gpu, cpu)]
        top1 = [float((a.argmax(-1) == b.argmax(-1)).float().mean()) for a, b in zip(gpu, cpu)]
        res = {"phase": "e2e", "method": f"{method} W4 g128", "kv": kv, "layers": 2, "B": B,
               "prompt": T, "decode_steps": steps, "rel_err_per_step": errs, "top1_agree": top1,
               "launches": counts, "tol_rel": 3e-2}
        emit(res)
        if max(errs) >= 3e-2:
            raise AssertionError(f"card and CPU logits differ: {res}")
        if method == "pot" and (counts["codebook_matmul"] != (steps + 1) * (4 * 2 + 1)
                                or counts["decode_attention_write_bf16"] != steps * 2):
            raise AssertionError(f"the POT bf16 run missed K7/K8: {counts}")
    parts["tinyllama"] = time.perf_counter() - t0
    for name, fn in (("long", _long_e2e), ("gpt2_opt", _gpt2_opt_e2e),
                     ("boundary", _boundary_e2e), ("moe", _moe_e2e),
                     ("head_dims", lambda torch: _head_dim_e2e(torch, ctx))):
        t0 = time.perf_counter()
        out = fn(torch)
        if name == "moe":
            ctx["moe_route_flips"] = out
        parts[name] = time.perf_counter() - t0
    emit({"phase": "e2e_parts", "seconds": parts})


HEAD_DIM_WIDTHS = {80: {"hidden_size": 2560, "intermediate_size": 6912},  # OPT-2.7B's 2560 / 32
                   96: {"hidden_size": 3072, "intermediate_size": 8192}}
# facebook/opt-2.7b's published config.json: vocab 50272, hidden 2560, ffn
# 10240, 32 layers of 32 heads (hd 80), 2048 positions, pre-LayerNorm (its
# do_layer_norm_before), ReLU, tied embeddings; word_embed_proj_dim equals
# the hidden size, so there is no projection
OPT_2_7B = dict(arch="opt", vocab_size=50272, hidden_size=2560, intermediate_size=10240,
                num_layers=32, num_heads=32, num_kv_heads=32, head_dim=80, norm_eps=1e-5,
                max_seq_len=2048, tie_embeddings=True)
OPT_2_7B_LAYERS = 8  # the opt_2_7b phase's depth: its 32 layers cut for the smoke's time
# tiiuae/Falcon3-7B-Base's published config.json (LlamaForCausalLM, model_type
# "llama"): vocab 131072, hidden 3072, ffn 23040, 28 layers of 12 q heads and
# 4 kv heads of 256 (G 3, an explicit head_dim), rope_theta 1000042, RMSNorm
# eps 1e-6, 32768 positions, untied embeddings, no attention bias; what
# config_from_hf gives for it in both packages (norm_topk_prob aside, an
# MoE-only field it reads as False off a llama)
FALCON3_7B = dict(arch="llama", vocab_size=131072, hidden_size=3072, intermediate_size=23040,
                  num_layers=28, num_heads=12, num_kv_heads=4, head_dim=256,
                  rope_theta=1000042.0, norm_eps=1e-6, max_seq_len=32768, tie_embeddings=False,
                  attention_bias=False, sliding_window=0)
# the attention kernels whose launches the head-dim runs reckon
ATTN_KERNELS = ("flash_attention", "cache_band_write", "decode_attention",
                "decode_attention_layer", "decode_attention_write", "decode_attention_write_bf16",
                "decode_attention_flash")


def _head_dim_e2e(torch, ctx):
    """1-layer llamas at head_dim 80 (hidden 2560, 32 heads) and 96 (hidden
    3072, 32 heads), 8 kv heads, and a 1-layer OPT-2.7B (hd 80, MHA), RTN W4
    g128 fused: the eval forward (B 1, S 128) and a prefill of 32 with 4
    decode steps on the int8 and bf16 stacked caches (the llamas also on the
    per-layer int8 cache at S 2048, K12's layout), on the card against the
    CPU, within 3e-2. Every attention call launches its kernel: K5 a layer
    of the card's forward; a layer a decode step K2 and K3 (llama) or the
    one-layer entry (OPT) on the int8 cache, K8 on the bf16 one, K12 on the
    per-layer one; none takes the plain route
    (plain_attention stays 0, on the CPU too). The launches by head dim are
    the path "e2e_head_dims"."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import get_arch, ops
    from qtpu_torch.models.config import ModelConfig
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    B, T, steps, L = 4, 32, 4, 1  # one layer: the smoke's time limit
    path = {}
    models = [(f"llama hd {hd}", ModelConfig(vocab_size=8192, num_layers=L, num_heads=32,
                                             num_kv_heads=8, head_dim=hd, **widths))
              for hd, widths in HEAD_DIM_WIDTHS.items()]
    # vocabulary 8192 for the llamas: the CPU side's lm_head is most of its
    # time; OPT-2.7B at its published widths
    models.append(("OPT-2.7B", ModelConfig(**{**OPT_2_7B, "num_layers": L})))
    for name, cfg in models:
        arch, hd = cfg.arch, cfg.head_dim
        fam = get_arch(arch)
        raw = fam.init_params(cfg, seed=9, device="cuda")
        params, qmeta = fuse_packed_sites(*pack_model(raw, "rtn", {"w_bit": 4, "q_group_size": 128},
                                                      arch=arch), arch=arch)
        params = map_tree(params, lambda t: t.cpu())
        ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(8))
        a0 = ops.plain_attention.launches
        _reset_counts()
        on_card = fam.forward(raw, ids.cuda(), cfg).float().cpu()
        fwd_counts = _counts()
        fwd = rel_err(torch, on_card, fam.forward(map_tree(raw, lambda t: t.cpu()), ids,
                                                  cfg).float())
        del raw, on_card
        fwd_plain = ops.plain_attention.launches - a0
        path[f"flash_attention_hd{hd}"] = path.get(f"flash_attention_hd{hd}", 0) + fwd_counts[
            "flash_attention"]
        ids = ids[:, :T].repeat(B, 1)
        caches = [("int8", False, T + steps + 8), ("bfloat16", False, T + steps + 8)]
        if arch == "llama":
            caches.append(("int8", True, 2048))
        for kv, per_layer, S in caches:
            quant = kv == "int8"
            t0 = time.perf_counter()
            a0 = ops.plain_attention.launches
            errs, top1, counts = _card_vs_cpu(
                torch, params, cfg, qmeta, arch, ids, steps,
                lambda dev: init_cache(cfg, B, S, quantized=quant, device=dev,
                                       per_layer=per_layer))
            plain = ops.plain_attention.launches - a0
            n = L * steps
            expect = dict.fromkeys(ATTN_KERNELS, 0)
            if per_layer:
                expect["decode_attention_flash"] = n
            elif quant:
                expect["cache_band_write"] = n
                expect["decode_attention" if arch == "llama" else "decode_attention_layer"] = n
            else:
                expect["decode_attention_write_bf16"] = n
            got = {k: counts[k] for k in ATTN_KERNELS}
            res = {"phase": "e2e", "model": name, "arch": arch, "hidden": cfg.hidden_size,
                   "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": hd,
                   "method": "rtn W4 g128", "kv": kv + (" per_layer" if per_layer else ""),
                   "S": S, "layers": L, "B": B, "prompt": T, "decode_steps": steps,
                   "rel_err_per_step": errs, "top1_agree": top1, "eval_forward_rel_err": fwd,
                   "plain_attention_launches": plain, "eval_plain_attention_launches": fwd_plain,
                   "eval_forward_launches": {k: fwd_counts[k] for k in ATTN_KERNELS},
                   "launches": counts, "expected_launches": expect, "tol_rel": 3e-2,
                   "seconds": time.perf_counter() - t0}
            emit(res)
            if max(errs) >= 3e-2 or fwd >= 3e-2:
                raise AssertionError(f"card and CPU logits differ at head_dim {hd}: {res}")
            if plain or fwd_plain or fwd_counts["flash_attention"] != L:
                raise AssertionError(f"head_dim {hd}: an attention call took the plain route "
                                     f"or K5 missed the forward: {res}")
            if got != expect:
                raise AssertionError(f"head_dim {hd}: launches {got} != {expect}")
            for k, v in got.items():
                if v and k != "cache_band_write":
                    path[f"{k}_hd{hd}"] = path.get(f"{k}_hd{hd}", 0) + v
        del params
        torch.cuda.empty_cache()
    ctx.setdefault("path_launches", {})["e2e_head_dims"] = path


class _env:
    """Sets environment variables for a with-block and restores them after."""

    def __init__(self, values: dict):
        self.values, self.saved = values, {}

    def __enter__(self):
        import os

        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# qtpu's decode branches of the llama forward, by the switch that turns each on
BRANCHES = {"default": {}, "fuse": {"QTPU_FUSE_NORM_RESID": "1"}, "boundary": {"QTPU_BOUNDARY": "1"}}


def _branch_step_launches(mode, kv, L):
    """Kernel launches of one decode step of the llama forward on the stacked
    cache under a branch: default and fuse K1 2L + 1 (qkv, o, lm_head), K2 +
    K3 (int8) or K8 (bf16) and K4 L each, fuse with the options on its L qkv
    and L o launches; boundary K1 2 (layer 0's qkv with norm_w, lm_head), K11
    (int8) or K8 (bf16) and K13 L each."""
    int8 = kv == "int8"
    c = {k: 0 for k in WRAPPERS}
    if mode == "boundary":
        c.update({"dequant_matmul": 2, "dequant_matmul_norm_w": 1, "layer_boundary": L,
                  "decode_attention_write" if int8 else "decode_attention_write_bf16": L})
        return c
    c.update({"dequant_matmul": 2 * L + 1, "fused_mlp": L})
    if int8:
        c.update({"cache_band_write": L, "decode_attention": L})
    else:
        c["decode_attention_write_bf16"] = L
    if mode == "fuse":
        c.update({"dequant_matmul_norm_w": L, "dequant_matmul_resid": L})
    return c


def _boundary_e2e(torch):
    """2 layers at TinyLlama widths, RTN W4 g128 fused, under each branch
    switch on the stacked int8 and bf16 caches: a prefill of 32 and 4 decode
    steps on the card against the CPU (which takes the same branch through
    the kernels' plain versions), launches checked."""
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    cfg = TINYLLAMA_1_1B.replace(num_layers=2)
    B, T, steps, L = 4, 32, 4, 2
    params, qmeta = fuse_packed_sites(*pack_model(llama.init_params(cfg, seed=7, device="cpu"),
                                                  "rtn", {"w_bit": 4, "q_group_size": 128}))
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(6))
    for mode in ("fuse", "boundary"):
        for kv in ("int8", "bfloat16"):
            quant = kv == "int8"
            t0 = time.perf_counter()
            with _env(BRANCHES[mode]):
                errs, top1, counts = _card_vs_cpu(
                    torch, params, cfg, qmeta, "llama", ids, steps,
                    lambda dev: init_cache(cfg, B, T + steps + 8, quantized=quant, device=dev))
            expect = {k: steps * v for k, v in _branch_step_launches(mode, kv, L).items()}
            expect["dequant_matmul"] += 4 * L + 1
            if mode == "fuse":  # the fuse branch takes the prefill too (K13 does not)
                expect["dequant_matmul_norm_w"] += L
                expect["dequant_matmul_resid"] += L
            res = {"phase": "e2e", "branch": mode, "switch": BRANCHES[mode],
                   "method": "rtn W4 g128", "kv": kv, "layers": L, "B": B, "prompt": T,
                   "decode_steps": steps, "rel_err_per_step": errs, "top1_agree": top1,
                   "launches": counts, "expected_launches": expect, "tol_rel": 3e-2,
                   "seconds": time.perf_counter() - t0}
            emit(res)
            if max(errs) >= 3e-2:
                raise AssertionError(f"card and CPU logits differ in the {mode} branch: {res}")
            if counts != expect:
                raise AssertionError(f"the {mode} branch's launches {counts} != {expect}")


def _card_vs_cpu(torch, params, cfg, qmeta, arch, ids, steps, make_cache):
    """Prefill ids [B, T] and `steps` greedy decode steps on the CPU (plain
    versions), then the same on the card fed the CPU's tokens (teacher-forced),
    from the same packed bytes. Returns (relative logits error per step,
    top-1 agreement per step, the launches of the card run)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.serve.decode import decode_step, prefill

    B, T = ids.shape

    def run(dev, feed=None):
        p = map_tree(params, lambda t: t.to(dev))
        cache = make_cache(dev)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta, arch=arch)
        outs, toks = [logits.float().cpu()], []
        posn = torch.full((B,), T, dtype=torch.int32, device=dev)
        for i in range(steps):
            tok = torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[i].to(dev)
            toks.append(tok.cpu())
            logits, cache = decode_step(p, tok, posn, cache, cfg, qmeta, arch=arch)
            outs.append(logits.float().cpu())
            posn = posn + 1
        return outs, toks

    cpu, toks = run("cpu")
    _reset_counts()
    gpu, _ = run("cuda", toks)
    counts = _counts()
    errs = [rel_err(torch, a, b) for a, b in zip(gpu, cpu)]
    top1 = [float((a.argmax(-1) == b.argmax(-1)).float().mean()) for a, b in zip(gpu, cpu)]
    return errs, top1, counts


def _long_e2e(torch):
    """2 layers at TinyLlama widths, RTN W4 g128 fused, on the per-layer
    int8 cache at S 4096 (a multiple of 2048: K12 on every layer of a decode
    step): a prefill of 128 and 8 decode steps on the card against the CPU."""
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    cfg = TINYLLAMA_1_1B.replace(num_layers=2)
    B, T, steps, S = 4, 128, 8, 4096
    params = llama.init_params(cfg, seed=7, device="cpu")
    params, qmeta = fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 128}))
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(4))
    errs, top1, counts = _card_vs_cpu(
        torch, params, cfg, qmeta, "llama", ids, steps,
        lambda dev: init_cache(cfg, B, S, quantized=True, device=dev, per_layer=True))
    L = cfg.num_layers
    expect = {"decode_attention_flash": L * steps, "decode_attention_write": 0,
              "cache_band_write": 0, "decode_attention": 0, "fused_mlp": L * steps,
              "dequant_matmul": (2 * L + 1) * steps + 4 * L + 1}
    res = {"phase": "e2e", "method": "rtn W4 g128", "kv": "int8 per_layer", "S": S, "layers": L,
           "B": B, "prompt": T, "decode_steps": steps, "rel_err_per_step": errs,
           "top1_agree": top1, "launches": counts, "expected_launches": expect, "tol_rel": 3e-2}
    emit(res)
    if max(errs) >= 3e-2:
        raise AssertionError(f"card and CPU logits differ on the per-layer cache: {res}")
    if any(counts[k] != v for k, v in expect.items()):
        raise AssertionError(f"the per-layer run's launches {counts} != {expect}")


def _gpt2_opt_e2e(torch):
    """2 layers at GPT2_SMALL and OPT_125M widths, RTN W4 g128 (OPT's q/k/v
    fused): prefill of 32 and 4 decode steps on the card against the CPU, on
    the int8 cache (K2 and the one-layer decode attention per layer of a
    step) and the bf16 cache (K8); K1 4 a layer and the lm_head per forward
    (GPT-2's 50257-wide one on the ragged-N path)."""
    from qtpu_torch.models import get_arch
    from qtpu_torch.models.config import GPT2_SMALL, OPT_125M
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    B, T, steps = 4, 32, 4
    for base in (GPT2_SMALL, OPT_125M):
        cfg, arch = base.replace(num_layers=2), base.arch
        params = get_arch(arch).init_params(cfg, seed=7, device="cpu")
        params, qmeta = fuse_packed_sites(
            *pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 128}, arch=arch), arch=arch)
        ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(5))
        L = cfg.num_layers
        for kv in ("int8", "bfloat16"):
            quant = kv == "int8"
            errs, top1, counts = _card_vs_cpu(
                torch, params, cfg, qmeta, arch, ids, steps,
                lambda dev: init_cache(cfg, B, T + steps + 8, quantized=quant, device=dev))
            expect = {k: 0 for k in WRAPPERS}
            expect.update({"dequant_matmul": (4 * L + 1) * (steps + 1),
                           "cache_band_write": L * steps if quant else 0,
                           "decode_attention_layer": L * steps if quant else 0,
                           "decode_attention_write_bf16": 0 if quant else L * steps})
            res = {"phase": "e2e", "model": f"{base.arch} width", "method": "rtn W4 g128",
                   "kv": kv, "layers": L, "B": B, "prompt": T, "decode_steps": steps,
                   "rel_err_per_step": errs, "top1_agree": top1, "launches": counts,
                   "expected_launches": expect, "tol_rel": 3e-2}
            emit(res)
            if max(errs) >= 3e-2:
                raise AssertionError(f"card and CPU {arch} logits differ: {res}")
            if counts != expect:
                raise AssertionError(f"the {arch} run's launches {counts} != {expect}")


def _dense_of_packed(torch, packed, qmeta):
    """The packed sites of a model as dense f32 "w" sites of the same values
    (`dequantize_parts`: (q - z) * s in f32, never rounded), on the CPU."""
    from qtpu_torch.core.packing import dequantize_parts

    meta = dict(qmeta)

    def site(name, p):
        if "data" not in p:
            return {k: v.cpu() for k, v in p.items()}
        bits, group = meta[name][:2]
        lead = p["data"].shape[:-2]
        flat = [t.reshape(-1, *t.shape[-2:]) for t in (p["data"], p["scales"], p["zeros"])]
        w = torch.stack([dequantize_parts(d, sc, z, bits, group, torch.float32)
                         for d, sc, z in zip(*flat)])
        out = {"w": w.reshape(*lead, *w.shape[-2:]).cpu()}
        if "b" in p:
            out["b"] = p["b"].cpu()
        return out

    layers = {k: site(k, v) if isinstance(v, dict) else v.cpu()
              for k, v in packed["layers"].items()}
    return {"embed": packed["embed"].cpu(), "layers": layers,
            "final_norm": packed["final_norm"].cpu(),
            "lm_head": site("lm_head", packed["lm_head"])}


class _Held:
    """While active, every call of K1 (in ops.linear), K9, K10 (in the MoE
    MLP), K11 and K8 (in llama._write_and_attend) on the card also runs the
    kernel's plain version on the same inputs (a cache write on clones of
    the cache) and keeps the relative error of each call, by kernel."""

    def __init__(self, torch):
        from qtpu_torch.kernels import dequant_matmul as k1
        from qtpu_torch.kernels import kv_attention as kv
        from qtpu_torch.kernels import moe_matmul as k9
        from qtpu_torch.models import llama, moe, ops

        self.torch, self.errs = torch, {}
        self.targets = [
            (ops, "quantized_matmul", "K1", k1.quantized_matmul_plain, ()),
            (moe, "moe_matmul", "K9", k9.moe_matmul_plain, ()),
            (moe, "moe_gathered_matmul", "K10", k9.moe_gathered_matmul_plain, ()),
            (llama, "decode_attention_write", "K11", kv.decode_attention_write_plain, (3, 4, 5, 6)),
            (llama, "decode_attention_write_bf16", "K8", kv.decode_attention_write_bf16_plain, (3, 4)),
        ]
        self.saved = []

    def _wrap(self, kernel, name, plain, cache_args):
        def held(*args, **kw):
            pargs = [a.clone() if i in cache_args else a for i, a in enumerate(args)]
            want = plain(*pargs, **kw)
            got = kernel(*args, **kw)
            self.errs.setdefault(name, []).append(rel_err(self.torch, got, want))
            return got

        return held

    def __enter__(self):
        for mod, attr, name, plain, cache_args in self.targets:
            kernel = getattr(mod, attr)
            self.saved.append((mod, attr, kernel))
            setattr(mod, attr, self._wrap(kernel, name, plain, cache_args))
        return self

    def __exit__(self, *exc):
        for mod, attr, kernel in self.saved:
            setattr(mod, attr, kernel)


class _Plain(_Held):
    """While active, the card runs the plain versions of the kernels _Held
    holds (K1, K9, K10, K11, K8) in their place."""

    def _wrap(self, kernel, name, plain, cache_args):
        return plain


class _F32Arithmetic:
    """While active, the llama and MoE forwards run their dense sites as the
    kernels do their arithmetic: x @ W with W held in f32 ((q - z) * s, never
    rounded to bf16) and the products summed in f32, cast once; the experts
    as one f32 einsum. The router, lm_head and norms are unchanged."""

    def __init__(self, torch):
        from qtpu_torch.models import llama, moe

        def lin32(x, p, site_meta=None, layer=None):
            if layer is not None:
                p = {k: v[layer] for k, v in p.items()}
            y = (x.float() @ p["w"].float()).to(x.dtype)
            return y + p["b"].to(y.dtype) if "b" in p else y

        def exp32(x, p, meta, per_expert_input, l):
            eq = "emk,ekn->emn" if per_expert_input else "mk,ekn->emn"
            return torch.einsum(eq, x.float(), p["w"][l].float()).to(x.dtype)

        self.patches = [(llama, "linear", lin32), (moe, "linear", lin32),
                        (moe, "_expert_matmul", exp32)]
        self.saved = []

    def __enter__(self):
        for mod, attr, fn in self.patches:
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


# e2e's Mixtral depth: at 2 layers e2e took 186 s of a 948 s smoke on one
# card machine, and the smoke took 1231 s on a slower one, over its 1200 s
# limit; serve_moe, moe_methods and the shard phase route over 8, 2 and 2
# layers on the card
MOE_E2E_LAYERS = 1


def _moe_e2e(torch):
    """MOE_E2E_LAYERS at Mixtral-8x7B widths, RTN W4 g128, packed on the card:
    prefill + 4 decode steps on the card (K1, K9 or K10, K11 or K8) against
    the CPU, which runs the same packed bytes dequantized once to bf16 (the
    plain versions' x @ dequant(W), the experts as one einsum), teacher-forced
    on the CPU's greedy tokens. The int8 cache at batch 4 decodes on the
    grouped route (B * top_k = 8 = E), the bf16 cache at batch 2 on the
    gathered one.

    Where the error comes from: in the card run every kernel call is also
    held against its plain version on the card, on that call's inputs
    (relative errors by kernel, `_Held`); and the CPU runs a second time with
    the kernels' arithmetic (weights in f32, `_F32Arithmetic`), against which
    the card's logits are compared too (cpu_f32_rel_err_per_step)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import moe
    from qtpu_torch.models.config import MIXTRAL_8X7B
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    cfg = MIXTRAL_8X7B.replace(num_layers=MOE_E2E_LAYERS)
    T, steps = 16, 4
    route, flips_by_kv = moe._route, {}
    packed, qmeta = pack_model(moe.init_params(cfg, seed=7, device="cuda"), "rtn",
                               {"w_bit": 4, "q_group_size": MOE_GROUP}, arch="moe")
    dense32 = _dense_of_packed(torch, packed, qmeta)
    # the plain versions' bf16 weights: the same values cast once, as dequantize_parts casts
    dense = map_tree(dense32, lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    torch.cuda.empty_cache()
    for kv, B in (("int8", 4), ("bfloat16", 2)):
        ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(3))

        def run(p, dev, feed=None):
            cache = init_cache(cfg, B, T + steps + 8, quantized=kv == "int8", device=dev)
            logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta, arch="moe")
            outs, toks = [logits.float().cpu()], []
            posn = torch.full((B,), T, dtype=torch.int32, device=dev)
            for i in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[i].to(dev)
                toks.append(tok.cpu())
                logits, cache = decode_step(p, tok, posn, cache, cfg, qmeta, arch="moe")
                outs.append(logits.float().cpu())
                posn = posn + 1
            return outs, toks

        t0 = time.perf_counter()
        routes_cpu, routes_gpu = [], []
        moe._route = _route_tap(moe, route, routes_cpu)
        cpu, toks = run(dense, "cpu")
        cpu_s = time.perf_counter() - t0
        moe._route = _route_tap(moe, route, routes_gpu)
        _reset_counts()
        with _Held(torch) as held:
            gpu, _ = run(packed, "cuda", toks)
        counts = _counts()
        routes = _route_counts()
        t0 = time.perf_counter()
        moe._route = _route_tap(moe, route, [])
        with _F32Arithmetic(torch):
            cpu32, _ = run(dense32, "cpu", toks)
        cpu32_s = time.perf_counter() - t0
        # once more with the CPU's expert ids forced on the card (the card's
        # own router probabilities at those ids), to split routing from the rest
        moe._route = _route_tap(moe, route, [], forced=[t for _, t in routes_cpu])
        forced, _ = run(packed, "cuda", toks)
        moe._route = route
        flips = _route_flips(routes_cpu, routes_gpu, cfg.num_layers)
        flips_by_kv[kv] = flips
        forced_errs = [rel_err(torch, a, b) for a, b in zip(forced, cpu)]
        errs = [rel_err(torch, a, b) for a, b in zip(gpu, cpu)]
        top1 = [float((a.argmax(-1) == b.argmax(-1)).float().mean()) for a, b in zip(gpu, cpu)]
        gathered = B * cfg.num_experts_per_tok < cfg.num_experts
        L = cfg.num_layers
        expect = {"dequant_matmul": (steps + 1) * (4 * L + 1),
                  "moe_matmul": 3 * L * (1 if gathered else steps + 1),
                  "moe_gathered_matmul": 3 * L * steps if gathered else 0,
                  "decode_attention_write": L * steps if kv == "int8" else 0,
                  "decode_attention_write_bf16": L * steps if kv != "int8" else 0}
        res = {"phase": "e2e", "model": "Mixtral-8x7B width", "method": "rtn W4 g128", "kv": kv,
               "layers": L, "B": B, "prompt": T, "decode_steps": steps,
               "route": "gathered" if gathered else "grouped", "rel_err_per_step": errs,
               "top1_agree": top1, "cpu_s": cpu_s, "launches": counts, "routes": routes,
               "expected_launches": expect, "tol_rel": 3e-2,
               "route_flips_per_layer": flips,
               "routes_per_layer": sum(t.numel() for l, t in routes_cpu if l == 0),
               "forced_routes_rel_err_per_step": forced_errs,
               "kernel_vs_plain_rel_err": {
                   k: {"max": max(v), "mean": sum(v) / len(v), "calls": len(v), "each": v}
                   for k, v in held.errs.items()},
               "cpu_f32_rel_err_per_step": [rel_err(torch, a, b) for a, b in zip(gpu, cpu32)],
               "cpu_f32_vs_cpu_rel_err_per_step": [rel_err(torch, a, b)
                                                   for a, b in zip(cpu32, cpu)],
               "cpu_f32_s": cpu32_s}
        emit(res)
        if max(errs) >= 3e-2:
            raise AssertionError(f"card and CPU MoE logits differ: {res}")
        if any(counts[k] != v for k, v in expect.items()):
            raise AssertionError(f"the MoE run's launches {counts} != {expect}")
        # the prefill's K1 and K9 launches (B x 16 rows) took the Hopper route
        _check_routes(f"e2e MoE {kv}", routes, k1=4 * L + 1, k9=3 * L)
        _check_gemv(f"e2e MoE {kv}", counts, routes)
        emit(_moe_teacher_forced(torch, cfg, packed, dense, dense32, qmeta, ids, toks, kv))
    del packed, dense, dense32
    torch.cuda.empty_cache()
    return flips_by_kv


MOE_LAYER_BAND = 4.4e-3  # the per-kernel band: K1, K9-K11 and K8 against their plain versions


def _moe_teacher_forced(torch, cfg, packed, dense, dense32, qmeta, ids, toks, kv, dev="cuda"):
    """The MoE e2e teacher-forced half a layer at a time: for each forward
    (the prefill, then each decode step on the CPU's greedy tokens) and each
    layer, the card runs the layer's attention half (norm, q/k/v, cache write
    and attention, o_proj: K1, K11 or K8) from the CPU run's input to the
    layer and a copy of the CPU's cache before it, and its MoE half (norm,
    router, experts, combine: K9 or K10) from the CPU run's residual stream
    after attention, on the packed weights; each half's output, before its
    bf16 residual add, is held to the CPU's (the plain versions on the same
    bytes dequantized to bf16), again to the plain versions run on the card,
    and to the CPU with the weights kept in f32 and the products summed in f32
    (_F32Arithmetic: the arithmetic the kernels do, exactly). A half off by
    more than the per-kernel band from the exact arithmetic is a fault in it;
    halves within it mean the free-running error is the bf16 reference's
    weight roundings and bf16 roundings of the residual stream compounding
    over layers and steps. The final norm and lm_head are held the same way."""
    from dataclasses import replace

    from qtpu_torch.kernels.kv_attention import cache_mask
    from qtpu_torch.models import moe
    from qtpu_torch.models.ops import rope_tables
    from qtpu_torch.serve.decode import _positions
    from qtpu_torch.serve.kvcache import init_cache

    qm = dict(qmeta).get
    B, T = ids.shape
    L = cfg.num_layers

    def attention(p, x, positions, cache, l):
        """moe.forward_with_cache's attention half of layer l, before the residual add"""
        S = cache.max_len
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
        start = positions[:, 0].to(torch.int32).contiguous()
        mask = None if positions.shape[1] == 1 else cache_mask(positions, S, win)
        lay = p["layers"]
        h = moe.rms_norm(x, lay["attn_norm"][l], cfg.norm_eps)
        q, k, v = moe._qkv(h, lay, cfg, qm, l)
        q = moe.apply_rope(q, cos, sin)
        k = moe.apply_rope(k, cos, sin).contiguous()
        attn = moe._write_and_attend(q, k, v.contiguous(), cache, l, start, mask, win, None)
        return moe.linear(attn, lay["o_proj"], qm("o_proj"), layer=l)

    def mlp(p, x, l):
        """its MoE half, before the residual add"""
        lay = p["layers"]
        return moe._moe_mlp(moe.rms_norm(x, lay["mlp_norm"][l], cfg.norm_eps), lay, cfg, qm, l)

    def head(p, x):
        x = moe.rms_norm(x, p["final_norm"], cfg.norm_eps)
        return moe.linear(x, p["lm_head"], qm("lm_head")).float()

    def on_card(cache):
        return replace(cache, **{f: None if getattr(cache, f) is None
                                 else getattr(cache, f).to(dev, copy=True)
                                 for f in ("k", "v", "k_scale", "v_scale", "length")})

    cache = init_cache(cfg, B, T + len(toks) + 8, quantized=kv == "int8", device="cpu")
    forwards = [(ids, _positions(B, T, None, "cpu"))]
    forwards += [(t[:, None], torch.full((B, 1), T + i, dtype=torch.int32))
                 for i, t in enumerate(toks)]
    # per forward and layer: each half's output on the card (kernels), on the
    # card with the plain versions, on the CPU; relative errors between them
    errs = {f"{half}_{pair}": [] for half in ("attention", "moe")
            for pair in ("card_vs_cpu", "card_plain_vs_cpu", "card_vs_card_plain",
                         "card_vs_cpu_f32", "cpu_vs_cpu_f32")}
    head_err = []
    for tok, positions in forwards:
        x = dense["embed"][tok]
        rows = {k: [] for k in errs}
        for l in range(L):
            xd, pd = x.to(dev), positions.to(dev)
            a_card = attention(packed, xd, pd, on_card(cache), l).cpu()
            with _Plain(torch):
                a_plain = attention(packed, xd, pd, on_card(cache), l).cpu()
            with _F32Arithmetic(torch):
                a_f32 = attention(dense32, x, positions, replace(cache, **{
                    f: None if getattr(cache, f) is None else getattr(cache, f).clone()
                    for f in ("k", "v", "k_scale", "v_scale", "length")}), l)
            a_cpu = attention(dense, x, positions, cache, l)
            mid = x + a_cpu
            m_card = mlp(packed, mid.to(dev), l).cpu()
            with _Plain(torch):
                m_plain = mlp(packed, mid.to(dev), l).cpu()
            with _F32Arithmetic(torch):
                m_f32 = mlp(dense32, mid, l)
            m_cpu = mlp(dense, mid, l)
            for half, card, plain, cpu, f32 in (("attention", a_card, a_plain, a_cpu, a_f32),
                                                ("moe", m_card, m_plain, m_cpu, m_f32)):
                rows[f"{half}_card_vs_cpu"].append(rel_err(torch, card, cpu))
                rows[f"{half}_card_plain_vs_cpu"].append(rel_err(torch, plain, cpu))
                rows[f"{half}_card_vs_card_plain"].append(rel_err(torch, card, plain))
                rows[f"{half}_card_vs_cpu_f32"].append(rel_err(torch, card, f32))
                rows[f"{half}_cpu_vs_cpu_f32"].append(rel_err(torch, cpu, f32))
            x = mid + m_cpu
        head_err.append(rel_err(torch, head(packed, x.to(dev)).cpu(), head(dense, x)))
        moe._advance_length(cache, positions, None)
        for k in errs:
            errs[k].append(rows[k])
    def worst(pair):
        return max(max(max(r) for r in errs[f"{h}_{pair}"]) for h in ("attention", "moe"))

    return {"phase": "e2e_moe_teacher_forced", "kv": kv, "layers": L, "B": B,
            "forwards": ["prefill"] + [f"step{i + 1}" for i in range(len(toks))],
            "half_layer_rel_err": errs, "final_norm_lm_head_rel_err": head_err,
            "worst_half_layer": {p: worst(p) for p in ("card_vs_cpu", "card_vs_cpu_f32",
                                                       "cpu_vs_cpu_f32", "card_plain_vs_cpu")},
            "per_kernel_band": MOE_LAYER_BAND,
            "card_within_band_of_f32_arithmetic": worst("card_vs_cpu_f32") <= MOE_LAYER_BAND}


def _route_tap(moe, route, log, forced=None):
    """A stand-in for moe._route that appends (layer, expert ids [.., k] on
    the CPU) of every call to `log`; with `forced` (the ids of a recorded run,
    in call order) it routes to those experts instead, weighted by this run's
    router probabilities at them."""
    from qtpu_torch.models.ops import linear

    calls = None if forced is None else iter(forced)

    def tapped(h, layers, cfg, qm, l):
        topv, topi = route(h, layers, cfg, qm, l)
        if calls is not None:
            topi = next(calls).to(topi.device).reshape(topi.shape)
            logits = linear(h, layers["router"], qm("router"), layer=l).float()
            topv = logits.softmax(dim=-1).gather(-1, topi)
            if cfg.norm_topk_prob:
                topv = topv / topv.sum(dim=-1, keepdim=True)
        log.append((l, topi.cpu()))
        return topv, topi

    return tapped


def _route_flips(a, b, L):
    """Per layer, the (token, expert) pairs routed in run a and not in run b
    (as many as the other way round: each token keeps k experts)."""
    flips = [0] * L
    for (la, ta), (lb, tb) in zip(a, b, strict=True):
        if la != lb or ta.numel() != tb.numel():
            raise AssertionError(f"the runs routed other calls: layer {la} {ta.shape}, {lb} {tb.shape}")
        ta, tb = ta.reshape(-1, ta.shape[-1]), tb.reshape(-1, tb.shape[-1])
        for x, y in zip(ta.tolist(), tb.tolist()):
            flips[la] += len(set(x) - set(y))
    return flips


SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 128, 32


def _tinyllama_w4(torch, ctx, group=128):
    """TinyLlama-1.1B, all 22 layers, random per-layer weights drawn on the
    card from seed 0, packed RTN W4 g128 (or `group`) with fused qkv/gateup
    sites; built once per run and kept in ctx for the phases that follow."""
    key = "tinyllama_w4" if group == 128 else f"tinyllama_w4_g{group}"
    if key not in ctx:
        from qtpu_torch.models import llama
        from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
        from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

        params = llama.init_params(cfg, seed=0, device="cuda")
        params, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": group})
        ctx[key] = fuse_packed_sites(params, qmeta)
        torch.cuda.synchronize()
    return ctx[key]


def _tinyllama_w4_cut(torch, ctx):
    """(cfg, params, qmeta): the serve model's first CUT_LAYERS layers, as
    views of its stacked weights."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models.config import TINYLLAMA_1_1B

    params, qmeta = _tinyllama_w4(torch, ctx)
    params = dict(params, layers=map_tree(params["layers"], lambda t: t[:CUT_LAYERS]))
    return TINYLLAMA_1_1B.replace(num_layers=CUT_LAYERS), params, qmeta


# the depth of the phases that run the serve model after serve and profile
# (long_ctx, http, boundary): its 22 layers cut for the smoke's time
CUT_LAYERS = 8
EAGER_PROFILE_STEPS = 4  # an eager block's profile: the profiler's own cost grows with its records


def _block_times(torch, eng, pos_value, n=16):
    """Time of a decode step of the engine's own decode block (its graph, or
    eager decode_multi on its static inputs): every slot active at position
    pos_value, greedy, blocks of n steps. Host wall ms a step over three
    blocks (each from staging the inputs to reading the ids back), the
    device ms a step between CUDA events around one block, and a profile of
    one block (device ms, busy share, launches, kernels by kind; an eager
    engine's over EAGER_PROFILE_STEPS steps, a graph engine's over one
    replay of its n-step graph)."""
    import numpy as np

    B = eng.max_batch
    args = (np.arange(B, dtype=np.int32) % eng.cfg.vocab_size,
            np.full(B, pos_value, np.int32), np.zeros(B, np.float32))
    eng.run_decode_block(*args, n)  # warm
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_decode_block(*args, n)
        wall.append((time.perf_counter() - t0) / n * 1e3)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    eng.launch_decode_block(*args, n)
    b.record()
    b.synchronize()
    m = n if eng.graphs else EAGER_PROFILE_STEPS
    prof = _profiled(torch, lambda: eng.run_decode_block(*args, m), m, classify=_kind)
    return {"block": n, "profiled_steps": m, "wall_ms_per_step": wall,
            "event_ms_per_step": a.elapsed_time(b) / n,
            "device_ms_per_step": prof["device_ms_per_step"],
            "device_busy_share": prof["device_busy_share"], "profile": prof}


def _prefill_times(torch, eng, buckets):
    """Each (P, Tb) bucket's prefill on the engine (its graph, or eager):
    rows at start 0 in slots 0..P-1, ids arange, greedy. Host wall ms over
    three calls (from staging the arrays to reading the ids back), and the
    kernels of one more call (a CUDA-only profile: kernel ms and launches);
    busy = kernel ms over the median wall ms."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for P, Tb in sorted(buckets):
        args = ((np.arange(P * Tb, dtype=np.int32) % eng.cfg.vocab_size).reshape(P, Tb),
                np.zeros(P, np.int32), np.arange(P, dtype=np.int64), np.full(P, Tb - 1, np.int32),
                np.zeros(P, np.float32))
        wall = []  # the bucket ran in the phase (or was captured by warmup())
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run_prefill(*args).cpu()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.run_prefill(*args).cpu()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in rows) / 1e3
        out[f"{P}x{Tb}"] = {"wall_ms": wall, "device_ms": dev, "busy": dev / sorted(wall)[1],
                            "launches": sum(e.count for e in rows)}
    return out


def _warm_engine(torch, eng, phase, mode):
    """warmup() with the peak memory it adds (the graphs' pool at its high
    mark, the scratch prefill's cache on an eager engine); fails unless a
    graph engine captured every bucket of qtpu's warm set and an eager one
    captured nothing. Returns {warmup_s, warmup_peak_gib, prefill_graphs}."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    warm = eng.warmup()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    graphs = mode == "graph"
    if bool(eng.graphs) != graphs or (set(eng.prefill_graphs) == set(eng.prefill_buckets)) != graphs:
        raise AssertionError(f"{phase} {mode}: warmup() captured {sorted(eng.graphs)} and "
                             f"prefill buckets {sorted(eng.prefill_graphs)} of {eng.prefill_buckets}")
    return {"warmup_s": warm, "warmup_peak_gib": peak, "prefill_graphs": len(eng.prefill_graphs)}


def _serve_both(torch, ctx, phase, make, prompts, new, expect_of, check=None, step_pos=None,
                extra=None, all_buckets=False, sampled=False, time_prefill=True):
    """A serving phase's requests (prompts, each with `new` new tokens,
    greedy) on two engines built by make(cuda_graphs): first the default
    one, whose decode blocks replay CUDA graphs, after warmup() (its
    seconds printed); then an eager one (cuda_graphs=False). For each: the
    launches and routes of the run, counted from 0 just before it, against
    expect_of(decode_steps, prefill_calls) and check(tag, counts, routes,
    steps, pre); tokens/s, mean TTFT, and a decode step's wall and device
    time and busy share (_block_times at step_pos, default the prompt
    length). Both engines are warmed first (the eager one's warmup() builds
    and prefills on a scratch cache, and captures nothing). Fails unless both answer every request with `new` ids in the
    vocabulary and their greedy tokens are equal request for request.
    Prefill runs qtpu's buckets: a graph engine's warmup() captures each of
    its warm set (_warm_engine), and each bucket the run used is timed on
    both engines (_prefill_times; all_buckets: every one of the warm set on
    the graph engine; time_prefill=False: none).
    With `sampled`, the same prompts run again at temperature 0.8 on each
    engine after its greedy run (the generators of one seed in step) and
    must give equal tokens on both.
    Emits one line per engine and a comparison line; returns {mode: line}."""
    runs, outs, samp = {}, {}, {}
    for mode in ("graph", "eager"):
        t0 = time.perf_counter()
        eng = make(mode == "graph")
        warm_info = _warm_engine(torch, eng, phase, mode)
        warm = warm_info["warmup_s"]
        vocab = eng.cfg.vocab_size
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t1 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts, routes, m = _counts(), _route_counts(), eng.metrics()
        steps, pre = m["decode_steps"], m["prefill_calls"]
        tokens = sum(len(r.output) for r in done)
        expect = expect_of(steps, pre)
        res = {"phase": phase, "mode": mode, "graphs": sorted(eng.graphs), "warmup_s": warm,
               "requests": len(done), "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall, "mean_ttft_s": m.get("mean_ttft_s"),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "decode_steps": steps,
               "prefill_calls": pre, "launches": counts, "expected_launches": expect,
               "routes": routes, "metrics": m, **(extra or {})}
        if len(done) != len(prompts):
            raise AssertionError(f"{phase} {mode}: {len(done)} of {len(prompts)} requests finished")
        for r in done:
            if len(r.output) != new or not all(0 <= t < vocab for t in r.output):
                raise AssertionError(f"{phase} {mode}: request {r.uid}: {len(r.output)} tokens, "
                                     f"ids {r.output}")
        if counts != expect or steps == 0:
            raise AssertionError(f"{phase} {mode}: kernel launches {counts} != expected {expect}")
        if check is not None:
            check(f"{phase} {mode}", counts, routes, steps, pre)
        res.update(warm_info)
        res["prefill_buckets_run"] = {f"{p}x{t}": n for (p, t), n in sorted(eng.prefill_shapes.items())}
        if sampled:
            sreqs = [eng.submit(p, max_new_tokens=new, temperature=0.8) for p in prompts]
            eng.run()
            samp[mode] = [r.output for r in sreqs]
        res["decode_step"] = _block_times(torch, eng, len(prompts[0]) if step_pos is None
                                          else step_pos)
        res["prefill"] = _prefill_times(
            torch, eng, () if not time_prefill else eng.prefill_buckets
            if all_buckets and mode == "graph" else eng.prefill_shapes)
        res["seconds"] = time.perf_counter() - t0
        emit({**res, "card": ctx["smi"]})
        runs[mode], outs[mode] = res, [r.output for r in reqs]
        del eng, done, reqs
        torch.cuda.empty_cache()
    same = outs["graph"] == outs["eager"]
    line = {"phase": f"{phase}_graph_vs_eager", "greedy_tokens_equal": same,
            **{k: {mode: r[k] for mode, r in runs.items()}
               for k in ("warmup_s", "warmup_peak_gib", "prefill_graphs", "tokens_per_s",
                         "mean_ttft_s")},
            **{k: {mode: r["decode_step"][k] for mode, r in runs.items()}
               for k in ("wall_ms_per_step", "event_ms_per_step", "device_ms_per_step",
                         "device_busy_share")},
            "prefill": {b: {mode: {k: r["prefill"][b][k] for k in ("wall_ms", "device_ms", "busy")}
                            for mode, r in runs.items() if b in r["prefill"]}
                        for b in runs["graph"]["prefill"]},
            "card": ctx["smi"]}
    if sampled:
        line["sampled_tokens_equal"] = samp["graph"] == samp["eager"]
    emit(line)
    if not same:
        raise AssertionError(f"{phase}: the graph and eager engines' greedy tokens differ: "
                             f"{outs['graph']} vs {outs['eager']}")
    if sampled and samp["graph"] != samp["eager"]:
        raise AssertionError(f"{phase}: the graph and eager engines' sampled tokens differ: "
                             f"{samp['graph']} vs {samp['eager']}")
    return runs


def _eager_twin(torch, phase, eng, prompts, new, want):
    """The eager engine of a phase whose engine serves on graphs: warmed,
    the same greedy requests, its TTFT, tokens/s and the prefill times of
    the buckets it ran; fails unless its tokens equal the graph engine's
    (`want`, request for request)."""
    info = _warm_engine(torch, eng, phase, "eager")
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [r.output for r in reqs]
    res = {**info, "tokens_per_s": sum(len(o) for o in got) / wall,
           "mean_ttft_s": eng.metrics().get("mean_ttft_s"),
           "prefill": _prefill_times(torch, eng, eng.prefill_shapes),
           "greedy_tokens_equal_graph": got == want}
    if got != want:
        raise AssertionError(f"{phase}: the eager engine's greedy tokens {got} differ from the "
                             f"graph engine's {want}")
    return res


def _serve_prompts(cfg, n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT, dtype=np.int32) for _ in range(n)]


def _serve_launches(L, steps, pre):
    """The serve cell's launches (a llama of L layers, RTN W4 fused sites,
    int8 KV) over `steps` decode steps and `pre` prefill calls: K1 on qkv
    and o of each layer and the lm_head a step, on 4 sites a layer and the
    lm_head a prefill; K2, K3 and K4 once a layer a step."""
    return {"dequant_matmul": (2 * L + 1) * steps + (4 * L + 1) * pre,
            "cache_band_write": L * steps, "decode_attention": L * steps,
            "fused_mlp": L * steps, "flash_attention": 0, "w8a8_matmul": 0, **NO_CODEBOOK}


def _check_serve_routes(tag, counts, routes, L, pre):
    # every prefill launch of K1 (88 + 1 a prefill of 8 x 128 rows) took the Hopper route
    _check_routes(tag, routes, k1=(4 * L + 1) * pre)
    # and every decode launch of K1 and K4 the tensor-core GEMV
    _check_gemv(tag, counts, routes)


def phase_serve(torch, ctx):
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi

    t0 = time.perf_counter()
    params, qmeta = _tinyllama_w4(torch, ctx)
    setup_s = time.perf_counter() - t0
    B, P, new, L = SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.num_layers

    def make(graphs):
        return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                 kv_dtype="int8", seed=0, device="cuda", cuda_graphs=graphs)

    def expect_of(steps, pre):
        return _serve_launches(L, steps, pre)

    def check(tag, counts, routes, steps, pre):
        _check_serve_routes(tag, counts, routes, L, pre)

    runs = _serve_both(torch, ctx, "serve", make, _serve_prompts(cfg, B), new, expect_of, check,
                       extra={"model": "TinyLlama-1.1B", "layers": L, "method": "rtn W4 g128",
                              "kv": "int8", "setup_s": setup_s}, all_buckets=True, sampled=True)
    g = runs["graph"]
    ctx.setdefault("path_launches", {})["serve"] = {**g["launches"], **g["routes"]}

    # steady eager decode_multi after the run: blocks of 16 greedy steps, all
    # slots live, host wall time per step (after a synchronize)
    from qtpu_torch.serve.kvcache import init_cache

    cache = init_cache(cfg, B, P + new + 16, quantized=True, device="cuda")
    tok = torch.zeros(B, dtype=torch.int32, device="cuda")
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_multi(params, tok, pos, cache, None, None, cfg, 16, qmeta)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / 16 * 1e3)
    emit({"phase": "serve_decode", "batch": B, "ms_per_step": step_ms,
          "tokens_per_s": [B * 1e3 / t for t in step_ms], "card": ctx["smi"]})
    del cache


def _post(port, path, body=None, method="POST"):
    """(status, JSON body) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_http(torch, ctx):
    """The HTTP front end on the card: the serve cell's model (TinyLlama-1.1B,
    RTN W4 g128 fused, its first CUT_LAYERS layers; int8 KV, 8 slots) behind
    ServingFrontend and make_server after warmup(); 8 threads POST 8
    requests of prompt 128 and 32 new tokens at once. Checks: each response's tokens equal the eager
    engine's greedy tokens for its prompt; the launches of the run against
    the serve cell's reckoning per prefill and decode step; /health reports
    8 requests; {} is answered 400 and an unknown path 404. Then `python -m
    qtpu_torch.serve --model tiny-test --kv int8 --http 0` in a process of
    its own: its "serving on" line, one request answered, SIGINT, exit."""
    import queue
    import signal
    import threading

    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.http import ServingFrontend, make_server

    cfg, params, qmeta = _tinyllama_w4_cut(torch, ctx)
    B, P, new, L = SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.num_layers
    prompts = _serve_prompts(cfg, B, seed=1)
    ref = ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                            kv_dtype="int8", device="cuda", cuda_graphs=False)
    eager = _warm_engine(torch, ref, "http", "eager")
    ref_reqs = [ref.submit(p, max_new_tokens=new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.run()
    torch.cuda.synchronize()
    want = [r.output for r in ref_reqs]
    eager.update(tokens_per_s=sum(len(o) for o in want) / (time.perf_counter() - t0),
                 mean_ttft_s=ref.metrics().get("mean_ttft_s"),
                 prefill=_prefill_times(torch, ref, ref.prefill_shapes))
    del ref, ref_reqs
    eng = ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                            kv_dtype="int8", device="cuda")
    warm_info = _warm_engine(torch, eng, "http", "graph")
    torch.cuda.synchronize()
    _reset_counts()
    frontend = ServingFrontend(eng)
    server = make_server(frontend, 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                               daemon=True)
    serving.start()
    answers = [None] * B
    try:
        def ask(i):
            answers[i] = _post(port, "/generate", {"prompt_ids": prompts[i].tolist(),
                                                   "max_new_tokens": new, "temperature": 0.0})

        clients = [threading.Thread(target=ask, args=(i,)) for i in range(B)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        time.sleep(0.2)  # the engine refreshes /health after its step
        health = _post(port, "/health", method="GET")
        bad = _post(port, "/generate", {})[0]
        unknown = _post(port, "/nope", method="GET")[0]
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=10)
        frontend.shutdown()
    counts, routes, m = _counts(), _route_counts(), eng.metrics()
    steps, pre = m["decode_steps"], m["prefill_calls"]
    expect = {"dequant_matmul": (2 * L + 1) * steps + (4 * L + 1) * pre,
              "cache_band_write": L * steps, "decode_attention": L * steps,
              "fused_mlp": L * steps, "flash_attention": 0, "w8a8_matmul": 0, **NO_CODEBOOK}
    ok = [a is not None and a[0] == 200 for a in answers]
    got = [a[1]["tokens"] if okay else None for a, okay in zip(answers, ok)]
    res = {"phase": "http", "model": "TinyLlama-1.1B", "method": "rtn W4 g128", "kv": "int8",
           "slots": B, "requests": B, **warm_info, "graphs": sorted(eng.graphs),
           "prefill_buckets_run": {f"{p}x{t}": n for (p, t), n in sorted(eng.prefill_shapes.items())},
           "prefill": _prefill_times(torch, eng, eng.prefill_shapes), "eager": eager,
           "wall_s": wall, "tokens_per_s": sum(len(t or []) for t in got) / wall,
           "mean_ttft_s": (sum(a[1]["ttft_s"] for a, okay in zip(answers, ok) if okay)
                           / max(1, sum(ok))),
           "answered_200": sum(ok), "tokens_equal_eager": [g == w for g, w in zip(got, want)],
           "health": health, "status_empty_body": bad, "status_unknown_path": unknown,
           "decode_steps": steps, "prefill_calls": pre, "launches": counts,
           "expected_launches": expect, "card": ctx["smi"]}
    emit(res)
    if not all(ok) or not all(res["tokens_equal_eager"]):
        raise AssertionError(f"http: responses {answers} against the eager engine's {want}")
    if health[0] != 200 or health[1].get("requests") != B:
        raise AssertionError(f"http: /health {health}")
    if bad != 400 or unknown != 404:
        raise AssertionError(f"http: {{}} answered {bad}, an unknown path {unknown}")
    if counts != expect or steps == 0:
        raise AssertionError(f"http: kernel launches {counts} != expected {expect}")
    _check_routes("http", routes, k1=(4 * L + 1) * pre)
    _check_gemv("http", counts, routes)
    del eng
    torch.cuda.empty_cache()

    # the CLI's front end in a process of its own
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-u", "-m", "qtpu_torch.serve", "--model", "tiny-test", "--kv", "int8",
           "--http", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    seen, cli_port, answer = [], None, None
    try:
        while cli_port is None and time.perf_counter() - t0 < 300:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            seen.append(line.rstrip())
            if line.startswith("serving on http://127.0.0.1:"):
                cli_port = int(line.split(":")[2].split()[0])
        if cli_port is not None:
            answer = _post(cli_port, "/generate", {"prompt_ids": [1, 2, 3, 4, 5],
                                                   "max_new_tokens": 4})
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit({"phase": "http_cli", "argv": " ".join(cmd[3:]), "output": seen, "answer": answer,
          "rc": rc, "seconds": time.perf_counter() - t0})
    if cli_port is None or answer is None or answer[0] != 200 or len(answer[1]["tokens"]) != 4:
        raise AssertionError(f"the serve CLI's front end failed: {seen} {answer}")
    if rc != 0 or not any(x.startswith("engine warmup") for x in seen):
        raise AssertionError(f"the serve CLI's front end did not warm up or exit cleanly: "
                             f"rc {rc}, {seen}")


def _profiled(torch, fn, n, classify=None):
    """torch.profiler over fn() (n steps of work, ending in a synchronize):
    host wall ms per step, device kernel ms per step, the device busy share
    (kernel time over wall time), the CUDA kernel launches per step and the
    top kernels by device time; with `classify` (kernel name -> kind) also
    the device ms and the launches per step by kind."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: an operator's row repeats the device time of its kernels
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    res = {"wall_ms_per_step": wall_us / n / 1e3, "device_ms_per_step": device_us / n / 1e3,
           "device_busy_share": device_us / wall_us if device_us else None,
           "kernel_launches_per_step": sum(r[2] for r in rows) / n,
           "top": [{"name": k[:80], "ms_per_step": t / n / 1e3, "calls_per_step": c / n}
                   for k, t, c in rows[:15]]}
    if classify is not None:
        split, calls = {}, {}
        for k, t, c in rows:
            split[classify(k)] = split.get(classify(k), 0.0) + t / n / 1e3
            calls[classify(k)] = calls.get(classify(k), 0) + c / n
        res["device_ms_by_kind"] = split
        res["kernel_launches_by_kind"] = calls
    return res


def phase_profile(torch, ctx):
    """Where the serve cell's time goes: torch.profiler over one warm
    prefill of the 8 prompts and over one 16-step decode block."""
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.serve.decode import decode_multi, prefill
    from qtpu_torch.serve.kvcache import init_cache

    params, qmeta = _tinyllama_w4(torch, ctx)
    B, P = SERVE_B, SERVE_PROMPT
    cache = init_cache(cfg, B, P + SERVE_NEW + 16, quantized=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    logits, cache = prefill(params, ids, cache, cfg, qmeta)  # warm
    plain_wall_ms = []  # host wall time of a warm prefill without the profiler
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, ids, cache, cfg, qmeta)
        torch.cuda.synchronize()
        plain_wall_ms.append((time.perf_counter() - t0) * 1e3)
    pre = _profiled(torch, lambda: prefill(params, ids, cache, cfg, qmeta), 1)
    emit({"phase": "profile", "what": "prefill", "batch": B, "prompt": P, **pre,
          "unprofiled_wall_ms": plain_wall_ms, "card": ctx["smi"]})
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta)  # warm
    n = 16
    dec = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                qmeta), n)
    emit({"phase": "profile", "what": "decode", "batch": B, "decode_steps": n, **dec,
          "card": ctx["smi"]})


LONG_SEQ, LONG_BLOCK, LONG_FILL, LONG_STEPS = 32752, 16, 80, 32
LONG_PROMPT = 128  # the prefill whose k/v scales the filled cache's scales are drawn from


def _plain_decode_step(torch, params, qmeta, cfg, tok, pos, cache):
    """One llama decode step through the plain functions, called explicitly
    on the card (no wrapper, so no kernel): K1's, the rope, K12's on each
    per-layer buffer (it writes row pos as the kernel does), K4's. The
    reference the long_ctx cell's first step is held to."""
    from qtpu_torch.kernels.dequant_matmul import quantized_matmul_plain
    from qtpu_torch.kernels.fused_mlp import fused_mlp_plain
    from qtpu_torch.kernels.kv_attention import flash_decode_plain
    from qtpu_torch.models.ops import apply_rope, rms_norm, rope_tables

    qm, layers = dict(qmeta), params["layers"]
    B, H, KV, hd = tok.shape[0], cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(x, site, l=None):
        p = params[site] if l is None else {k: v[l] for k, v in layers[site].items()}
        return quantized_matmul_plain(x, p["data"], p["scales"], p["zeros"], qm[site])

    x = params["embed"][tok[:, None]]
    cos, sin = rope_tables(pos[:, None], hd, cfg.rope_theta)
    for l in range(cfg.num_layers):
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q, k, v = torch.split(lin(h, "qkv_proj", l), [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        q = apply_rope(q.reshape(B, 1, H, hd), cos, sin)
        k = apply_rope(k.reshape(B, 1, KV, hd), cos, sin)
        attn = flash_decode_plain(q[:, 0], k, v.reshape(B, 1, KV, hd), *cache.layer(l), pos)
        x = x + lin(attn.reshape(B, 1, H * hd), "o_proj", l)
        gu, dn = layers["gateup_proj"], layers["down_proj"]
        x = fused_mlp_plain(x, layers["mlp_norm"][l], gu["data"][l], gu["scales"][l],
                            gu["zeros"][l], dn["data"][l], dn["scales"][l], dn["zeros"][l],
                            qm["gateup_proj"], qm["down_proj"], eps=cfg.norm_eps)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lin(x, "lm_head")[:, 0].float()


def _k12_checked_step(torch, params, qmeta, cfg, tok, pos, cache):
    """One decode step through the kernels in which every layer's K12 call
    is held against flash_decode_plain on the same inputs: the plain version
    first (it writes row pos, which K12's strict mask keeps out of every
    read), then the kernel. Returns per layer (relative error of the output,
    whether the codes and scales K12 wrote at pos equal the plain ones)."""
    from qtpu_torch.kernels.kv_attention import flash_decode_plain
    from qtpu_torch.models import llama
    from qtpu_torch.serve.decode import decode_step

    kernel, per_layer = llama.decode_attention_flash, []
    rows = torch.arange(tok.shape[0], device=tok.device)

    def at_pos(stores, p):
        idx = p.to(torch.int64).clamp(0, stores[0].shape[2] - 1)
        return [t[rows, :, idx].clone() for t in stores]

    def checked(q, k_new, v_new, *rest, window=0):
        stores, p = rest[:4], rest[4]
        want = flash_decode_plain(q, k_new, v_new, *stores, p, window=window)
        written = at_pos(stores, p)
        got = kernel(q, k_new, v_new, *stores, p, window=window)
        same = all(bool(torch.equal(a, b)) for a, b in zip(at_pos(stores, p), written))
        per_layer.append((rel_err(torch, got, want), same))
        return got

    llama.decode_attention_flash = checked
    try:
        decode_step(params, tok, pos, cache, cfg, qmeta)
    finally:
        llama.decode_attention_flash = kernel
    return per_layer


def _own_kv_scales(torch, params, qmeta, cfg, B, gen):
    """A prefill of LONG_PROMPT seeded tokens into a small per-layer int8
    cache: the k and v scales (absmax / 127 of each written row) this model
    writes itself, per layer, flattened, and the rms of the values they
    dequantize to."""
    from qtpu_torch.serve.decode import prefill
    from qtpu_torch.serve.kvcache import dequantize_kv, init_cache

    small = init_cache(cfg, B, LONG_PROMPT, quantized=True, device="cuda", per_layer=True)
    ids = torch.randint(0, cfg.vocab_size, (B, LONG_PROMPT), generator=gen, device="cuda")
    prefill(params, ids, small, cfg, qmeta)
    scales, rms = [], []
    for l in range(cfg.num_layers):
        scales.append((small.k_scale[l].reshape(-1), small.v_scale[l].reshape(-1)))
        rms.append([float(dequantize_kv(c, sc, torch.float32).pow(2).mean().sqrt())
                    for c, sc in ((small.k[l], small.k_scale[l]), (small.v[l], small.v_scale[l]))])
    return scales, rms


def phase_long_ctx(torch, ctx):
    """Long-context decode on the per-layer int8 cache: TinyLlama-1.1B at
    full width (the serve model's first CUT_LAYERS of its 22 layers), RTN
    W4 g128 fused, a ContinuousBatcher with 8 slots, kv_layout="per_layer",
    max_seq_len 32752 and decode_block 16, so S = 32768 (0.14 GB of cache a
    layer). Every layer is filled up to S - 80 with
    seeded random codes over +-127 and scales drawn (seeded) from the k and
    v scales this model writes itself in a prefill of 128 tokens (printed
    with the rms of those keys and values and of the filled cache's); then
    32 decode steps through decode_step (K12 a layer a step), timed on the host;
    a profile of 4 more steps (device time, busy share, K12's share); peak
    memory.

    Checks. K12 against flash_decode_plain on every layer of the first
    step, on the inputs that layer gives it (3e-2 relative, codes and scales
    written equal; this comparison does not compound over layers). The first
    step's logits against the same step through the plain functions on the
    card, within 5e-2: K1's and K4's f32 scales against their plain
    versions' bf16 weights put a floor under that comparison (at 22 layers),
    which the phase measures on the still empty cache and prints
    (zero_cache_rel_err_vs_plain)."""
    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi, decode_step
    from qtpu_torch.serve.kvcache import dequantize_kv

    cfg, params, qmeta = _tinyllama_w4_cut(torch, ctx)
    B, L = SERVE_B, cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=LONG_SEQ,
                            kv_dtype="int8", decode_block=LONG_BLOCK, kv_layout="per_layer",
                            seed=0, device="cuda")
    cache = eng.cache
    S, fill = cache.max_len, cache.max_len - LONG_FILL
    if S != LONG_S or not cache.per_layer:
        raise AssertionError(f"the per-layer cache is S {S} (per_layer {cache.per_layer})")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device="cuda").to(torch.int32)
    pos = torch.full((B,), fill, dtype=torch.int32, device="cuda")
    tok_first, pos_first = tok, pos
    # the floor: the same step on the empty cache (row pos is rewritten below)
    ref0 = _plain_decode_step(torch, params, qmeta, cfg, tok, pos, cache)
    err_zero = rel_err(torch, decode_step(params, tok, pos, cache, cfg, qmeta)[0], ref0)
    own, own_rms = _own_kv_scales(torch, params, qmeta, cfg, B, gen)
    fill_rms = []
    for l in range(L):
        for c, sc, src in ((cache.k[l], cache.k_scale[l], own[l][0]),
                           (cache.v[l], cache.v_scale[l], own[l][1])):
            c[:, :, :fill].random_(-127, 128, generator=gen)
            pick = torch.randint(0, src.numel(), sc[:, :, :fill].shape, generator=gen,
                                 device="cuda")
            sc[:, :, :fill] = src[pick]
        fill_rms.append([float(dequantize_kv(c[:, :, :fill], sc[:, :, :fill], torch.float32)
                               .pow(2).mean().sqrt())
                         for c, sc in ((cache.k[l], cache.k_scale[l]),
                                       (cache.v[l], cache.v_scale[l]))])
    cache.length.fill_(fill)
    cache_gb = sum(t.numel() * t.element_size()
                   for c in (cache.k, cache.v, cache.k_scale, cache.v_scale) for t in c) / 1e9
    # the reference first: its write of row pos is rewritten by the step
    ref = _plain_decode_step(torch, params, qmeta, cfg, tok, pos, cache)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = decode_step(params, tok, pos, cache, cfg, qmeta)
    first = logits.clone()
    eager_ids = [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(LONG_STEPS - 1):
        tok = eager_ids[-1]
        pos = pos + 1
        logits, _ = decode_step(params, tok, pos, cache, cfg, qmeta)
        eager_ids.append(torch.argmax(logits, -1).to(torch.int32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    routes = _route_counts()
    expect = {k: 0 for k in WRAPPERS}
    expect.update({"dequant_matmul": (2 * L + 1) * LONG_STEPS, "fused_mlp": L * LONG_STEPS,
                   "decode_attention_flash": L * LONG_STEPS})
    err = rel_err(torch, first, ref)
    # the first step again, K12 held to its plain version layer by layer (the
    # steps since wrote rows above pos only; this one rewrites row pos)
    per_layer = _k12_checked_step(torch, params, qmeta, cfg, tok_first, pos_first, cache)
    k12_errs = [e for e, _ in per_layer]
    res = {"phase": "long_ctx", "model": "TinyLlama-1.1B", "layers": L, "method": "rtn W4 g128",
           "kv": "int8 per_layer", "slots": B, "S": S, "filled": fill, "cache_gb": cache_gb,
           "decode_steps": LONG_STEPS, "wall_s": wall, "tokens_per_s": B * LONG_STEPS / wall,
           "host_ms_per_step": wall / LONG_STEPS * 1e3,
           "own_prefill_kv_rms_per_layer": own_rms, "filled_kv_rms_per_layer": fill_rms,
           "own_prefill_k_scale_mean": float(torch.stack([k.mean() for k, _ in own]).mean()),
           "own_prefill_v_scale_mean": float(torch.stack([v.mean() for _, v in own]).mean()),
           "k12_rel_err_per_layer": k12_errs, "tol_rel_k12": 3e-2,
           "k12_rows_equal": all(same for _, same in per_layer),
           "first_step_rel_err_vs_plain": err, "tol_rel_plain": 5e-2,
           "zero_cache_rel_err_vs_plain": err_zero,
           "finite": bool(torch.isfinite(first).all()), "launches": counts,
           "expected_launches": expect}
    ctx.setdefault("path_launches", {})["long_ctx"] = {**counts, **routes}
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != expected {expect}: {res}")
    _check_gemv("long_ctx", counts, routes)  # K1 and K4 on the tensor-core GEMV
    if len(per_layer) != L or max(k12_errs) >= 3e-2 or not res["k12_rows_equal"]:
        raise AssertionError(f"K12 disagrees with its plain version inside the step: {res}")
    if err >= 5e-2 or not res["finite"]:
        raise AssertionError(f"the long-context step disagrees with the plain one: {res}")
    res["graph"] = _long_graph_run(torch, ctx, eng, tok_first, pos_first, eager_ids, expect)
    n = 4
    tok = torch.argmax(logits, -1).to(torch.int32)
    prof = _profiled(torch, lambda: decode_multi(params, tok, pos + 1, cache, None, None, cfg, n,
                                                 qmeta), n, classify=_kind)
    k12_ms = prof["device_ms_by_kind"].get("K12 decode_attention_flash", 0.0)
    emit({**res, "profile": prof, "k12_ms_per_step": k12_ms,
          "k12_share_of_device": k12_ms / prof["device_ms_per_step"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": ctx["smi"]})
    del eng, cache
    torch.cuda.empty_cache()


def _long_graph_run(torch, ctx, eng, tok, pos, eager_ids, expect):
    """The long_ctx cell's 32 steps again, from the same first token, through
    the engine's own decode blocks after warmup(): 2 replays of its 16-step
    CUDA graph on the filled cache (rewriting the rows the eager steps
    wrote). Checks the greedy ids against the eager steps' and the launches
    against the same reckoning; then a decode step's wall and device time
    and busy share on the graph (_block_times)."""
    import numpy as np

    B = eng.max_batch
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    warm = eng.warmup()
    peak_warm = torch.cuda.max_memory_allocated() / 2**30
    ids, p = tok.cpu().numpy(), pos.cpu().numpy()
    zeros = np.zeros(B, np.float32)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = []
    for i in range(LONG_STEPS // LONG_BLOCK):
        blocks.append(eng.run_decode_block(ids, p + i * LONG_BLOCK, zeros, LONG_BLOCK))
        ids = blocks[-1][:, -1]
    wall = time.perf_counter() - t0
    counts, routes = _counts(), _route_counts()
    got = np.concatenate(blocks, axis=1)
    want = torch.stack(eager_ids, dim=1).cpu().numpy()
    if set(eng.prefill_graphs) != set(eng.prefill_buckets):
        raise AssertionError(f"long_ctx: warmup() captured prefill buckets "
                             f"{sorted(eng.prefill_graphs)} of {eng.prefill_buckets}")
    P, Tb = max(eng.prefill_buckets)
    H, V = eng.cfg.num_heads, eng.cfg.vocab_size
    res = {"warmup_s": warm, "graphs": sorted(eng.graphs), "wall_s": wall,
           "prefill_graphs": len(eng.prefill_graphs),
           # the largest bucket's f32 buffers as reckoned: the plain cached_attention's
           # scores [P, H, Tb, S] and the logits [P, Tb, V]
           "reckoned_gb": {"bucket": f"{P}x{Tb}", "scores": P * H * Tb * eng.cache.max_len * 4 / 1e9,
                           "logits": P * Tb * V * 4 / 1e9},
           "peak_mem_gib_eager_steps": peak_eager, "peak_mem_gib_warmup": peak_warm,
           "tokens_per_s": B * LONG_STEPS / wall, "host_ms_per_step": wall / LONG_STEPS * 1e3,
           "greedy_tokens_equal": bool(np.array_equal(got, want)), "launches": counts,
           "decode_step": _block_times(torch, eng, int(p[0]) + LONG_STEPS, LONG_BLOCK)}
    emit({"phase": "long_ctx_graph", **res, "expected_launches": expect, "card": ctx["smi"]})
    if counts != expect:
        raise AssertionError(f"long_ctx graph: kernel launches {counts} != expected {expect}")
    _check_gemv("long_ctx graph", counts, routes)
    if not res["greedy_tokens_equal"]:
        raise AssertionError(f"long_ctx: the graph's greedy ids {got} differ from the eager "
                             f"steps' {want}")
    return {k: v for k, v in res.items() if k != "launches"}


def _k13_checked_step(torch, params, qmeta, cfg, tok, pos, cache):
    """One decode step under QTPU_BOUNDARY=1 in which every layer's K13 call
    is held against layer_boundary_plain on that layer's inputs (the plain
    version first; neither writes the cache). Returns (the step's logits,
    per layer (relative error of y2 - x, relative error of qkv))."""
    from qtpu_torch.kernels.layer_boundary import layer_boundary_plain
    from qtpu_torch.models import llama
    from qtpu_torch.serve.decode import decode_step

    kernel, per_layer = llama.layer_boundary, []

    def checked(attn, x, *rest, **kw):
        want_y2, want_qkv = layer_boundary_plain(attn, x, *rest, **kw)
        y2, qkv = kernel(attn, x, *rest, **kw)
        per_layer.append((rel_err(torch, y2.float() - x.float(), want_y2.float() - x.float()),
                          rel_err(torch, qkv, want_qkv)))
        return y2, qkv

    llama.layer_boundary = checked
    try:
        logits, _ = decode_step(params, tok, pos, cache, cfg, qmeta)
    finally:
        llama.layer_boundary = kernel
    return logits, per_layer


def phase_boundary(torch, ctx):
    """qtpu's layer-boundary decode branches at full width: TinyLlama-1.1B
    (the serve model's first CUT_LAYERS of its 22 layers, views), RTN
    W4 g128 fused, 8 slots answering the serve traffic (8
    requests of prompt 128 and 32 new tokens, greedy) on the stacked int8 and
    then bf16 cache, under each branch in one process: default, fuse
    (QTPU_FUSE_NORM_RESID=1) and boundary (QTPU_BOUNDARY=1). For each:
    tokens/s, TTFT, peak memory, the launches of the run against their
    reckoning per prefill and per decode step (`_branch_step_launches`), a
    profile of 4 decode steps (device and host time, K13's share), and one
    decode step from the same prefill whose logits are compared with the
    default branch's (relative error, top-1 agreement; printed), with the
    engines' greedy tokens' agreement. Each engine runs its decode blocks and
    prefill buckets on CUDA graphs that its warmup() captured under the
    branch's switch; the default and fuse branches also answer on an eager
    engine (_eager_twin: the same tokens, TTFT, tok/s, the bucket's prefill
    times; the boundary branch's prefill is the default one). Checks: the
    launches; K13 against its
    plain version on every layer of that step, on the layer's own inputs
    (2e-2 relative on y2 - x and on qkv); finite logits."""
    import numpy as np

    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi, decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    cfg, params, qmeta = _tinyllama_w4_cut(torch, ctx)
    B, P, new, L = SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.num_layers
    paths = ctx.setdefault("path_launches", {})
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=P, dtype=np.int32) for _ in range(B)]
    for kv in ("int8", "bfloat16"):
        quant = kv == "int8"
        ref_logits = ref_outputs = ref_tok = ref_prefill = None
        for mode, env in BRANCHES.items():
            with _env(env):
                def make(graphs):
                    return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B,
                                             max_seq_len=P + new, kv_dtype=kv, seed=0,
                                             device="cuda", cuda_graphs=graphs)

                eng = make(True)
                # the branch is frozen into the decode and prefill graphs here
                warm_info = _warm_engine(torch, eng, f"boundary {kv} {mode}", "graph")
                for p in prompts:
                    eng.submit(p, max_new_tokens=new)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                t0 = time.perf_counter()
                done = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _counts()
                routes = _route_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                m = eng.metrics()
                steps, pre = m["decode_steps"], m["prefill_calls"]
                per_step = _branch_step_launches(mode, kv, L)
                expect = {k: steps * v for k, v in per_step.items()}
                expect["dequant_matmul"] += (4 * L + 1) * pre
                if mode == "fuse":  # the engine's prefills take the fuse branch too
                    expect["dequant_matmul_norm_w"] += L * pre
                    expect["dequant_matmul_resid"] += L * pre
                outputs = [r.output for r in sorted(done, key=lambda r: r.uid)]
                graph_prefill = _prefill_times(torch, eng, eng.prefill_shapes)
                del eng
                # the eager twin of each branch whose prefill is its own: the
                # boundary branch's prefill is the default one (K13 is decode only)
                eager = None if mode == "boundary" else _eager_twin(
                    torch, f"boundary {kv} {mode}", make(False), prompts, new, outputs)
                # one decode step from the same prefill, then a profile; the
                # prefill's K1 launches with an option, all on the Hopper route
                cache = init_cache(cfg, B, P + new + 16, quantized=quant, device="cuda")
                _reset_counts()
                logits, cache = prefill(params, ids, cache, cfg, qmeta)
                pc, pr = _counts(), _route_counts()
                pre_opts = {"dequant_matmul_norm_w_wgmma": pc["dequant_matmul_norm_w"],
                            "dequant_matmul_resid_wgmma": pc["dequant_matmul_resid"]}
                want_opts = {k: L if mode == "fuse" else 0 for k in pre_opts}
                if pre_opts != want_opts or pr["dequant_matmul_wgmma"] != 4 * L + 1:
                    raise AssertionError(f"{mode} prefill: K1 option launches {pre_opts} "
                                         f"(want {want_opts}), routes {pr}")
                paths[f"boundary_{kv}_{mode}_prefill"] = pre_opts
                # the step takes the default branch's tokens: a branch's own
                # prefill may flip a near tie of this random model's argmax
                if ref_tok is None:
                    ref_tok, ref_prefill = torch.argmax(logits, -1).to(torch.int32), logits.float()
                prefill_err = rel_err(torch, logits.float(), ref_prefill)
                tok = ref_tok
                pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
                per_layer = None
                if mode == "boundary":
                    step, per_layer = _k13_checked_step(torch, params, qmeta, cfg, tok, pos, cache)
                else:
                    step = decode_step(params, tok, pos, cache, cfg, qmeta)[0]
                decode_multi(params, tok, pos + 1, cache, None, None, cfg, 2, qmeta)  # warm
                n = 4
                prof = _profiled(torch, lambda: decode_multi(params, tok, pos + 1, cache, None, None,
                                                             cfg, n, qmeta), n, classify=_kind)
                del cache
            if ref_logits is None:
                ref_logits, ref_outputs = step.float(), outputs
            same = [a == b for o, r in zip(outputs, ref_outputs) for a, b in zip(o, r)]
            k13_ms = prof["device_ms_by_kind"].get("K13 layer_boundary", 0.0)
            res = {"phase": "boundary", "model": "TinyLlama-1.1B", "layers": L,
                   "method": "rtn W4 g128", "kv": kv, "branch": mode, "switch": env,
                   "mode": "graph", **warm_info, "prefill": graph_prefill, "eager": eager,
                   "requests": len(done), "tokens": sum(len(o) for o in outputs), "wall_s": wall,
                   "tokens_per_s": sum(len(o) for o in outputs) / wall,
                   "mean_ttft_s": m.get("mean_ttft_s"), "peak_mem_gib": peak,
                   "decode_steps": steps, "prefill_calls": pre, "launches": counts,
                   "expected_launches": expect, "launches_per_decode_step": per_step,
                   "prefill_rel_err_vs_default": prefill_err,
                   "step_rel_err_vs_default": rel_err(torch, step, ref_logits),
                   "step_top1_agree_vs_default": float((step.argmax(-1) == ref_logits.argmax(-1))
                                                       .float().mean()),
                   "greedy_tokens_agree_vs_default": sum(same) / max(1, len(same)),
                   "k13_rel_err_per_layer": per_layer, "tol_rel_k13": 2e-2,
                   "profile_decode": prof, "k13_ms_per_step": k13_ms,
                   "k13_share_of_device": k13_ms / prof["device_ms_per_step"],
                   "finite": bool(torch.isfinite(step).all()), "card": ctx["smi"]}
            emit(res)
            paths[f"boundary_{kv}_{mode}"] = {**counts, **routes}
            if len(done) != B or any(len(o) != new for o in outputs):
                raise AssertionError(f"{len(done)} of {B} requests finished: {res}")
            if counts != expect or steps == 0:
                raise AssertionError(f"kernel launches {counts} != expected {expect}")
            _check_gemv(f"boundary {mode} {kv}", counts, routes)
            if not res["finite"]:
                raise AssertionError(f"non-finite logits in the {mode} branch: {res}")
            if mode == "boundary" and (len(per_layer) != L
                                       or max(max(e) for e in per_layer) >= 2e-2):
                raise AssertionError(f"K13 disagrees with its plain version inside the step: {res}")
        torch.cuda.empty_cache()


GPT2_MCFG = {"w_bit": 4, "q_group_size": 128}


def phase_serve_gpt2(torch, ctx):
    """GPT-2 and OPT serving at full width: GPT2_SMALL and OPT_125M (12
    layers each, random weights from seed 0), RTN W4 g128 (OPT's q/k/v
    fused), a ContinuousBatcher with 8 slots and the int8 KV cache answering
    8 requests of prompt 128 and 32 new tokens: K1 49 a forward (4 a layer
    and the lm_head, GPT-2's 50257 wide), K2 and the one-layer decode
    attention 12 a decode step, launches checked; a profile of one decode
    step; then `python -m qtpu_torch.serve --model gpt2 --kv int8` (its
    main())."""
    from qtpu_torch.models import get_arch
    from qtpu_torch.models.config import GPT2_SMALL, OPT_125M
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.__main__ import main as serve_main
    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi, prefill
    from qtpu_torch.serve.kvcache import init_cache

    B, P, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    paths = ctx.setdefault("path_launches", {})
    for cfg in (GPT2_SMALL, OPT_125M):
        arch, L = cfg.arch, cfg.num_layers
        t0 = time.perf_counter()
        params = get_arch(arch).init_params(cfg, seed=0, device="cuda")
        params, qmeta = fuse_packed_sites(*pack_model(params, "rtn", GPT2_MCFG, arch=arch),
                                          arch=arch)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def make(graphs, params=params, qmeta=qmeta, cfg=cfg):
            return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                     kv_dtype="int8", seed=0, device="cuda", cuda_graphs=graphs)

        def expect_of(steps, pre, L=L):
            expect = {k: 0 for k in WRAPPERS}
            expect.update({"dequant_matmul": (4 * L + 1) * (steps + pre),
                           "cache_band_write": L * steps, "decode_attention_layer": L * steps})
            return expect

        def check(tag, counts, routes, steps, pre, arch=arch):
            # every decode launch of K1 took the tensor-core GEMV but GPT-2's
            # 50257-wide lm_head (dq_core's GEMV, one a decode step)
            _check_gemv(tag, counts, routes, ragged_k1=steps if arch == "gpt2" else 0)

        runs = _serve_both(torch, ctx, "serve_gpt2", make, _serve_prompts(cfg, B), new, expect_of,
                           check, extra={"model": arch, "layers": L, "method": "rtn W4 g128",
                                         "kv": "int8", "setup_s": setup_s})
        g = runs["graph"]
        res = {k: g[k] for k in ("phase", "model", "tokens_per_s", "mean_ttft_s", "decode_steps")}
        paths[f"serve_{arch}"] = {**g["launches"], **g["routes"]}
        cache = init_cache(cfg, B, P + new + 16, quantized=True, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
        logits, cache = prefill(params, ids, cache, cfg, qmeta, arch=arch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
        decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta, arch=arch)  # warm
        n = 4
        dec = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                    qmeta, arch=arch), n, classify=_kind)
        emit({**res, "profile_decode": dec, "card": ctx["smi"]})
        del cache, params
        torch.cuda.empty_cache()

    _reset_counts()
    rc = serve_main(["--model", "gpt2", "--kv", "int8", "--requests", "2", "--tokens", "4",
                     "--batch", "2"])
    cli = _counts()
    emit({"phase": "serve_gpt2_cli", "argv": "--model gpt2 --kv int8", "rc": rc, "launches": cli})
    if rc != 0 or cli["decode_attention_layer"] == 0 or cli["dequant_matmul"] == 0:
        raise AssertionError(f"the serve CLI run failed: rc {rc}, launches {cli}")



def phase_opt_2_7b(torch, ctx):
    """OPT-2.7B at full width on the card (OPT_2_7B: facebook/opt-2.7b's
    widths, 32 heads of 80; OPT_2_7B_LAYERS of its 32 layers), random
    per-layer weights from seed 0, RTN W4 g128 packed with fused q/k/v: the
    engine at 8 x (128 + 32), greedy, on the int8 cache (K2 and the
    one-layer entry a layer a decode step) and the bf16 cache (K8 a layer a
    step), each on CUDA graphs and
    eager (tokens equal), with tokens/s, TTFT and a decode step's device
    time against its byte bound (the weights a step streams and the cache
    rows it reads, at 3.35 TB/s); then the bench's three perplexities on the
    fixture, 4 blocks of 2048: raw, RTN fake-quant and packed (within 1% of
    fake-quant), K5 a layer an eval block on its Hopper body, K1 on the
    Hopper route."""
    import numpy as np

    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import opt
    from qtpu_torch.models.config import ModelConfig
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model, quantize_model
    from qtpu_torch.serve.batching import ContinuousBatcher

    cfg = ModelConfig(**{**OPT_2_7B, "num_layers": OPT_2_7B_LAYERS})
    L, B, P, new, hd = cfg.num_layers, SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.head_dim
    KV = cfg.num_kv_heads
    paths = ctx.setdefault("path_launches", {})
    t0 = time.perf_counter()
    raw = opt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed, qmeta = fuse_packed_sites(*pack_model(raw, "rtn", EVAL_MCFG, arch="opt"), arch="opt")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    # the bytes a decode step streams: every weight but the embedding and
    # position tables, of which it gathers B rows each
    leaves = _tree_leaves(packed)
    weight_bytes = sum(t.numel() * t.element_size() for k, t in leaves.items()
                       if k not in ("/embed", "/pos_embed")) + 2 * B * cfg.hidden_size * 2
    emit({"phase": "opt_2_7b_model", "config": OPT_2_7B, "init_s": init_s, "pack_s": pack_s,
          "raw_gb": sum(t.numel() * t.element_size() for t in _tree_leaves(raw).values()) / 1e9,
          "step_weight_bytes": weight_bytes,
          "step_weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3})

    def step_bound(kv, pos_value):
        """The byte bound of a decode step with every slot at pos_value."""
        per_row = 4 * hd if kv == "bfloat16" else 2 * hd + 2 * 4
        cache = L * B * KV * ((pos_value + 1) * per_row + per_row)  # rows read, the row written
        return (weight_bytes + cache) / HBM_BYTES_PER_S * 1e3

    serving = {}
    for kv in ("int8", "bfloat16"):
        quant = kv == "int8"

        def make(graphs, kv=kv):
            return ContinuousBatcher(packed, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                     kv_dtype=kv, seed=0, device="cuda", cuda_graphs=graphs)

        def expect_of(steps, pre, quant=quant):
            expect = dict.fromkeys(WRAPPERS, 0)
            expect.update({"dequant_matmul": (4 * L + 1) * (steps + pre),
                           "cache_band_write": L * steps if quant else 0,
                           "decode_attention_layer": L * steps if quant else 0,
                           "decode_attention_write_bf16": 0 if quant else L * steps})
            return expect

        def check(tag, counts, routes, steps, pre):
            _check_routes(tag, routes, k1=(4 * L + 1) * pre)  # every prefill launch on the route
            _check_gemv(tag, counts, routes)  # every decode launch on the tensor-core GEMV

        runs = _serve_both(torch, ctx, "opt_2_7b", make, _serve_prompts(cfg, B), new, expect_of,
                           check, extra={"model": "OPT-2.7B", "layers": L, "head_dim": hd,
                                         "method": "rtn W4 g128", "kv": kv})
        g = runs["graph"]
        attn = "decode_attention_layer" if quant else "decode_attention_write_bf16"
        paths[f"opt_2_7b_{kv}"] = {**g["launches"], **g["routes"],
                                   f"{attn}_hd{hd}": g["launches"][attn]}
        steps = g["decode_steps"]
        serving[kv] = {
            mode: {"tokens_per_s": r["tokens_per_s"], "mean_ttft_s": r["mean_ttft_s"],
                   "warmup_s": r["warmup_s"],
                   "step_event_ms": r["decode_step"]["event_ms_per_step"],
                   "step_device_ms": r["decode_step"]["device_ms_per_step"],
                   "step_busy_share": r["decode_step"]["device_busy_share"]}
            for mode, r in runs.items()}
        serving[kv]["step_bound_ms"] = step_bound(kv, P)
        serving[kv]["step_bound_by"] = "bytes"
        serving[kv]["launches_per_step"] = {
            k: (g["launches"][k] - (4 * L + 1) * g["prefill_calls"] * (k == "dequant_matmul"))
            / steps for k in ("dequant_matmul", "cache_band_write", attn)}
        serving[kv]["graph_step_over_bound"] = (serving[kv]["graph"]["step_event_ms"]
                                                / serving[kv]["step_bound_ms"])
        torch.cuda.empty_cache()

    # the bench's three perplexities on the fixture
    ids = np.ascontiguousarray(load_fixture_test(str(FIXTURE_DIR)))
    ppl, per_block, launches = {}, {}, {}
    fake = quantize_model(raw, "rtn", EVAL_MCFG, arch="opt")
    for name, (p, qm) in (("raw", (raw, None)), ("rtn", (fake, None)),
                          ("packed", (packed, qmeta))):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl[name] = evaluate_perplexity(p, ids, cfg, n_samples=EVAL_BLOCKS, block_size=EVAL_BLOCK,
                                        qmeta=qm, arch="opt")
        per_block[name] = (time.perf_counter() - t0) / EVAL_BLOCKS
        launches[name] = {**_counts(), **_route_counts()}
        if name == "packed":
            paths["opt_2_7b_eval"] = {**launches[name],
                                      f"flash_attention_hd{hd}": launches[name]["flash_attention"]}
    del fake
    per_eval_block = {n: {k: c[k] / EVAL_BLOCKS for k in ("flash_attention", "dequant_matmul",
                                                           "flash_attention_wgmma",
                                                           "dequant_matmul_wgmma")}
                      for n, c in launches.items()}
    res = {"phase": "opt_2_7b", "model": "OPT-2.7B", "layers": L, "head_dim": hd,
           "method": "rtn W4 g128", "serving": serving, "perplexity": ppl,
           "packed_over_fake": ppl["packed"] / ppl["rtn"], "s_per_eval_block": per_block,
           "launches_per_eval_block": per_eval_block, "card": ctx["smi"]}
    emit(res)
    if not all(math.isfinite(v) for v in ppl.values()):
        raise AssertionError(f"OPT-2.7B perplexities not finite: {ppl}")
    if abs(ppl["packed"] / ppl["rtn"] - 1) >= 1e-2:
        raise AssertionError(f"OPT-2.7B packed perplexity not within 1% of fake-quant: {ppl}")
    want_block = {"flash_attention": L, "flash_attention_wgmma": L}
    for name, c in per_eval_block.items():
        if any(c[k] != v for k, v in want_block.items()):
            raise AssertionError(f"OPT-2.7B {name} eval: K5 launches {c} != {want_block} a block")
    packed_block = per_eval_block["packed"]
    if (packed_block["dequant_matmul"], packed_block["dequant_matmul_wgmma"]) != (4 * L + 1,) * 2:
        raise AssertionError(f"OPT-2.7B packed eval: K1 launches {packed_block} a block")
    _check_gemv("opt_2_7b eval", launches["packed"], launches["packed"])
    del raw, packed
    torch.cuda.empty_cache()


FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures" / "public_bytes"
EVAL_BLOCKS = 4
EVAL_MCFG = {"w_bit": 4, "q_group_size": 128}
# the falcon3 phase's depth, 16 of Falcon3-7B's 28 layers: at all 28 (33.5 s)
# the smoke's phases ran 1002 s on an H100 80GB HBM3 host, past their 1000 s
FALCON3_LAYERS = 16
FALCON3_LONG_LAYERS = 2  # its long-context run's depth (the per-layer cache at S 32768)
FALCON3_STEPS = 8  # decode steps of its teacher-forced holds against the plain run
FALCON3_TOL = 3e-2  # kernels' logits against the plain run's (relative): e2e's gate
# the depth the logits are held to the plain run's at FALCON3_TOL (e2e's and
# the extras' 2 layers): a bf16 difference grows through the random layers
# (at all 28 the kernels' logits 0.08 from the plain run's, and any one
# kernel family alone 0.04-0.08; the plain run's 0.09 from the f32 math, the
# kernels' 0.08, on an H100 80GB HBM3 at 700 W), so at the served depth the
# kernels' logits are held to the f32 math instead (_f32_held)
FALCON3_PLAIN_LAYERS = 2
# the kernels run alone, each family with the rest on their plain versions:
# how far each moves the logits from the plain run's at the served depth
FALCON3_FAMILIES = {
    "int8": {"K1": ("dequant_matmul",), "K4": ("fused_mlp",),
             "K2+K3": ("cache_band_write", "decode_attention")},
    "bfloat16": {"K1": ("dequant_matmul",), "K4": ("fused_mlp",),
                 "K8": ("decode_attention_write_bf16",)},
    "eval": {"K1": ("dequant_matmul",), "K5": ("flash_attention",)},
}


def _per_step(torch, a, b):
    return [rel_err(torch, a[:, i], b[:, i]) for i in range(a.shape[1])]


def _f32_held(gate, kern_vs_f32, plain_vs_f32):
    """The served depth's gate: the kernels' logits within FALCON3_TOL of
    the f32 math on the same bytes, or no farther from it than the plain
    bf16 run's are."""
    return {"kernels_vs_f32": kern_vs_f32, "plain_vs_f32": plain_vs_f32,
            "held": kern_vs_f32 < max(FALCON3_TOL, plain_vs_f32), "gate": gate}


def _falcon3_forced(torch, packed, qmeta, cfg, prompts, toks, kv, kernels=None):
    """The engine's greedy run teacher-forced on its tokens `toks` [B, n],
    eagerly: the prefill of `prompts` and FALCON3_STEPS decode steps on a
    fresh `kv` cache, with the kernels (kernels None) or with only the
    kernels named in `kernels` (WRAPPERS' names) and every other kernel's
    plain version on the card. Returns the logits [B, 1 + steps, V] on the
    host (the prefill's first) and the launches."""
    import numpy as np

    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    ids = torch.tensor(np.stack(prompts), device="cuda")
    B, P = ids.shape
    _reset_counts()
    with contextlib.nullcontext() if kernels is None else _PlainKernels(kernels):
        cache = init_cache(cfg, B, P + FALCON3_STEPS + 16, quantized=kv == "int8",
                           device="cuda")
        logits, cache = prefill(packed, ids, cache, cfg, qmeta)
        outs = [logits.float().cpu()]
        for i in range(FALCON3_STEPS):
            pos = torch.full((B,), P + i, dtype=torch.int32, device="cuda")
            tok = torch.as_tensor(toks[:, i], dtype=torch.int32, device="cuda")
            logits, cache = decode_step(packed, tok, pos, cache, cfg, qmeta)
            outs.append(logits.float().cpu())
    return torch.stack(outs, 1), _counts()


def _falcon3_serve_holds(torch, packed, qmeta, cfg, prompts, toks, kv):
    """The engine's run on the `kv` cache held to the plain run of the same
    bytes (_falcon3_forced): at the served depth the logits of the kernels,
    of the plain bf16 run and of the plain functions in f32 (_f32), each
    kernel family alone against the plain run (FALCON3_FAMILIES), the
    engine's tokens against the plain run's argmax past SHARD_FLIP_GAP and
    against the kernels' forced argmax; at FALCON3_PLAIN_LAYERS the kernels'
    logits against the plain run's. Returns (readings, failures)."""
    import numpy as np

    L, n = cfg.num_layers, FALCON3_PLAIN_LAYERS
    kern, kc = _falcon3_forced(torch, packed, qmeta, cfg, prompts, toks, kv)
    plain, _ = _falcon3_forced(torch, packed, qmeta, cfg, prompts, toks, kv, kernels=())
    f32, _ = _falcon3_forced(torch, _f32(packed), qmeta, cfg, prompts, toks, kv, kernels=())
    pad = torch.cat([plain, plain[:, -1:]], 1)  # _token_check drops the last logits
    r = {"kernels_vs_plain": _per_step(torch, kern, plain),
         "served": _f32_held("per step, max", max(_per_step(torch, kern, f32)),
                             max(_per_step(torch, plain, f32))),
         "alone_vs_plain": {
             fam: max(_per_step(torch, _falcon3_forced(torch, packed, qmeta, cfg, prompts, toks,
                                                       kv, kernels=names)[0], plain))
             for fam, names in FALCON3_FAMILIES[kv].items()},
         "tokens": _token_check(pad, pad, torch.as_tensor(toks[:, :FALCON3_STEPS + 1])),
         "engine_tokens_are_forced_argmax": bool(np.array_equal(
             kern.argmax(-1).numpy(), toks[:, :FALCON3_STEPS + 1])),
         "forced_launches": {k: v for k, v in kc.items() if v}}
    del kern, plain, f32
    cut, ccfg = _cut(packed, n), cfg.replace(num_layers=n)
    r[f"kernels_vs_plain_{n}_layers"] = _per_step(
        torch, _falcon3_forced(torch, cut, qmeta, ccfg, prompts, toks, kv)[0],
        _falcon3_forced(torch, cut, qmeta, ccfg, prompts, toks, kv, kernels=())[0])
    attn = "decode_attention" if kv == "int8" else "decode_attention_write_bf16"
    fails = []
    if max(r[f"kernels_vs_plain_{n}_layers"]) >= FALCON3_TOL:
        fails.append(f"{kv}: the kernels' logits against the plain run's at {n} layers "
                     f"{r[f'kernels_vs_plain_{n}_layers']}")
    if not r["served"]["held"]:
        fails.append(f"{kv}: the kernels' logits against the f32 math at {L} layers "
                     f"{r['served']}")
    if r["tokens"]["differ_clear"] or not r["engine_tokens_are_forced_argmax"]:
        fails.append(f"{kv}: the engine's tokens {r['tokens']}, forced argmax "
                     f"{r['engine_tokens_are_forced_argmax']}")
    if kc[attn] != L * FALCON3_STEPS:
        fails.append(f"{kv}: the forced run launched {attn} {kc[attn]} times")
    return r, fails


def _falcon3_eval_holds(torch, packed, qmeta, cfg, blk):
    """One eval block `blk` [1, EVAL_BLOCK] through the model's forward (K5
    a layer, K1 on the Hopper route), held like the serving runs: at the
    served depth the logits and the per-token NLL of the kernels against
    the plain run's, the logits against the f32 math (_f32_held) and each
    family alone against the plain run; at FALCON3_PLAIN_LAYERS the logits
    against the plain run's (FALCON3_TOL). Returns (readings, failures)."""
    from qtpu_torch.models import llama

    def fwd(p, c, kernels=None):
        with contextlib.nullcontext() if kernels is None else _PlainKernels(kernels):
            return llama.forward(p, blk, c, qmeta=qmeta)

    def nll(logits):
        return torch.nn.functional.cross_entropy(logits[0, :-1], blk[0, 1:].long(),
                                                 reduction="none")

    n = FALCON3_PLAIN_LAYERS
    plain = fwd(packed, cfg, ())
    f32 = fwd(_f32(packed), cfg, ())
    plain_vs_f32 = rel_err(torch, plain, f32)
    kern = fwd(packed, cfg)
    r = {"kernels_vs_plain": rel_err(torch, kern, plain),
         "nll_kernels_vs_plain": rel_err(torch, nll(kern), nll(plain)),
         "served": _f32_held("logits", rel_err(torch, kern, f32), plain_vs_f32)}
    del kern, f32
    r["alone_vs_plain"] = {fam: rel_err(torch, fwd(packed, cfg, names), plain)
                           for fam, names in FALCON3_FAMILIES["eval"].items()}
    del plain
    cut, ccfg = _cut(packed, n), cfg.replace(num_layers=n)
    r[f"kernels_vs_plain_{n}_layers"] = rel_err(torch, fwd(cut, ccfg), fwd(cut, ccfg, ()))
    fails = []
    if r[f"kernels_vs_plain_{n}_layers"] >= FALCON3_TOL or not r["served"]["held"]:
        fails.append(f"eval: the block's logits {r}")
    return r, fails


def _falcon3_long(torch, packed, qmeta, cfg, plain=False):
    """FALCON3_LONG_LAYERS layers of the model on the per-layer int8 cache
    at S 32768 (LONG_S: K12's layout), B 8, every row filled with seeded
    random codes and scales (0.01-0.06), then 4 decode steps of seeded
    tokens at S - 80 + i, with the kernels (K12 a layer a step) or their
    plain versions. Returns the logits [B, 4, V] on the host and the
    launches."""
    from qtpu_torch.serve.decode import decode_step
    from qtpu_torch.serve.kvcache import init_cache

    B, S, steps = SERVE_B, LONG_S, 4
    g = torch.Generator(device="cuda").manual_seed(5)
    _reset_counts()
    with _PlainKernels() if plain else contextlib.nullcontext():
        cache = init_cache(cfg, B, S, quantized=True, device="cuda", per_layer=True)
        for t in (*cache.k, *cache.v):
            t.random_(-127, 128, generator=g)
        for t in (*cache.k_scale, *cache.v_scale):
            t.uniform_(0.01, 0.06, generator=g)
        outs = []
        for i in range(steps):
            tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
            pos = torch.full((B,), S - 80 + i, dtype=torch.int32, device="cuda")
            logits, cache = decode_step(packed, tok, pos, cache, cfg, qmeta)
            outs.append(logits.float().cpu())
        del cache
    return torch.stack(outs, 1), _counts()


def phase_falcon3(torch, ctx):
    """Falcon3-7B-Base at full width on the card (FALCON3_7B: the published
    config.json's widths, 12 q heads and 4 kv heads of 256; FALCON3_LAYERS
    of its 28 layers), random per-layer weights from seed 0, RTN W4 g128
    packed with fused q/k/v: the engine at 8 x (128 + 32), greedy, on CUDA
    graphs on the int8 cache (K2 and K3 a layer a decode step) and the bf16
    cache (K8), launches and routes as reckoned, tokens/s and TTFT, each held
    to the plain run of the same bytes and to the f32 math
    (_falcon3_serve_holds); one eval block of 2048 on the fixture through K5
    (its Hopper body, a layer): the perplexity against the plain forward's
    (1%) and the block's logits held the same way (_falcon3_eval_holds); K12
    on the per-layer cache at S 32768 (_falcon3_long) against the plain run
    (FALCON3_TOL)."""
    import numpy as np

    from qtpu_torch.convert import map_tree
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import ModelConfig
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.batching import ContinuousBatcher

    cfg = ModelConfig(**{**FALCON3_7B, "num_layers": FALCON3_LAYERS})
    L, B, P, new, hd = cfg.num_layers, SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.head_dim
    paths = ctx.setdefault("path_launches", {})
    t0 = time.perf_counter()
    raw = llama.init_params(cfg, seed=0, device="cuda")
    packed, qmeta = fuse_packed_sites(*pack_model(raw, "rtn", EVAL_MCFG))
    del raw
    torch.cuda.synchronize()
    parts = {"setup": time.perf_counter() - t0}
    emit({"phase": "falcon3_model", "config": FALCON3_7B, "layers": L, "setup_s": parts["setup"],
          "packed_gb": sum(t.numel() * t.element_size()
                           for t in _tree_leaves(packed).values()) / 1e9})
    prompts = _serve_prompts(cfg, B)
    res = {"phase": "falcon3", "model": "Falcon3-7B-Base", "layers": L, "head_dim": hd,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "method": "rtn W4 g128",
           "serving": {}, "card": ctx["smi"]}
    fails = []
    for kv in ("int8", "bfloat16"):
        t0 = time.perf_counter()
        quant = kv == "int8"
        eng = ContinuousBatcher(packed, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                kv_dtype=kv, seed=0, device="cuda", cuda_graphs=True)
        warm = _warm_engine(torch, eng, "falcon3", "graph")
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_counts()
        t1 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts, routes, m = _counts(), _route_counts(), eng.metrics()
        steps, pre = m["decode_steps"], m["prefill_calls"]
        expect = _serve_launches(L, steps, pre)
        if not quant:
            expect.update(cache_band_write=0, decode_attention=0,
                          decode_attention_write_bf16=L * steps)
        toks = np.array([r.output for r in reqs])
        if toks.shape != (B, new) or counts != expect or steps == 0:
            raise AssertionError(f"falcon3 {kv}: tokens {toks.shape}, launches {counts} != "
                                 f"expected {expect}")
        _check_serve_routes(f"falcon3 {kv}", counts, routes, L, pre)
        attn = "decode_attention" if quant else "decode_attention_write_bf16"
        paths[f"falcon3_{kv}"] = {**counts, **routes, f"{attn}_hd{hd}": counts[attn],
                                  "dequant_matmul_falcon3": counts["dequant_matmul"],
                                  "dequant_matmul_wgmma_falcon3": routes["dequant_matmul_wgmma"],
                                  "fused_mlp_falcon3": counts["fused_mlp"]}
        del eng
        torch.cuda.empty_cache()
        holds, bad = _falcon3_serve_holds(torch, packed, qmeta, cfg, prompts, toks, kv)
        fails += bad
        serving = {"tokens_per_s": B * new / wall, "mean_ttft_s": m.get("mean_ttft_s"),
                   "decode_steps": steps, "prefill_calls": pre, **warm,
                   "launches": {k: v for k, v in counts.items() if v}, **holds,
                   "seconds": time.perf_counter() - t0}
        res["serving"][kv] = serving
        emit({"phase": f"falcon3_{kv}", **serving, "card": ctx["smi"]})
        parts[kv] = serving["seconds"]

    # one eval block of 2048 through K5 at hd 256, against the plain forward
    t0 = time.perf_counter()
    ids = np.ascontiguousarray(load_fixture_test(str(FIXTURE_DIR)))
    _reset_counts()
    ppl = evaluate_perplexity(packed, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qmeta)
    ec = {**_counts(), **_route_counts()}
    with _PlainKernels():
        ppl_plain = evaluate_perplexity(packed, ids, cfg, n_samples=1, block_size=EVAL_BLOCK,
                                        qmeta=qmeta)
    paths["falcon3_eval"] = {**ec, f"flash_attention_hd{hd}": ec["flash_attention"],
                             "dequant_matmul_wgmma_falcon3": ec["dequant_matmul_wgmma"]}
    blk = torch.as_tensor(ids[:, :EVAL_BLOCK]).cuda()  # the block evaluate_perplexity took
    holds, bad = _falcon3_eval_holds(torch, packed, qmeta, cfg, blk)
    fails += bad
    res["eval"] = {"block": EVAL_BLOCK, "perplexity": ppl, "plain_perplexity": ppl_plain,
                   "ratio": ppl / ppl_plain, **holds,
                   "launches": {k: v for k, v in ec.items() if v}}
    if abs(ppl / ppl_plain - 1) >= 1e-2 or not math.isfinite(ppl):
        fails.append(f"eval: perplexity {ppl} against the plain forward's {ppl_plain}")
    want = {"flash_attention": L, "flash_attention_wgmma": L, "dequant_matmul": 4 * L + 1,
            "dequant_matmul_wgmma": 4 * L + 1}
    if any(ec[k] != v for k, v in want.items()):
        fails.append(f"eval: launches {ec} against {want}")
    parts["eval"] = time.perf_counter() - t0

    # K12 at S 32768 on the first FALCON3_LONG_LAYERS layers
    t0 = time.perf_counter()
    Ll = FALCON3_LONG_LAYERS
    lcfg = cfg.replace(num_layers=Ll)
    cut = dict(packed, layers=map_tree(packed["layers"], lambda t: t[:Ll]))
    kern, lc = _falcon3_long(torch, cut, qmeta, lcfg)
    plain, _ = _falcon3_long(torch, cut, qmeta, lcfg, plain=True)
    errs = _per_step(torch, kern, plain)
    paths["falcon3_long"] = {**lc, f"decode_attention_flash_hd{hd}": lc["decode_attention_flash"]}
    res["long"] = {"S": LONG_S, "layers": Ll, "B": B, "rel_err_per_step": errs,
                   "launches": {k: v for k, v in lc.items() if v}}
    if max(errs) >= FALCON3_TOL or lc["decode_attention_flash"] != Ll * 4:
        fails.append(f"long: K12 against the plain run {errs}, launches {lc}")
    parts["long"] = time.perf_counter() - t0
    res["seconds"] = parts
    emit(res)
    del packed, cut
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("falcon3: " + "; ".join(fails))


def phase_eval(torch, ctx):
    """The quantize-and-evaluate path at full width through its normal entry
    point, `python -m qtpu_torch.bench` (its main() in this process):
    TinyLlama-1.1B (22 layers, random weights from seed 0), the committed
    byte-level fixture, 4 test blocks of 2048 tokens, RTN W4 g128 fake-quant
    and packed eval, and the serving pseudo-method. Checks the perplexities,
    the size accounting and every kernel's launch count; then the time per
    warm eval block of raw, fake-quant and packed weights, a profiler split
    of one warm packed block, and a 2-layer eval on the card against the
    CPU (plain versions)."""
    import tempfile

    import numpy as np

    from qtpu_torch.bench import runner
    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.convert import map_tree
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model, quantize_model

    fixture = f"fixture:{FIXTURE_DIR}"
    config = {
        "model_name": "tinyllama-random", "quantization_methods": ["rtn"],
        "calibration_dataset": fixture, "n_calibration_samples": 4,
        "calibration_block_size": 512,
        "test_dataset": fixture, "n_test_samples": EVAL_BLOCKS, "test_block_size": EVAL_BLOCK,
        "quantization_config": {"rtn": dict(EVAL_MCFG)},
        "packed_eval": True,
        "serving": {"benchmark": True, "kv_cache_dtype": "int8", "max_batch_size": 8},
        "seed": 0, "device": "cuda", "verbose": True,
    }
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, out_path = Path(tmp) / "config.json", Path(tmp) / "results.json"
        cfg_path.write_text(json.dumps(config))
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = bench_main([str(cfg_path), "--out", str(out_path)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        saved = json.loads(out_path.read_text())

    routes = _route_counts()
    L, nb = cfg.num_layers, EVAL_BLOCKS
    runs = 2  # benchmark_serving: a warm run, then the timed run
    steps = runner.SERVE_WARM_STEPS + runner.SERVE_STEPS
    expect = {
        "dequant_matmul": (4 * L + 1) * nb + runs * (4 * L + 1) + steps * (2 * L + 1),
        "cache_band_write": steps * L, "decode_attention": steps * L, "fused_mlp": steps * L,
        "flash_attention": 3 * nb * L,  # raw, fake-quant and packed evals
        "w8a8_matmul": 0, **NO_CODEBOOK,
    }
    res = saved["results"]
    raw, rt, sv = res.get("raw", {}), res.get("rtn", {}), res.get("serving", {})
    ppl = {"raw": raw.get("perplexity"), "rtn": rt.get("perplexity"),
           "packed": rt.get("packed_perplexity")}
    out = {"phase": "eval", "model": "TinyLlama-1.1B", "layers": L, "blocks": nb,
           "block_size": EVAL_BLOCK, "method": "rtn W4 g128", "rc": rc, "wall_s": wall,
           "perplexity": ppl, "model_size_mb": rt.get("model_size_mb"),
           "bits_per_byte": rt.get("bits_per_byte"),
           "runtime_s": {k: v.get("runtime_seconds") for k, v in res.items()},
           "serving_tokens_per_s": sv.get("tokens_per_second"),
           "errors": {k: v.get("error") or v.get("packed_error") for k, v in res.items()},
           "peak_mem_gib": peak_gib, "launches": counts, "expected_launches": expect,
           "routes": routes, "environment": saved.get("environment"), "card": ctx["smi"]}
    emit(out)
    if rc != 0 or any(out["errors"].values()) or set(res) != {"raw", "rtn", "serving"}:
        raise AssertionError(f"the benchmark run failed: {out['errors']}")
    if not all(p is not None and math.isfinite(p) for p in ppl.values()):
        raise AssertionError(f"perplexities not finite: {ppl}")
    if abs(ppl["packed"] / ppl["rtn"] - 1) >= 1e-2:
        raise AssertionError(f"packed perplexity not within 1% of fake-quant: {ppl}")
    if round(out["model_size_mb"], 2) != 68.13 or round(out["bits_per_byte"], 3) != 2.078:
        raise AssertionError(f"size accounting {out['model_size_mb']} MB, "
                             f"{out['bits_per_byte']} bits per byte != 68.13 / 2.078")
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != expected {expect}")
    if not sv.get("tokens_per_second"):
        raise AssertionError("the serving pseudo-method measured nothing")
    # every K1 launch of a packed eval block (M 2048) and of a serving
    # prefill (M 1024) took the Hopper route
    _check_routes("eval", routes, k1=(4 * L + 1) * (nb + runs))
    # every K5 launch took its Hopper body, every serving decode launch the
    # tensor-core GEMV
    _check_gemv("eval", counts, routes)
    ctx.setdefault("path_launches", {})["eval"] = {**counts, **routes}

    # warm blocks of the same three models, each timed around a synchronize
    ids = load_fixture_test(str(FIXTURE_DIR))
    params = llama.init_params(cfg, seed=0, device="cuda")
    models = {"raw": (params, None), "rtn": (quantize_model(params, "rtn", EVAL_MCFG), None),
              "packed": fuse_packed_sites(*pack_model(params, "rtn", EVAL_MCFG))}
    per_block = {}
    for name, (p, qm) in models.items():
        evaluate_perplexity(p, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qm)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_perplexity(p, ids, cfg, n_samples=3, block_size=EVAL_BLOCK, qmeta=qm)
        per_block[name] = (time.perf_counter() - t0) / 3
    packed, qmeta = models["packed"]
    prof = _profiled(torch, lambda: evaluate_perplexity(packed, ids, cfg, n_samples=1,
                                                        block_size=EVAL_BLOCK, qmeta=qmeta),
                     1, classify=_kind)
    del models, params, packed
    torch.cuda.empty_cache()
    emit({"phase": "eval_timing", "s_per_block": per_block,
          "tokens_per_s": {k: EVAL_BLOCK / v for k, v in per_block.items()},
          "profile_packed_block": prof, "peak_mem_gib_main_run": peak_gib, "card": ctx["smi"]})

    # 2 layers at TinyLlama widths: the card (kernels) against the CPU (plain
    # versions), one block of the fixture, raw and packed weights
    cfg2 = cfg.replace(num_layers=2)
    p2 = llama.init_params(cfg2, seed=7, device="cpu")
    two = {"raw": (p2, None), "packed": fuse_packed_sites(*pack_model(p2, "rtn", EVAL_MCFG))}
    ids2 = np.ascontiguousarray(ids[:, :EVAL_BLOCK])
    cmp = {}
    for name, (p, qm) in two.items():
        on_cpu = evaluate_perplexity(p, ids2, cfg2, 1, EVAL_BLOCK, qmeta=qm)
        on_card = evaluate_perplexity(map_tree(p, lambda t: t.to("cuda")), ids2, cfg2, 1,
                                      EVAL_BLOCK, qmeta=qm)
        cmp[name] = {"cpu": on_cpu, "card": on_card, "rel": abs(on_card / on_cpu - 1)}
    emit({"phase": "eval_e2e", "layers": 2, "block_size": EVAL_BLOCK, "perplexity": cmp,
          "tol_rel": 1e-2})
    if not all(c["rel"] < 1e-2 for c in cmp.values()):
        raise AssertionError(f"card and CPU perplexities differ: {cmp}")


QUANT_MCFG = {
    "awq": {"w_bit": 4, "q_group_size": 128},
    "gptq": {"w_bit": 4, "q_group_size": 128, "error_compensation": True},
    "smoothquant": {"w_bit": 8, "q_group_size": 128, "alpha": 0.5, "act_quant": True},
}
CALIB_BLOCKS, CALIB_BLOCK = 4, 512
WRAPPERS = {  # kernel -> (module, wrapper name)
    "dequant_matmul": ("dequant_matmul", "quantized_matmul"),
    "cache_band_write": ("kv_attention", "cache_band_write"),
    "decode_attention": ("kv_attention", "decode_attention"),
    "fused_mlp": ("fused_mlp", "fused_mlp"),
    "flash_attention": ("flash_attention", "flash_attention"),
    "w8a8_matmul": ("int8_matmul", "w8a8_matmul"),
    "codebook_matmul": ("codebook_matmul", "codebook_matmul"),
    "decode_attention_write_bf16": ("kv_attention", "decode_attention_write_bf16"),
    "moe_matmul": ("moe_matmul", "moe_matmul"),
    "moe_gathered_matmul": ("moe_matmul", "moe_gathered_matmul"),
    "decode_attention_write": ("kv_attention", "decode_attention_write"),
    "decode_attention_layer": ("kv_attention", "decode_attention_layer"),
    "decode_attention_flash": ("kv_attention", "decode_attention_flash"),
    "decode_attention_write_banded": ("kv_attention", "decode_attention_write_banded"),
    "decode_attention_write_banded_stacked": ("kv_attention",
                                              "decode_attention_write_banded_stacked"),
    "layer_boundary": ("layer_boundary", "layer_boundary"),
    # K1's launches with qtpu's norm_w / resid options (also in dequant_matmul's)
    "dequant_matmul_norm_w": ("dequant_matmul", "quantized_matmul", "norm_launches"),
    "dequant_matmul_resid": ("dequant_matmul", "quantized_matmul", "resid_launches"),
}
# the route counters of K1, K7, K9 and K6: launches of the Hopper route
# (csrc/dq_wgmma.cuh; K6's in csrc/w8a8_matmul.cu) and of the mma.sync body,
# kept apart from WRAPPERS' counts (each such launch is also in its kernel's
# count)
ROUTES = {
    "dequant_matmul_wgmma": ("dequant_matmul", "quantized_matmul", "wgmma_launches"),
    "dequant_matmul_mma": ("dequant_matmul", "quantized_matmul", "mma_launches"),
    "codebook_matmul_wgmma": ("codebook_matmul", "codebook_matmul", "wgmma_launches"),
    "codebook_matmul_mma": ("codebook_matmul", "codebook_matmul", "mma_launches"),
    "moe_matmul_wgmma": ("moe_matmul", "moe_matmul", "wgmma_launches"),
    "moe_matmul_mma": ("moe_matmul", "moe_matmul", "mma_launches"),
    "w8a8_matmul_wgmma": ("int8_matmul", "w8a8_matmul", "wgmma_launches"),
    "w8a8_matmul_mma": ("int8_matmul", "w8a8_matmul", "mma_launches"),
    # the decode GEMVs of K1, K7, K9, K10 and K4: the tensor-core body
    # (csrc/dq_gemv_tc.cuh) and dq_core's SIMT body; K5's two bodies
    "dequant_matmul_gemv_tc": ("dequant_matmul", "quantized_matmul", "gemv_tc_launches"),
    "dequant_matmul_gemv": ("dequant_matmul", "quantized_matmul", "gemv_launches"),
    "codebook_matmul_gemv_tc": ("codebook_matmul", "codebook_matmul", "gemv_tc_launches"),
    "codebook_matmul_gemv": ("codebook_matmul", "codebook_matmul", "gemv_launches"),
    "moe_matmul_gemv_tc": ("moe_matmul", "moe_matmul", "gemv_tc_launches"),
    "moe_matmul_gemv": ("moe_matmul", "moe_matmul", "gemv_launches"),
    "moe_gathered_matmul_gemv_tc": ("moe_matmul", "moe_gathered_matmul", "gemv_tc_launches"),
    "moe_gathered_matmul_gemv": ("moe_matmul", "moe_gathered_matmul", "gemv_launches"),
    "fused_mlp_gemv_tc": ("fused_mlp", "fused_mlp", "gemv_tc_launches"),
    "fused_mlp_gemv": ("fused_mlp", "fused_mlp", "gemv_launches"),
    "flash_attention_wgmma": ("flash_attention", "flash_attention", "wgmma_launches"),
    "flash_attention_mma": ("flash_attention", "flash_attention", "mma_launches"),
    # K6's decode GEMV (tensor-core or dp4a body) and K13's tiles (the
    # tensor-core step or dq_core's)
    "w8a8_matmul_gemv_tc": ("int8_matmul", "w8a8_matmul", "gemv_tc_launches"),
    "w8a8_matmul_gemv": ("int8_matmul", "w8a8_matmul", "gemv_launches"),
    "layer_boundary_gemv_tc": ("layer_boundary", "layer_boundary", "gemv_tc_launches"),
    "layer_boundary_gemv": ("layer_boundary", "layer_boundary", "gemv_launches"),
    # K6's modes for a row-parallel W8A8 site under TP: the absmax pass, and
    # the launches (also in w8a8_matmul's) that quantize with a given
    # absmax, in all and by route
    "w8a8_absmax": ("int8_matmul", "w8a8_absmax"),
    "w8a8_epilogue": ("int8_matmul", "w8a8_epilogue"),
    "w8a8_matmul_absmax_in": ("int8_matmul", "w8a8_matmul", "absmax_in_launches"),
    **{f"w8a8_matmul_absmax_in_{r}": ("int8_matmul", "w8a8_matmul",
                                      f"absmax_in_{r}_launches")
       for r in ("gemv_tc", "gemv", "wgmma", "mma")},
}
# the kernels of the layer-boundary branches (K13, K1's options), which only
# the boundary phase's switches turn on
NO_BOUNDARY = {"layer_boundary": 0, "dequant_matmul_norm_w": 0, "dequant_matmul_resid": 0}
# the entries of the long-context and GPT-2/OPT paths (K12, the one-layer
# decode attention), which the earlier paths never launch
NO_LONG = {"decode_attention_layer": 0, "decode_attention_flash": 0,
           "decode_attention_write_banded": 0, "decode_attention_write_banded_stacked": 0,
           **NO_BOUNDARY}
NO_MOE = {"moe_matmul": 0, "moe_gathered_matmul": 0, "decode_attention_write": 0, **NO_LONG}
# paths without K7/K8 (nor the MoE kernels K9-K11)
NO_CODEBOOK = {"codebook_matmul": 0, "decode_attention_write_bf16": 0, **NO_MOE}


def _wrappers(table=None):
    """{kernel: (wrapper, name of its counter)} of WRAPPERS (or table)."""
    import importlib

    return {k: (getattr(importlib.import_module(f"qtpu_torch.kernels.{m}"), f),
                attr[0] if attr else "launches")
            for k, (m, f, *attr) in (WRAPPERS if table is None else table).items()}


def _reset_counts():
    for table in (WRAPPERS, ROUTES):
        for w, attr in _wrappers(table).values():
            setattr(w, attr, 0)


def _counts():
    return {k: getattr(w, attr) for k, (w, attr) in _wrappers().items()}


def _route_counts():
    return {k: getattr(w, attr) for k, (w, attr) in _wrappers(ROUTES).items()}


def _check_routes(phase, routes, k1=0, k7=0, k9=0, k6=0):
    """Every K1 (k1), K7 (k7), K9 (k9) and K6 (k6) launch of a prefill or eval
    block took the Hopper route, and none the mma.sync body."""
    expect = {"dequant_matmul_wgmma": k1, "dequant_matmul_mma": 0,
              "codebook_matmul_wgmma": k7, "codebook_matmul_mma": 0,
              "moe_matmul_wgmma": k9, "moe_matmul_mma": 0,
              "w8a8_matmul_wgmma": k6, "w8a8_matmul_mma": 0}
    got = {k: routes[k] for k in expect}
    if got != expect:
        raise AssertionError(f"{phase}: route launches {got} != expected {expect}")


def _check_gemv(phase, counts, routes, ragged_k1=0):
    """Every M <= 8 launch of K1, K7, K9, K4 and K6 and every K10 launch of a
    run (those not on
    the Hopper route or the mma.sync body) took the tensor-core GEMV, but
    ragged_k1 K1 launches at GPT-2's 50257-wide lm_head (dq_core's GEMV);
    every K13 launch took the tensor-core tiles; and every K5 launch took
    its Hopper body. Returns the GEMV launches."""
    seen = {}
    for kernel in ("dequant_matmul", "codebook_matmul", "moe_matmul", "moe_gathered_matmul",
                   "fused_mlp", "w8a8_matmul"):
        gemv = counts[kernel] - routes.get(f"{kernel}_wgmma", 0) - routes.get(f"{kernel}_mma", 0)
        want = {"tc": gemv - (ragged_k1 if kernel == "dequant_matmul" else 0),
                "simt": ragged_k1 if kernel == "dequant_matmul" else 0}
        got = {"tc": routes[f"{kernel}_gemv_tc"], "simt": routes[f"{kernel}_gemv"]}
        if got != want:
            raise AssertionError(f"{phase}: {kernel}'s GEMV launches {got} != expected {want}")
        seen[kernel] = got
    k13 = {"tc": routes["layer_boundary_gemv_tc"], "simt": routes["layer_boundary_gemv"]}
    if k13 != {"tc": counts["layer_boundary"], "simt": 0}:
        raise AssertionError(f"{phase}: K13's launches {k13} of {counts['layer_boundary']}")
    seen["layer_boundary"] = k13
    k5 = {"wgmma": routes["flash_attention_wgmma"], "mma": routes["flash_attention_mma"]}
    if k5 != {"wgmma": counts["flash_attention"], "mma": 0}:
        raise AssertionError(f"{phase}: K5's launches {k5} of {counts['flash_attention']}")
    return seen


def _kind(name: str) -> str:
    """The kernel of a profiled CUDA kernel's name, for the splits by kind."""
    # dq_kernel<BITS, TM, CQ, MODE, VEC>, dq_finish<MODE>, dq_mma_kernel<BITS, CB, VEC>,
    # dq_wgmma_kernel<BITS, CB, G, EXPERTS>, dq_gemv_tc_kernel<BITS, MODE, EXPERTS>
    if (("dq_wgmma_kernel<" in name or "dq_gemv_tc_kernel<" in name)
            and name.split(">")[0].endswith("true")):
        return "K9 moe_matmul"  # the expert axis of the Hopper route or the tensor-core GEMV
    if "dq_gemv_tc_kernel<" in name and name.split(">")[0].replace(" ", "").split(",")[1] == "3":
        return "K7 codebook_matmul"
    if "dq_" in name and any(t in name for t in (", 3, ", "dq_finish<3>", "dq_mma_kernel<4, true",
                                                  "dq_wgmma_kernel<4, true")):
        return "K7 codebook_matmul"  # the codebook mode of the shared dequant core
    if "moe_gathered_tc_kernel" in name or ("moe_gemv_kernel" in name and ", 1>" in name):
        return "K10 moe_gathered_matmul"  # the tensor-core body, or one slot per row tile
    if "decode_attn" in name:  # K3's kernel: decode_attn[_cluster]_kernel<[HD, ]BF, QW>
        flags = [a.strip() for a in name.split("<", 1)[-1].split(">")[0].split(",")]
        flags = [a for a in flags if a in ("true", "false")]
        if flags[:1] == ["true"]:
            return "K8 decode_attention_write_bf16"
        if flags[1:2] == ["true"]:
            return "K11 decode_attention_write"
        return "K3 decode_attention (and the one-layer entry)"
    for tag, kind in (("boundary_kernel", "K13 layer_boundary"),
                      ("flash_split", "K12 decode_attention_flash"),
                      ("flash_combine", "K12 decode_attention_flash"),
                      ("w8a8", "K6 w8a8_matmul"), ("flash_attn_kernel", "K5 flash_attention"),
                      ("flash_wgmma_kernel", "K5 flash_attention"),
                      ("band_write", "K2 cache_band_write"), ("moe_", "K9 moe_matmul"),
                      ("dq_", "K1 dequant_matmul")):
        if tag in name:
            return kind
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas")):
        return "dense GEMM"
    return "rest"


def _calib_blocks(cfg, n=CALIB_BLOCKS):
    from qtpu_torch.data import get_calibration_dataset

    return get_calibration_dataset(None, f"fixture:{FIXTURE_DIR}", None, "validation",
                                   n_samples=n, block_size=CALIB_BLOCK,
                                   vocab_size=cfg.vocab_size)


def phase_quant(torch, ctx):
    """The calibrated methods at full width through `python -m
    qtpu_torch.bench` (main() in this process), with their costs taken
    inside that run: the calibrations, each method's quantize and pack;
    then warm blocks of the run's packed artifacts with a profiler split,
    and a 2-layer packed eval on the card against the CPU on the same packed
    bytes."""
    import tempfile

    import numpy as np

    from qtpu_torch.bench import runner
    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.convert import map_tree
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fold_smooth, fuse_packed_sites, pack_model

    fixture = f"fixture:{FIXTURE_DIR}"
    methods = list(QUANT_MCFG)
    config = {
        "model_name": "tinyllama-random", "quantization_methods": methods,
        "calibration_dataset": fixture, "n_calibration_samples": CALIB_BLOCKS,
        "calibration_block_size": CALIB_BLOCK,
        "test_dataset": fixture, "n_test_samples": EVAL_BLOCKS, "test_block_size": EVAL_BLOCK,
        "quantization_config": QUANT_MCFG, "packed_eval": True,
        "serving": {"benchmark": True, "kv_cache_dtype": "int8", "max_batch_size": 8,
                    "pack_method": "smoothquant"},
        "seed": 0, "device": "cuda", "verbose": True,
    }
    # the calibrations and each method's quantize and pack timed inside the
    # bench, on the host around a synchronize (the first of each), its
    # packed artifacts kept
    times, artifacts = {}, {}
    real = (runner.collect_calibration_stats, runner.quantize_model,
            runner.QuantizationBenchmark._packed)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times.setdefault(name, time.perf_counter() - t0)
        return r

    def calibrate(*a, **kw):
        return timed("calibrate_hessian" if kw.get("collect_hessian") else "calibrate",
                     lambda: real[0](*a, **kw))

    def quantize(params, method, *a, **kw):
        return timed(f"quantize_{method}", lambda: real[1](params, method, *a, **kw))

    def packed(bench, method, mcfg, stats=None):
        artifacts[method] = timed(f"pack_{method}", lambda: real[2](bench, method, mcfg, stats))
        return artifacts[method]

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, out_path = Path(tmp) / "config.json", Path(tmp) / "results.json"
        cfg_path.write_text(json.dumps(config))
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (runner.collect_calibration_stats, runner.quantize_model,
         runner.QuantizationBenchmark._packed) = (calibrate, quantize, packed)
        t0 = time.perf_counter()
        try:
            rc = bench_main([str(cfg_path), "--out", str(out_path)])
        finally:
            (runner.collect_calibration_stats, runner.quantize_model,
             runner.QuantizationBenchmark._packed) = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        routes = _route_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        saved = json.loads(out_path.read_text())

    L, nb = cfg.num_layers, EVAL_BLOCKS
    steps = runner.SERVE_WARM_STEPS + runner.SERVE_STEPS
    runs = 2  # benchmark_serving: a warm run, then the timed run
    a8 = 7 * L + 1  # K6 calls per forward of the W8A8 model: 7 linears a layer + lm_head
    expect = {
        "dequant_matmul": 2 * nb * (4 * L + 1),  # awq and gptq packed evals (fused sites)
        "cache_band_write": steps * L, "decode_attention": steps * L, "fused_mlp": 0,
        # raw, 3 fake-quant and 3 packed evals; two calibrations (gptq needs the Hessians)
        "flash_attention": 7 * nb * L + 2 * CALIB_BLOCKS * L,
        "w8a8_matmul": (nb + runs + steps) * a8, **NO_CODEBOOK,
    }
    res = saved["results"]
    ppl = {m: {"fake": res.get(m, {}).get("perplexity"),
               "packed": res.get(m, {}).get("packed_perplexity")} for m in methods}
    out = {"phase": "quant", "model": "TinyLlama-1.1B", "layers": L, "blocks": nb,
           "block_size": EVAL_BLOCK, "calibration": f"{CALIB_BLOCKS} x {CALIB_BLOCK}",
           "methods": QUANT_MCFG, "rc": rc, "wall_s": wall,
           "raw_perplexity": res.get("raw", {}).get("perplexity"), "perplexity": ppl,
           "model_size_mb": {m: res.get(m, {}).get("model_size_mb") for m in methods},
           "runtime_s": {k: v.get("runtime_seconds") for k, v in res.items()},
           "serving_tokens_per_s": res.get("serving", {}).get("tokens_per_second"),
           "errors": {k: v.get("error") or v.get("packed_error") for k, v in res.items()},
           "peak_mem_gib": peak_gib, "launches": counts, "expected_launches": expect,
           "routes": routes, "card": ctx["smi"]}
    emit(out)
    if rc != 0 or any(out["errors"].values()) or set(res) != {"raw", *methods, "serving"}:
        raise AssertionError(f"the benchmark run failed: {out['errors']}")
    for m, p in ppl.items():
        if not all(v is not None and math.isfinite(v) for v in p.values()):
            raise AssertionError(f"{m}: perplexities not finite: {p}")
        if abs(p["packed"] / p["fake"] - 1) >= 1e-2:
            raise AssertionError(f"{m}: packed perplexity not within 1% of fake-quant: {p}")
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != expected {expect}")
    if not res["serving"].get("tokens_per_second"):
        raise AssertionError("the serving pseudo-method measured nothing")
    # every K1 launch of the awq and gptq packed eval blocks (M 2048) and
    # every K6 launch of the smoothquant eval blocks and serving prefills
    # (M 1024) took the Hopper route
    _check_routes("quant", routes, k1=2 * nb * (4 * L + 1), k6=(nb + runs) * a8)
    _check_gemv("quant", counts, routes)
    ctx.setdefault("path_launches", {})["quant"] = {**counts, **routes}

    # warm blocks of the bench's packed artifacts, each timed on the host
    # around a synchronize, and a profiled one
    ids = load_fixture_test(str(FIXTURE_DIR))
    per_block, profiles = {}, {}
    for m in QUANT_MCFG:
        p, qm = artifacts.pop(m)
        evaluate_perplexity(p, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qm)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_perplexity(p, ids, cfg, n_samples=3, block_size=EVAL_BLOCK, qmeta=qm)
        torch.cuda.synchronize()
        per_block[m] = (time.perf_counter() - t0) / 3
        profiles[m] = _profiled(torch, lambda: evaluate_perplexity(
            p, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qm), 1, classify=_kind)
        del p, qm
    torch.cuda.empty_cache()
    emit({"phase": "quant_timing", "seconds": times, "s_per_packed_block": per_block,
          "profile_packed_block": profiles, "card": ctx["smi"]})

    # 2 layers at TinyLlama widths: calibrated and packed on the card, then
    # the same packed bytes evaluated on the card (kernels) and on the CPU
    # (plain versions), one fixture block
    cfg2 = cfg.replace(num_layers=2)
    p2 = llama.init_params(cfg2, seed=7, device="cuda")
    st2 = collect_calibration_stats(llama.forward, p2, _calib_blocks(cfg2, 2), cfg2,
                                    collect_hessian=True)
    ids2 = np.ascontiguousarray(ids[:, :EVAL_BLOCK])
    cmp = {}
    for m, mcfg in QUANT_MCFG.items():
        pk, qm = fuse_packed_sites(*fold_smooth(*pack_model(p2, m, mcfg, st2)))
        on_card = evaluate_perplexity(pk, ids2, cfg2, 1, EVAL_BLOCK, qmeta=qm)
        on_cpu = evaluate_perplexity(map_tree(pk, lambda t: t.cpu()), ids2, cfg2, 1, EVAL_BLOCK,
                                     qmeta=qm)
        cmp[m] = {"cpu": on_cpu, "card": on_card, "rel": abs(on_card / on_cpu - 1)}
    emit({"phase": "quant_e2e", "layers": 2, "block_size": EVAL_BLOCK, "perplexity": cmp,
          "tol_rel": 1e-2})
    if not all(c["rel"] < 1e-2 for c in cmp.values()):
        raise AssertionError(f"card and CPU packed perplexities differ: {cmp}")


SQ_A8 = QUANT_MCFG["smoothquant"]


def phase_serve_w8a8(torch, ctx):
    """The serving engine at full width on SmoothQuant W8A8: TinyLlama-1.1B
    (random weights from seed 0) calibrated on the fixture, packed with
    per-channel W8 and dynamic int8 activations (K6 on every linear),
    int8 KV, 8 requests of prompt 128 and 32 new tokens; launch counts per
    prefill call and decode step; a profile of one warm prefill and one
    16-step decode block; then the serve CLI's main() with --method
    smoothquant --a8 --kv int8."""
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fold_smooth, fuse_packed_sites, pack_model
    from qtpu_torch.serve.__main__ import main as serve_main
    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi, prefill
    from qtpu_torch.serve.kvcache import init_cache

    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    stats = collect_calibration_stats(llama.forward, params, _calib_blocks(cfg), cfg)
    params, qmeta = fuse_packed_sites(*fold_smooth(*pack_model(params, "smoothquant", SQ_A8,
                                                               stats)))
    del stats
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if any(len(m) != 5 for _, m in qmeta):
        raise AssertionError(f"not every site is W8A8: {qmeta}")
    B, P, new, L = SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.num_layers

    def make(graphs):
        return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                 kv_dtype="int8", seed=0, device="cuda", cuda_graphs=graphs)

    def expect_of(steps, pre):
        return {"dequant_matmul": 0, "cache_band_write": L * steps, "decode_attention": L * steps,
                "fused_mlp": 0, "flash_attention": 0, "w8a8_matmul": (7 * L + 1) * (steps + pre),
                **NO_CODEBOOK}

    def check(tag, counts, routes, steps, pre):
        # every K6 launch of a prefill (8 x 128 rows) took the Hopper route,
        # and every one of a decode step the tensor-core GEMV
        _check_routes(tag, routes, k6=(7 * L + 1) * pre)
        _check_gemv(tag, counts, routes)
        if routes["w8a8_matmul_gemv_tc"] != (7 * L + 1) * steps:
            raise AssertionError(f"{tag}: {routes['w8a8_matmul_gemv_tc']} K6 decode launches "
                                 f"on the tensor-core GEMV, not {(7 * L + 1) * steps}")

    runs = _serve_both(torch, ctx, "serve_w8a8", make, _serve_prompts(cfg, B), new, expect_of,
                       check, extra={"model": "TinyLlama-1.1B", "layers": L,
                                     "method": "smoothquant W8A8 alpha 0.5", "kv": "int8",
                                     "setup_s": setup_s})
    g = runs["graph"]
    ctx.setdefault("path_launches", {})["serve_w8a8"] = {**g["launches"], **g["routes"]}

    cache = init_cache(cfg, B, P + SERVE_NEW + 16, quantized=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    logits, cache = prefill(params, ids, cache, cfg, qmeta)  # warm
    pre_prof = _profiled(torch, lambda: prefill(params, ids, cache, cfg, qmeta), 1,
                         classify=_kind)
    emit({"phase": "profile_w8a8", "what": "prefill", "batch": B, "prompt": P, **pre_prof,
          "card": ctx["smi"]})
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta)  # warm
    n = 16
    dec = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                qmeta), n, classify=_kind)
    emit({"phase": "profile_w8a8", "what": "decode", "batch": B, "decode_steps": n, **dec,
          "card": ctx["smi"]})
    del cache, params
    torch.cuda.empty_cache()

    _reset_counts()
    rc = serve_main(["--method", "smoothquant", "--a8", "--kv", "int8"])
    cli = _counts()
    emit({"phase": "serve_w8a8_cli", "argv": "--method smoothquant --a8 --kv int8", "rc": rc,
          "launches": cli})
    if rc != 0 or cli["w8a8_matmul"] == 0 or cli["dequant_matmul"] != 0:
        raise AssertionError(f"the serve CLI run failed: rc {rc}, launches {cli}")


# POT's scale race on the 0.1 grid, as moe_methods runs it: 20 candidates
# where the 0.01 reference grid has 200 (its quantize and pack took 61 s of
# the smoke at 22 layers; NVIDIA H100 80GB HBM3, 700.00 W, and its host)
CODEBOOK_MCFG = {"pot": {"w_bit": 4, "q_group_size": 128, "grid_step": 0.1},
                 "apot": {"w_bit": 4, "q_group_size": 128, "k": 2}}
CB_PER_FORWARD = 4 * 22 + 1  # K7 calls per forward of the fused TinyLlama: 4 sites a layer + lm_head
# the pot_apot phase's depth (TinyLlama's full width): its 22 layers cut for
# the smoke's time (APOT's scale search goes a layer at a time: 31 s of
# quantize and pack at 22 layers)
POT_APOT_LAYERS = 4


@contextlib.contextmanager
def _bench_depth(runner, cfg):
    """The bench's "tinyllama-random" resolved to cfg (TinyLlama cut in
    depth) while a phase's bench runs in this process."""
    real = runner.get_model_config
    runner.get_model_config = lambda name: cfg if name == "tinyllama-random" else real(name)
    try:
        yield
    finally:
        runner.get_model_config = real


def _tinyllama_params_count(cfg) -> int:
    """Elements of TinyLlama's params, counted from its dimensions."""
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    Q, KV = cfg.q_dim, cfg.kv_dim
    return 2 * V * D + D + L * (2 * D + D * Q + 2 * D * KV + Q * D + 3 * D * F)


def phase_pot_apot(torch, ctx):
    """The POT/APOT path at full width through `python -m qtpu_torch.bench`
    (main() in this process): TinyLlama-1.1B (POT_APOT_LAYERS of its 22
    layers, random weights from seed 0), the fixture's 4 test blocks of
    2048, POT (0.1 grid) and
    APOT W4 g128 fake-quant and packed eval (K7 on every linear, K5 for the
    attention) and the serving pseudo-method on the POT artifact with the
    bf16 KV cache (K8). Checks perplexities, sizes and every launch count;
    each method's quantize and pack time, taken inside that run; a profiler
    split of one warm block of the run's packed artifacts, and pot/apot
    codes of a gate_proj on the card against the CPU."""
    import tempfile

    from qtpu_torch.bench import runner
    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.core.dtypes import MiB
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant import apot, pot
    from qtpu_torch.quant.apply import _parity_grid

    cfg = TINYLLAMA_1_1B.replace(num_layers=POT_APOT_LAYERS)
    fixture = f"fixture:{FIXTURE_DIR}"
    methods = list(CODEBOOK_MCFG)
    config = {
        "model_name": "tinyllama-random", "quantization_methods": methods,
        "calibration_dataset": fixture, "n_calibration_samples": CALIB_BLOCKS,
        "calibration_block_size": CALIB_BLOCK,
        "test_dataset": fixture, "n_test_samples": EVAL_BLOCKS, "test_block_size": EVAL_BLOCK,
        "quantization_config": CODEBOOK_MCFG, "packed_eval": True,
        "serving": {"benchmark": True, "kv_cache_dtype": "bfloat16", "max_batch_size": 8,
                    "pack_method": "pot"},
        "seed": 0, "device": "cuda", "verbose": True,
    }
    # each method's quantize and pack timed inside the bench, on the host
    # around a synchronize (its first of each), its packed artifacts kept
    times, artifacts = {}, {}
    real_quantize, real_packed = runner.quantize_model, runner.QuantizationBenchmark._packed

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times.setdefault(name, time.perf_counter() - t0)
        return r

    def quantize(params, method, *a, **kw):
        return timed(f"quantize_{method}", lambda: real_quantize(params, method, *a, **kw))

    def packed(bench, method, mcfg, stats=None):
        artifacts[method] = timed(f"pack_{method}", lambda: real_packed(bench, method, mcfg, stats))
        return artifacts[method]

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, out_path = Path(tmp) / "config.json", Path(tmp) / "results.json"
        cfg_path.write_text(json.dumps(config))
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runner.quantize_model, runner.QuantizationBenchmark._packed = quantize, packed
        t0 = time.perf_counter()
        try:
            with _bench_depth(runner, cfg):
                rc = bench_main([str(cfg_path), "--out", str(out_path)])
        finally:
            runner.quantize_model, runner.QuantizationBenchmark._packed = real_quantize, real_packed
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        saved = json.loads(out_path.read_text())

    L, nb = cfg.num_layers, EVAL_BLOCKS
    cb_fwd = 4 * L + 1  # K7 calls per forward of the fused model: 4 sites a layer + lm_head
    steps = runner.SERVE_WARM_STEPS + runner.SERVE_STEPS
    runs = 2  # benchmark_serving: a warm run, then the timed run
    routes = _route_counts()
    expect = {
        "dequant_matmul": 0, "cache_band_write": 0, "decode_attention": 0, "fused_mlp": 0,
        "flash_attention": 5 * nb * L,  # raw, 2 fake-quant and 2 packed evals
        "w8a8_matmul": 0,
        "codebook_matmul": (2 * nb + runs + steps) * cb_fwd,
        "decode_attention_write_bf16": steps * L, **NO_MOE,
    }
    res = saved["results"]
    ppl = {m: {"fake": res.get(m, {}).get("perplexity"),
               "packed": res.get(m, {}).get("packed_perplexity")} for m in methods}
    gap = {m: (p["packed"] / p["fake"] - 1) if p["packed"] and p["fake"] else None
           for m, p in ppl.items()}
    bits = 4 + 16 / 128  # reference size model without a zero point
    want_mb = _tinyllama_params_count(cfg) * bits / (8 * MiB)
    out = {"phase": "pot_apot", "model": "TinyLlama-1.1B", "layers": L, "blocks": nb,
           "block_size": EVAL_BLOCK, "methods": CODEBOOK_MCFG, "rc": rc, "wall_s": wall,
           "raw_perplexity": res.get("raw", {}).get("perplexity"), "perplexity": ppl,
           "packed_vs_fake": gap,
           "model_size_mb": {m: res.get(m, {}).get("model_size_mb") for m in methods},
           "expected_size_mb": want_mb,
           "bits_per_byte": {m: res.get(m, {}).get("bits_per_byte") for m in methods},
           "runtime_s": {k: v.get("runtime_seconds") for k, v in res.items()},
           "serving_tokens_per_s": res.get("serving", {}).get("tokens_per_second"),
           "errors": {k: v.get("error") or v.get("packed_error") for k, v in res.items()},
           "peak_mem_gib": peak_gib, "launches": counts, "expected_launches": expect,
           "routes": routes, "codebook_per_packed_block": cb_fwd, "card": ctx["smi"]}
    emit(out)
    if rc != 0 or any(out["errors"].values()) or set(res) != {"raw", *methods, "serving"}:
        raise AssertionError(f"the benchmark run failed: {out['errors']}")
    for m, p in ppl.items():
        if not all(v is not None and math.isfinite(v) for v in p.values()):
            raise AssertionError(f"{m}: perplexities not finite: {p}")
    # POT's packed codes are its fake-quant values; APOT packs 16 of fake's 32 levels
    if abs(gap["pot"]) >= 2e-2 or abs(gap["apot"]) >= 0.25:
        raise AssertionError(f"packed perplexity too far from fake-quant: {gap}")
    for m in methods:
        if (abs(out["model_size_mb"][m] / want_mb - 1) > 1e-9
                or out["bits_per_byte"][m] != bits / 2):  # bits per bf16 byte pair
            raise AssertionError(f"{m}: size {out['model_size_mb'][m]} MB, "
                                 f"{out['bits_per_byte'][m]} bits per byte != {want_mb}, {bits / 2}")
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != expected {expect}")
    if not res["serving"].get("tokens_per_second"):
        raise AssertionError("the serving pseudo-method measured nothing")
    # every K7 launch of the packed pot and apot eval blocks and of the
    # serving prefills took the Hopper route
    _check_routes("pot_apot", routes, k7=(2 * nb + runs) * cb_fwd)
    _check_gemv("pot_apot", counts, routes)
    ctx.setdefault("path_launches", {})["pot_apot"] = {**counts, **routes}

    # the bench's packed artifacts: warm eval blocks and a profiled one; the
    # POT artifact is kept for serve_bf16
    ids = load_fixture_test(str(FIXTURE_DIR))
    per_block, profiles = {}, {}
    for m in CODEBOOK_MCFG:
        p, qm = artifacts.pop(m)
        evaluate_perplexity(p, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qm)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_perplexity(p, ids, cfg, n_samples=3, block_size=EVAL_BLOCK, qmeta=qm)
        torch.cuda.synchronize()
        per_block[m] = (time.perf_counter() - t0) / 3
        profiles[m] = _profiled(torch, lambda: evaluate_perplexity(
            p, ids, cfg, n_samples=1, block_size=EVAL_BLOCK, qmeta=qm), 1, classify=_kind)
        del p
    emit({"phase": "pot_apot_timing", "seconds": times, "s_per_packed_block": per_block,
          "profile_packed_block": profiles, "card": ctx["smi"]})

    # one full-width site, layer 0's gate_proj [2048, 5632] of the bench's
    # model (seed 0), on the card and on the CPU: the scale race's decisions
    # are elementwise IEEE operations
    w = llama.init_params(cfg.replace(num_layers=1), seed=0, device="cuda")[
        "layers"]["gate_proj"]["w"][0]
    torch.cuda.empty_cache()
    K, N = w.shape
    site = {}
    for m in methods:
        gv = _parity_grid(CODEBOOK_MCFG[m], 0.01 if m == "pot" else 0.05,
                          None if m == "pot" else K * N)
        fn = (lambda x: pot.pot_quantize_codes(x, 4, 128, grid_values=gv)) if m == "pot" else \
            (lambda x: apot.apot_quantize_codes(x, 4, 128, grid_values=gv)[:2])
        t0 = time.perf_counter()
        c_card, s_card = fn(w)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_cpu, s_cpu = fn(w.cpu())
        t_cpu = time.perf_counter() - t0
        site[m] = {"codes_differing": int((c_card.cpu() != c_cpu).sum()),
                   "scales_differing": int((s_card.cpu() != s_cpu).sum()),
                   "codes": c_cpu.numel(), "scales": s_cpu.numel(),
                   "card_s": t_card, "cpu_s": t_cpu}
    emit({"phase": "pot_apot_card_vs_cpu", "site": "layer 0 gate_proj", "K": K, "N": N,
          "group": 128, "results": site, "tol": "at most 0.1% differing", "card": ctx["smi"]})
    for m, r in site.items():
        if r["codes_differing"] > 1e-3 * r["codes"] or r["scales_differing"] > 1e-3 * r["scales"]:
            raise AssertionError(f"{m}: card and CPU codes differ: {r}")


def phase_serve_bf16(torch, ctx):
    """The serving engine at full width on POT W4 g128 with fused sites
    and the bf16 KV cache: TinyLlama-1.1B (random weights from seed 0), 8
    requests of prompt 128 and 32 new tokens; launch counts per prefill
    call and decode step (K7 on every linear, K8 on every layer of a decode
    step, no K1-K4); a profile of one warm prefill and one 16-step decode
    block; then the serve CLI's main() with --method apot at its default
    bf16 cache."""
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.__main__ import main as serve_main
    from qtpu_torch.serve.batching import ContinuousBatcher
    from qtpu_torch.serve.decode import decode_multi, prefill
    from qtpu_torch.serve.kvcache import init_cache

    t0 = time.perf_counter()
    params, qmeta = fuse_packed_sites(*pack_model(llama.init_params(cfg, seed=0, device="cuda"),
                                                  "pot", CODEBOOK_MCFG["pot"]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    B, P, new, L = SERVE_B, SERVE_PROMPT, SERVE_NEW, cfg.num_layers

    def make(graphs):
        return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                 kv_dtype="bfloat16", seed=0, device="cuda", cuda_graphs=graphs)

    def expect_of(steps, pre):
        return {"dequant_matmul": 0, "cache_band_write": 0, "decode_attention": 0,
                "fused_mlp": 0, "flash_attention": 0, "w8a8_matmul": 0,
                "codebook_matmul": CB_PER_FORWARD * (steps + pre),
                "decode_attention_write_bf16": L * steps, **NO_MOE}

    def check(tag, counts, routes, steps, pre):
        # every prefill launch of K7 (89 a prefill of 8 x 128 rows) took the Hopper route
        _check_routes(tag, routes, k7=CB_PER_FORWARD * pre)
        _check_gemv(tag, counts, routes)

    runs = _serve_both(torch, ctx, "serve_bf16", make, _serve_prompts(cfg, B), new, expect_of,
                       check, extra={"model": "TinyLlama-1.1B", "layers": L,
                                     "method": "pot W4 g128", "kv": "bfloat16",
                                     "setup_s": setup_s})
    g = runs["graph"]
    ctx.setdefault("path_launches", {})["serve_bf16"] = {**g["launches"], **g["routes"]}

    cache = init_cache(cfg, B, P + SERVE_NEW + 16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    logits, cache = prefill(params, ids, cache, cfg, qmeta)  # warm
    pre_prof = _profiled(torch, lambda: prefill(params, ids, cache, cfg, qmeta), 1,
                         classify=_kind)
    emit({"phase": "profile_bf16", "what": "prefill", "batch": B, "prompt": P, **pre_prof,
          "card": ctx["smi"]})
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta)  # warm
    n = 16
    dec = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                qmeta), n, classify=_kind)
    emit({"phase": "profile_bf16", "what": "decode", "batch": B, "decode_steps": n, **dec,
          "card": ctx["smi"]})
    del cache, params
    torch.cuda.empty_cache()

    _reset_counts()
    rc = serve_main(["--method", "apot"])
    cli = _counts()
    emit({"phase": "serve_bf16_cli", "argv": "--method apot", "rc": rc, "launches": cli})
    if (rc != 0 or cli["codebook_matmul"] == 0 or cli["decode_attention_write_bf16"] == 0
            or cli["dequant_matmul"] != 0):
        raise AssertionError(f"the serve CLI run failed: rc {rc}, launches {cli}")


MOE_PER_STEP = {"dequant_matmul": 4 * MOE_LAYERS + 1, "moe": 3 * MOE_LAYERS,
                "attention": MOE_LAYERS}  # per forward of serve_moe's model


def _moe_engine(torch, ctx, params, qmeta, cfg, slots, requests):
    """ContinuousBatchers on the int8 cache with `slots` slots answering
    `requests` prompts of SERVE_PROMPT tokens with SERVE_NEW new tokens
    each, on CUDA graphs and eager (_serve_both); returns the graph run's
    line. Launches are counted from 0 just before each run."""
    import numpy as np

    from qtpu_torch.serve.batching import ContinuousBatcher

    P, new, L = SERVE_PROMPT, SERVE_NEW, MOE_LAYERS
    gathered = slots * cfg.num_experts_per_tok < cfg.num_experts

    def make(graphs):
        return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=slots, max_seq_len=P + new,
                                 kv_dtype="int8", seed=0, device="cuda", cuda_graphs=graphs)

    def expect_of(steps, pre):
        expect = {k: 0 for k in WRAPPERS}
        expect.update({
            "dequant_matmul": MOE_PER_STEP["dequant_matmul"] * (steps + pre),
            "moe_matmul": MOE_PER_STEP["moe"] * (pre if gathered else steps + pre),
            "moe_gathered_matmul": MOE_PER_STEP["moe"] * steps if gathered else 0,
            "decode_attention_write": L * steps,
        })
        return expect

    def check(tag, counts, routes, steps, pre):
        # every K1 and K9 launch of a prefill (128 rows a prompt) took the Hopper route
        _check_routes(tag, routes, k1=MOE_PER_STEP["dequant_matmul"] * pre,
                      k9=MOE_PER_STEP["moe"] * pre)
        # and every decode launch of K1, K9 and K10 the tensor-core GEMV: at 2
        # slots all 24 K10 launches of a step
        seen = _check_gemv(tag, counts, routes)
        if gathered and seen["moe_gathered_matmul"] != {"tc": MOE_PER_STEP["moe"] * steps,
                                                        "simt": 0}:
            raise AssertionError(f"{tag}: K10 launches {seen}")

    rng = np.random.default_rng(slots)
    prompts = [rng.integers(0, cfg.vocab_size, size=P, dtype=np.int32) for _ in range(requests)]
    runs = _serve_both(torch, ctx, "serve_moe", make, prompts, new, expect_of, check,
                       extra={"model": "Mixtral-8x7B", "layers": L, "method": "rtn W4 g128",
                              "kv": "int8", "slots": slots,
                              "route": "gathered" if gathered else "grouped"})
    return runs["graph"]


def phase_serve_moe(torch, ctx):
    """The sparse-MoE serving path at full width: Mixtral-8x7B with
    MOE_LAYERS of its 32 layers (random per-layer weights drawn on the card
    from seed 0), RTN W4 g128 (the router dense). An 8-slot engine on the
    int8 cache answers 8 requests of prompt 128 and 32 new tokens: per
    prefill call and decode step K1 4 L + 1 (q, k, v, o a layer and
    lm_head) and K9 3 L (gate, up, down a layer), K11 L per decode step. A
    2-slot engine answers 2 requests: K10 3 L a decode step, K9 only at
    prefill. Then a profile of one warm prefill
    of 8 prompts and of decode steps at 8 and at 2 slots, and the serve
    CLI's main() with
    --model tiny-moe-test --kv int8 --batch 1."""
    from qtpu_torch.models import moe
    from qtpu_torch.models.config import MIXTRAL_8X7B
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.serve.__main__ import main as serve_main
    from qtpu_torch.serve.decode import decode_multi, prefill
    from qtpu_torch.serve.kvcache import init_cache

    if "moe_route_flips" in ctx:  # from the Mixtral-width e2e
        emit({"phase": "serve_moe", "e2e_route_flips_per_layer": ctx["moe_route_flips"]})
    cfg = MIXTRAL_8X7B.replace(num_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": MOE_GROUP},
                               arch="moe")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    setup = {"init_s": init_s, "pack_s": pack_s,
             "setup_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "packed_gib": sum(t.numel() * t.element_size() for site in params["layers"].values()
                               if isinstance(site, dict) for t in site.values()) / 2**30}
    paths = ctx.setdefault("path_launches", {})
    emit({"phase": "serve_moe", "setup": setup, "card": ctx["smi"]})
    res = _moe_engine(torch, ctx, params, qmeta, cfg, SERVE_B, SERVE_B)
    paths["serve_moe"] = {**res["launches"], **res["routes"]}
    res2 = _moe_engine(torch, ctx, params, qmeta, cfg, 2, 2)
    paths["serve_moe_2slots"] = {**res2["launches"], **res2["routes"]}
    torch.cuda.empty_cache()

    # where a step's time goes: one warm prefill of 8 prompts, one decode step
    B, P = SERVE_B, SERVE_PROMPT
    cache = init_cache(cfg, B, P + SERVE_NEW + 16, quantized=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    logits, cache = prefill(params, ids, cache, cfg, qmeta, arch="moe")  # warm
    pre = _profiled(torch, lambda: prefill(params, ids, cache, cfg, qmeta, arch="moe"), 1,
                    classify=_kind)
    emit({"phase": "profile_moe", "what": "prefill", "batch": B, "prompt": P, **pre,
          "card": ctx["smi"]})
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta, arch="moe")  # warm
    n = 4
    dec = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                qmeta, arch="moe"), n, classify=_kind)
    emit({"phase": "profile_moe", "what": "decode", "batch": B, "decode_steps": n, **dec,
          "card": ctx["smi"]})
    del cache
    # the 2-slot step: decode on K10 (2 tokens x top-2 = 4 routed slots)
    cache = init_cache(cfg, 2, P + SERVE_NEW + 16, quantized=True, device="cuda")
    logits, cache = prefill(params, ids[:2], cache, cfg, qmeta, arch="moe")
    tok, pos = torch.argmax(logits, -1).to(torch.int32), pos[:2]
    decode_multi(params, tok, pos, cache, None, None, cfg, 4, qmeta, arch="moe")  # warm
    dec2 = _profiled(torch, lambda: decode_multi(params, tok, pos, cache, None, None, cfg, n,
                                                 qmeta, arch="moe"), n, classify=_kind)
    k10 = dec2["device_ms_by_kind"].get("K10 moe_gathered_matmul", 0.0)
    emit({"phase": "profile_moe", "what": "decode", "batch": 2, "decode_steps": n, **dec2,
          "k10_share_of_device": k10 / dec2["device_ms_per_step"], "card": ctx["smi"]})
    del cache, params
    torch.cuda.empty_cache()

    _reset_counts()
    rc = serve_main(["--model", "tiny-moe-test", "--kv", "int8", "--batch", "1"])
    cli = _counts()
    emit({"phase": "serve_moe_cli", "argv": "--model tiny-moe-test --kv int8 --batch 1",
          "rc": rc, "launches": cli})
    if (rc != 0 or cli["moe_gathered_matmul"] == 0 or cli["decode_attention_write"] == 0
            or cli["moe_matmul"] == 0):
        raise AssertionError(f"the serve CLI run failed: rc {rc}, launches {cli}")


CKPT_TEST_BLOCKS = 2  # the ckpt phase's bench: 2 test blocks of 2048
CKPT_MODEL_NAME = "TinyLlama-1.1B-local"  # no preset: the checkpoint's config.json rules


def _write_safetensors(path, tensors) -> int:
    """One safetensors file of bf16 CPU tensors: the 8-byte little-endian
    header length, the JSON header (padded to 8 bytes), the raw bytes.
    Returns the file's bytes."""
    import torch

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).numpy())
    return 8 + len(h) + off


def _write_hf_llama(torch, d, cfg, seed=0, device="cuda"):
    """A Hugging Face Llama checkpoint of cfg's shape in directory d:
    config.json under HF's LlamaConfig keys, bf16 random weights [out, in]
    (std 0.02; norms 1 + 0.1 N(0, 1)) drawn on `device` from a seeded
    torch.Generator, in two safetensors shards named by
    model.safetensors.index.json. Returns ({name: tensor on `device`},
    the files' bytes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    def norm(n):
        return (1 + 0.1 * torch.randn(n, generator=gen, device=device)).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": w(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": norm(D),
                  p + "post_attention_layernorm.weight": norm(D),
                  p + "self_attn.q_proj.weight": w(cfg.q_dim, D),
                  p + "self_attn.k_proj.weight": w(cfg.kv_dim, D),
                  p + "self_attn.v_proj.weight": w(cfg.kv_dim, D),
                  p + "self_attn.o_proj.weight": w(D, cfg.q_dim),
                  p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                  p + "mlp.down_proj.weight": w(D, F)})
    t["model.norm.weight"] = norm(D)
    t["lm_head.weight"] = w(V, D)
    names = list(t)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    nbytes = sum(_write_safetensors(d / f, {n: t[n].cpu() for n in ns})
                 for f, ns in shards.items())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": sum(x.numel() * 2 for x in t.values())},
         "weight_map": {n: f for f, ns in shards.items() for n in ns}}))
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": V,
        "hidden_size": D, "intermediate_size": F, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False,
        "hidden_act": "silu", "torch_dtype": "bfloat16"}))
    return t, nbytes


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def phase_ckpt(torch, ctx):
    """Real models in, packed artifacts out, at full width: (a) a
    TinyLlama-1.1B HF checkpoint written in two safetensors shards; (b)
    config_from_hf against the preset and load_checkpoint to the card
    against the written tensors, bit for bit; (c) `python -m
    qtpu_torch.bench` (main() in this process) on it with checkpoint_path,
    RTN W4 g128, packed_eval, 2 test blocks of 2048 from the fixture and
    save_artifacts, held to phase_eval's rules; (d) load_quantized to the
    card against pack_model of the same params in this process, bit for
    bit; (e) 8 requests of 128 + 32 greedy tokens on the int8 cache, on the
    loaded artifact and on the in-process packed params: the same tokens,
    the launches as the serve phase reckons them."""
    import dataclasses
    import tempfile

    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.ckpt import load_quantized, save_quantized
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.models.hf_import import config_from_hf, load_checkpoint
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.batching import ContinuousBatcher

    t_phase = time.perf_counter()
    L, nb = cfg.num_layers, CKPT_TEST_BLOCKS
    out = {"phase": "ckpt", "model": "TinyLlama-1.1B", "layers": L}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        hf_dir, art = tmp / "hf", tmp / "artifact"
        hf_dir.mkdir()
        # (a) the checkpoint
        t0 = time.perf_counter()
        written, ck_bytes = _write_hf_llama(torch, hf_dir, cfg)
        torch.cuda.synchronize()
        out["write_s"], out["checkpoint_bytes"] = time.perf_counter() - t0, ck_bytes

        # (b) its config and its import to the card, bit for bit
        # every field but those only the moe arch reads (norm_topk_prob's
        # default differs: qtpu's rule reads it as False off Mixtral)
        got_cfg = config_from_hf(str(hf_dir))
        moe_only = {"num_experts", "num_experts_per_tok", "norm_topk_prob",
                    "shared_expert_intermediate_size"}
        differ = [f.name for f in dataclasses.fields(cfg) if f.name not in moe_only
                  and getattr(got_cfg, f.name) != getattr(cfg, f.name)]
        out["config_fields_checked"] = len(dataclasses.fields(cfg)) - len(moe_only)
        if differ or got_cfg.num_experts != 0:
            raise AssertionError(f"config_from_hf {got_cfg} != the preset {cfg} on {differ}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, tokenizer = load_checkpoint(str(hf_dir), device="cuda")
        torch.cuda.synchronize()
        out["import_s"] = time.perf_counter() - t0
        out["import_gb_per_s"] = ck_bytes / out["import_s"] / 1e9
        lay = params["layers"]
        pairs = [(params["embed"], written["model.embed_tokens.weight"]),
                 (params["final_norm"], written["model.norm.weight"]),
                 (params["lm_head"]["w"], written["lm_head.weight"].T)]
        sites = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                 "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                 "down_proj": "mlp.down_proj"}
        for i in range(L):
            p = f"model.layers.{i}."
            pairs += [(lay["attn_norm"][i], written[p + "input_layernorm.weight"]),
                      (lay["mlp_norm"][i], written[p + "post_attention_layernorm.weight"])]
            pairs += [(lay[s]["w"][i], written[p + hf + ".weight"].T) for s, hf in sites.items()]
        n_leaves = len(_tree_leaves(params))
        bad = sum(not (a.is_cuda and _bits_equal(torch, a, b)) for a, b in pairs)
        out["import_bit_equal"] = {"tensors": len(pairs), "differ": bad, "leaves": n_leaves}
        if bad or tokenizer is not None or n_leaves != 3 + 2 + 7:
            raise AssertionError(f"the import differs from the written checkpoint: "
                                 f"{out['import_bit_equal']}, tokenizer {tokenizer}")
        del written, pairs
        torch.cuda.empty_cache()

        # (c) the benchmark on the checkpoint, saving its RTN artifact
        fixture = f"fixture:{FIXTURE_DIR}"
        config = {
            "model_name": CKPT_MODEL_NAME, "checkpoint_path": str(hf_dir),
            "quantization_methods": ["rtn"],
            "calibration_dataset": fixture, "n_calibration_samples": 4,
            "calibration_block_size": 512,
            "test_dataset": fixture, "n_test_samples": nb, "test_block_size": EVAL_BLOCK,
            "quantization_config": {"rtn": dict(EVAL_MCFG)}, "packed_eval": True,
            "save_artifacts": {"dir": str(art), "method": "rtn"},
            "seed": 0, "device": "cuda", "verbose": True,
        }
        cfg_path, res_path = tmp / "config.json", tmp / "results.json"
        cfg_path.write_text(json.dumps(config))
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = bench_main([str(cfg_path), "--out", str(res_path)])
        torch.cuda.synchronize()
        out["bench_s"] = time.perf_counter() - t0
        counts, routes = _counts(), _route_counts()
        res = json.loads(res_path.read_text())["results"]
        raw, rt = res.get("raw", {}), res.get("rtn", {})
        ppl = {"raw": raw.get("perplexity"), "rtn": rt.get("perplexity"),
               "packed": rt.get("packed_perplexity")}
        expect = {"dequant_matmul": (4 * L + 1) * nb, "cache_band_write": 0,
                  "decode_attention": 0, "fused_mlp": 0,
                  "flash_attention": 3 * nb * L,  # raw, fake-quant and packed evals
                  "w8a8_matmul": 0, **NO_CODEBOOK}
        out.update({"rc": rc, "perplexity": ppl, "model_size_mb": rt.get("model_size_mb"),
                    "bits_per_byte": rt.get("bits_per_byte"),
                    "runtime_s": {k: v.get("runtime_seconds") for k, v in res.items()},
                    "errors": {k: v.get("error") or v.get("packed_error")
                               for k, v in res.items()},
                    "launches": counts, "expected_launches": expect, "routes": routes})
        if rc != 0 or any(out["errors"].values()) or set(res) != {"raw", "rtn"}:
            raise AssertionError(f"the benchmark on the checkpoint failed: {out['errors']}")
        if not all(x is not None and math.isfinite(x) for x in ppl.values()):
            raise AssertionError(f"perplexities not finite: {ppl}")
        if abs(ppl["packed"] / ppl["rtn"] - 1) >= 1e-2:
            raise AssertionError(f"packed perplexity not within 1% of fake-quant: {ppl}")
        if round(out["model_size_mb"], 2) != 68.13 or round(out["bits_per_byte"], 3) != 2.078:
            raise AssertionError(f"size accounting {out['model_size_mb']} MB, "
                                 f"{out['bits_per_byte']} bits per byte != 68.13 / 2.078")
        if counts != expect:
            raise AssertionError(f"ckpt bench: kernel launches {counts} != expected {expect}")
        # every K1 launch of a packed eval block (M 2048) took the Hopper
        # route, every K5 launch its Hopper body
        _check_routes("ckpt bench", routes, k1=(4 * L + 1) * nb)
        _check_gemv("ckpt bench", counts, routes)
        ctx.setdefault("path_launches", {})["ckpt_bench"] = {**counts, **routes}

        # (d) the saved artifact (the run logs a failed save and carries on:
        # its files are the proof), loaded to the card, against pack_model of
        # the same params in this process
        if not ((art / "meta.json").is_file() and (art / "params.npz").is_file()):
            raise AssertionError(f"the benchmark saved no artifact in {art}")
        out["artifact_bytes"] = sum(f.stat().st_size for f in art.iterdir())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, qmeta_l, meta = load_quantized(art, device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        packed, qmeta = pack_model(params, "rtn", EVAL_MCFG)
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_quantized(tmp / "resaved", packed, qmeta, meta)
        out["save_s"] = time.perf_counter() - t0
        la, lb = _tree_leaves(loaded), _tree_leaves(packed)
        differ = sorted(k for k in lb if k not in la or not (
            la[k].is_cuda and _bits_equal(torch, la[k], lb[k])))
        out["artifact_bit_equal"] = {"leaves": len(lb), "differ": differ,
                                     "qmeta_equal": qmeta_l == qmeta, "meta": meta}
        if sorted(la) != sorted(lb) or differ or qmeta_l != qmeta or meta != {
                "method": "rtn", "model": CKPT_MODEL_NAME, **EVAL_MCFG}:
            raise AssertionError(f"the loaded artifact differs from pack_model in process: "
                                 f"{out['artifact_bit_equal']}")

    # (e) greedy serving on the loaded artifact and on the in-process params
    B, P, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    prompts = _serve_prompts(cfg, B)
    serve, outs = {}, {}
    for name, tree, qm in (("artifact", loaded, qmeta_l), ("in_process", packed, qmeta)):
        fp, fq = fuse_packed_sites(tree, qm)

        def make(graphs):
            return ContinuousBatcher(fp, cfg, qmeta=fq, max_batch=B, max_seq_len=P + new,
                                     kv_dtype="int8", seed=0, device="cuda", cuda_graphs=graphs)

        eng = make(True)
        warm_info = _warm_engine(torch, eng, f"ckpt {name}", "graph")
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes, m = _counts(), _route_counts(), eng.metrics()
        steps, pre = m["decode_steps"], m["prefill_calls"]
        expect = _serve_launches(L, steps, pre)
        serve[name] = {**warm_info, "wall_s": wall,
                       "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
                       "mean_ttft_s": m.get("mean_ttft_s"),
                       "decode_steps": steps, "prefill_calls": pre, "launches": counts}
        if counts != expect or steps == 0:
            raise AssertionError(f"ckpt serve {name}: kernel launches {counts} != {expect}")
        _check_serve_routes(f"ckpt serve {name}", counts, routes, L, pre)
        ctx["path_launches"][f"ckpt_serve_{name}"] = {**counts, **routes}
        outs[name] = [r.output for r in reqs]
        if any(len(o) != new for o in outs[name]):
            raise AssertionError(f"ckpt serve {name}: outputs {outs[name]}")
        if name == "artifact":  # the loaded artifact on an eager engine too
            serve[name]["prefill"] = _prefill_times(torch, eng, eng.prefill_shapes)
            del eng
            serve[name]["eager"] = _eager_twin(torch, "ckpt artifact", make(False), prompts, new,
                                               outs[name])
        else:
            del eng
        del fp
        torch.cuda.empty_cache()
    out["serve"] = serve
    out["greedy_tokens_equal"] = outs["artifact"] == outs["in_process"]
    out["seconds"] = time.perf_counter() - t_phase
    emit({**out, "card": ctx["smi"]})
    if not out["greedy_tokens_equal"]:
        raise AssertionError(f"ckpt: the artifact's greedy tokens differ from the in-process "
                             f"params': {outs}")


# depth of the methods' Mixtral-width model; the slow searches, GPTQ's
# column sweep (its exp_down_in Hessian alone is 8 x 14336^2 x 4 B = 6.58 GB
# a layer) and POT's and APOT's scale races, run on its first layer to keep
# the smoke within its time, and since the shard phase's uneven cuts awq and
# smoothquant too (they ran 2 layers before)
MOE_METHOD_LAYERS = {"awq": 1, "smoothquant": 1, "gptq": 1, "pot": 1, "apot": 1}
MOE_METHOD_MCFG = {
    "awq": {"w_bit": 4, "q_group_size": MOE_GROUP},
    "smoothquant": {"w_bit": 8, "q_group_size": MOE_GROUP, "alpha": 0.5, "act_quant": True},
    # actorder: the expert sites carry perms, so they run K1 one launch an expert
    "gptq": {"w_bit": 4, "q_group_size": MOE_GROUP, "error_compensation": True,
             "actorder": True},
    # POT's scale race on the 0.1 grid (APOT's own reference grid at these
    # sites' sizes), 20 candidates where the 0.01 reference grid has 200
    "pot": {"w_bit": 4, "q_group_size": MOE_GROUP, "grid_step": 0.1},
    "apot": {"w_bit": 4, "q_group_size": MOE_GROUP},
}
MOE_PPL_GATES = {"pot": 2e-2, "apot": 0.25}  # packed against fake-quant, as in eval / pot_apot
# the kernel of a method's attention sites and lm_head, and of its expert
# sites: K9 / K10 for the smoothed affine sites, else that kernel once an expert
MOE_METHOD_KERNEL = {"awq": "dequant_matmul", "gptq": "dequant_matmul",
                     "smoothquant": "w8a8_matmul", "pot": "codebook_matmul",
                     "apot": "codebook_matmul"}


def _moe_method_launches(method, L, E, steps, pre, gathered):
    """Launches of an engine on a MoE model packed by `method` over `steps`
    decode steps and `pre` prefill calls: per forward the method's kernel
    on q, k, v, o a layer and the lm_head; the expert sites K9 (grouped) or
    K10 (gathered, decode only) for AWQ, else that kernel 3E a layer; K11 a
    layer a decode step."""
    c = {k: 0 for k in WRAPPERS}
    kern, fwd = MOE_METHOD_KERNEL[method], steps + pre
    c[kern] = (4 * L + 1) * fwd
    if method == "awq":
        c["moe_matmul"] = 3 * L * (pre if gathered else fwd)
        c["moe_gathered_matmul"] = 3 * L * steps if gathered else 0
    else:
        c[kern] += 3 * E * L * fwd
    c["decode_attention_write"] = L * steps
    return c


def _write_hf_mixtral(torch, d, cfg, seed=0):
    """A Hugging Face Mixtral checkpoint of cfg's shape in directory d, one
    safetensors file: config.json under MixtralConfig's keys, bf16 random
    weights [out, in] (std 0.02; norms 1 + 0.1 N(0, 1)) drawn on the card
    from a seeded torch.Generator. Returns the file's bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, F, V, E = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_experts

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16).cpu()

    def norm(n):
        return (1 + 0.1 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16).cpu()

    t = {"model.embed_tokens.weight": w(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": norm(D),
                  p + "post_attention_layernorm.weight": norm(D),
                  p + "self_attn.q_proj.weight": w(cfg.q_dim, D),
                  p + "self_attn.k_proj.weight": w(cfg.kv_dim, D),
                  p + "self_attn.v_proj.weight": w(cfg.kv_dim, D),
                  p + "self_attn.o_proj.weight": w(D, cfg.q_dim),
                  p + "block_sparse_moe.gate.weight": w(E, D)})
        for e in range(E):
            q = p + f"block_sparse_moe.experts.{e}."
            t.update({q + "w1.weight": w(F, D), q + "w3.weight": w(F, D), q + "w2.weight": w(D, F)})
    t["model.norm.weight"] = norm(D)
    t["lm_head.weight"] = w(V, D)
    nbytes = _write_safetensors(d / "model.safetensors", t)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "vocab_size": V,
        "hidden_size": D, "intermediate_size": F, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "num_local_experts": E, "num_experts_per_tok": cfg.num_experts_per_tok,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False,
        "hidden_act": "silu", "torch_dtype": "bfloat16"}))
    return nbytes


def _moe_method_engines(torch, ctx, params, qmeta, cfg, method, tag):
    """8 requests of 128 + 32 on 8 slots (grouped route) and 2 on 2 slots
    (K10 where the sites allow: AWQ's) on the int8 cache, each on CUDA graphs
    and eager (_serve_both: greedy tokens equal, launches as
    _moe_method_launches reckons them); every prefill launch of the method's
    kernels on the Hopper route, every decode launch on a tensor-core GEMV.
    Returns {slots: the graph run's line}."""
    import numpy as np

    from qtpu_torch.serve.batching import ContinuousBatcher

    P, new, L, E = SERVE_PROMPT, SERVE_NEW, cfg.num_layers, cfg.num_experts
    kern = MOE_METHOD_KERNEL[method]
    per_fwd = 4 * L + 1 + (0 if method == "awq" else 3 * E * L)
    short = {"dequant_matmul": "k1", "codebook_matmul": "k7", "w8a8_matmul": "k6"}[kern]
    out = {}
    for slots in (SERVE_B, 2):
        gathered = method == "awq" and slots * cfg.num_experts_per_tok < E

        def make(graphs, slots=slots):
            return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=slots,
                                     max_seq_len=P + new, kv_dtype="int8", seed=0, device="cuda",
                                     cuda_graphs=graphs)

        def expect_of(steps, pre, gathered=gathered):
            return _moe_method_launches(method, L, E, steps, pre, gathered)

        def check(name, counts, routes, steps, pre, gathered=gathered):
            _check_routes(name, routes, **{short: per_fwd * pre},
                          k9=3 * L * pre if method == "awq" else 0)
            seen = _check_gemv(name, counts, routes)
            if gathered and seen["moe_gathered_matmul"] != {"tc": 3 * L * steps, "simt": 0}:
                raise AssertionError(f"{name}: K10 launches {seen}")

        rng = np.random.default_rng(slots)
        prompts = [rng.integers(0, cfg.vocab_size, size=P, dtype=np.int32) for _ in range(slots)]
        runs = _serve_both(torch, ctx, f"moe_methods_{tag}", make, prompts, new, expect_of, check,
                           extra={"model": "Mixtral-8x7B", "layers": L, "method": tag,
                                  "kv": "int8", "slots": slots,
                                  "route": "gathered" if gathered else "grouped"},
                           time_prefill=False)
        out[slots] = runs["graph"]
    return out


def _gptq_dense(torch, p, meta):
    """The dense [..., K, N] bf16 weight of a GPTQ-packed site (stacked
    [L] or [L, E] leading axes): its codes dequantized, the actorder perm's
    row order undone (linear gathers x by perm, so row i of the packed
    weight is row perm[i] of the dense one)."""
    from qtpu_torch.core.packing import dequantize_parts

    bits, group, K, N = meta[:4]
    lead = p["data"].shape[:-2]
    data = p["data"].reshape(-1, *p["data"].shape[-2:])
    scales = p["scales"].reshape(-1, *p["scales"].shape[-2:])
    zeros = p["zeros"].reshape(-1, *p["zeros"].shape[-2:])
    w = torch.stack([dequantize_parts(d, sc, z, bits, group)
                     for d, sc, z in zip(data, scales, zeros)])
    if "perm" in p:
        perm = p["perm"].reshape(-1, K).long()
        w = torch.zeros_like(w).scatter_(1, perm[:, :, None].expand(-1, -1, N), w)
    return w.reshape(*lead, K, N)


def phase_moe_methods(torch, ctx):
    """The MoE methods at Mixtral-8x7B's full width (4096 / 14336, E 8,
    top-2), its first layer (random per-layer weights from seed 0;
    MOE_METHOD_LAYERS): calibration on the
    fixture's 4 blocks of 512 (routed exp_down_in statistics; once more
    with the true Hessians for GPTQ), then for awq, smoothquant (W8A8), gptq
    (true Hessians, actorder), pot (the 0.1 grid) and apot:
    quantize (fake-quant; GPTQ: its packed codes dequantized, `_gptq_dense`,
    so its column sweep runs once) and pack, the perplexity of each on the eval
    phase's 4 fixture blocks of 2048 (packed within its gates of the
    fake-quant of the packed sites, the router dense in both: 1%, POT 2%,
    APOT 25%; the gap to the fake-quant that also quantizes the router
    printed), sizes against the reckoning of the
    same shapes on the CPU (meta tensors), and serving on 8 and 2 slots
    (_moe_method_engines: the expert
    sites on K9 / K10 for AWQ's smoothed affine sites, K1 with its perms
    for GPTQ's, K6 for W8A8, K7 for the codebooks); each method's seconds
    to calibrate, quantize and pack. Then `python -m qtpu_torch.bench`
    (main() in this process) on a 1-layer Mixtral-width HF checkpoint with
    checkpoint_path, awq and smoothquant W8A8, packed_eval, the serving
    pseudo-method and save_artifacts; the AWQ artifact loaded to the card
    and served on 2 slots (K10 on its smoothed sites), graphs against
    eager."""
    import tempfile

    import numpy as np

    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.ckpt import load_quantized
    from qtpu_torch.convert import map_tree
    from qtpu_torch.core.sizing import get_model_size
    from qtpu_torch.data.fixture import load_fixture_test
    from qtpu_torch.eval import evaluate_perplexity
    from qtpu_torch.models import moe
    from qtpu_torch.models.config import MIXTRAL_8X7B
    from qtpu_torch.quant.apply import pack_model, quantize_model
    from qtpu_torch.serve.batching import ContinuousBatcher

    t_phase = time.perf_counter()
    full = MIXTRAL_8X7B.replace(num_layers=max(MOE_METHOD_LAYERS.values()))
    E = full.num_experts
    torch.cuda.reset_peak_memory_stats()
    params_full = moe.init_params(full, seed=0, device="cuda")
    test_ids = load_fixture_test(str(FIXTURE_DIR))
    paths = ctx.setdefault("path_launches", {})
    secs, results, models = {}, {}, {}

    def model(L):
        """(params, cfg, calibration statistics, raw perplexity) of the
        first L layers (views of the full model's weights), made once."""
        if L not in models:
            cfg = full.replace(num_layers=L)
            params = dict(params_full, layers=map_tree(params_full["layers"], lambda t: t[:L]))
            st = timed(f"calibrate_L{L}", lambda: collect_calibration_stats(
                moe.forward, params, _calib_blocks(cfg), cfg))
            shape = tuple(st.mean_abs["exp_down_in"].shape)
            if shape != (CALIB_BLOCKS, L, E, cfg.intermediate_size):
                raise AssertionError(f"routed calibration statistics of shape {shape}")
            models[L] = (params, cfg, st, ppl(params, cfg))
        return models[L]

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    def ppl(p, cfg, qmeta=None):
        # the eval phase's 4 blocks of 2048 (its gates)
        return evaluate_perplexity(p, test_ids, cfg, n_samples=EVAL_BLOCKS,
                                   block_size=EVAL_BLOCK, qmeta=qmeta, arch="moe")

    for method, mcfg in MOE_METHOD_MCFG.items():
        params, cfg, stats, raw_ppl = model(MOE_METHOD_LAYERS[method])
        L = cfg.num_layers
        st = {"awq": stats, "smoothquant": stats}.get(method)
        if method == "gptq":  # the true Hessians, freed after its pack
            st = timed("gptq_calibrate_hessian", lambda: collect_calibration_stats(
                moe.forward, params, _calib_blocks(cfg), cfg, collect_hessian=True))
        fake_all_ppl = None
        if method != "gptq":
            fake = timed(f"{method}_quantize",
                         lambda: quantize_model(params, method, mcfg, st, "moe"))
            fake_all_ppl = ppl(fake, cfg)
            # the gate's reference: the fake-quant model of the sites the
            # artifact packs. pack_model keeps the router dense
            # (PACK_DENSE_SITES) where quantize_model quantizes it (both as
            # qtpu), and a router moved by quantization sends tokens to other
            # experts; with it dense the two models differ only by how the
            # packed sites are computed
            fake["layers"] = dict(fake["layers"], **{s: params["layers"][s]
                                                     for s in moe.PACK_DENSE_SITES
                                                     if s in params["layers"]})
            fake_ppl = ppl(fake, cfg)
            del fake
        packed, qmeta = timed(f"{method}_pack", lambda: pack_model(params, method, mcfg, st,
                                                                   "moe"))
        if method == "gptq":
            # GPTQ's column sweep runs once, in its pack (40 s a sweep here):
            # the reference is its codes dequantized, perms undone, in plain
            # math: on the true Hessians these are quantize_model's GPTQ
            # weights within one bf16 ulp (tests/test_torch_moe_methods.py,
            # test_gptq_packed_codes_dequantized_are_quantize_models_weights)
            fake = dict(params, layers=dict(params["layers"]))
            for site, p in packed["layers"].items():
                if isinstance(p, dict) and "data" in p:
                    fake["layers"][site] = {"w": _gptq_dense(torch, p, dict(qmeta)[site])}
            fake["lm_head"] = {"w": _gptq_dense(torch, packed["lm_head"],
                                                dict(qmeta)["lm_head"])}
            fake_ppl = ppl(fake, cfg)
            del fake
        if method == "gptq":
            del st
            torch.cuda.empty_cache()
        _reset_counts()
        packed_ppl = ppl(packed, cfg, qmeta)
        counts, routes = _counts(), _route_counts()
        zero = method not in ("pot", "apot")
        size = [get_model_size(t, data_width=mcfg["w_bit"], group_size=mcfg["q_group_size"],
                               use_zero_point=zero)
                for t in (params, moe.init_params(cfg, device="meta"))]
        gap = packed_ppl / fake_ppl - 1
        res = {"phase": "moe_methods", "model": "Mixtral-8x7B", "layers": L, "method": method,
               "mcfg": mcfg, "raw_ppl": raw_ppl, "fake_ppl": fake_ppl, "packed_ppl": packed_ppl,
               "packed_vs_fake": gap, "gate": MOE_PPL_GATES.get(method, 1e-2),
               "fake_ppl_router_quantized": fake_all_ppl,
               "packed_vs_fake_router_quantized": (None if fake_all_ppl is None
                                                   else packed_ppl / fake_all_ppl - 1),
               "model_size_bits": size[0], "reckoned_size_bits": size[1],
               "packed_bytes": sum(t.numel() * t.element_size()
                                   for t in _tree_leaves(packed).values()),
               "expert_leaves": {k: list(v.shape) for k, v in packed["layers"]["exp_down"].items()},
               "eval_launches": counts, "eval_routes": routes,
               "seconds": {k: v for k, v in secs.items() if k.startswith(method)},
               "card": ctx["smi"]}
        emit(res)
        if not all(math.isfinite(v) for v in (raw_ppl, fake_ppl, packed_ppl)):
            raise AssertionError(f"{method}: perplexities not finite: {res}")
        if abs(gap) >= res["gate"]:
            raise AssertionError(f"{method}: packed perplexity off fake-quant: {res}")
        if size[0] != size[1]:
            raise AssertionError(f"{method}: sizes differ from the reckoning: {res}")
        # the packed eval: a forward a block, K5 on each layer's attention
        want = _moe_method_launches(method, L, E, 0, EVAL_BLOCKS, False)
        want["flash_attention"] = L * EVAL_BLOCKS
        if counts != want:
            raise AssertionError(f"{method}: eval launches {counts} != {want}")
        engines = _moe_method_engines(torch, ctx, packed, qmeta, cfg, method, method)
        for slots, r in engines.items():
            paths[f"moe_methods_{method}_{slots}"] = {**r["launches"], **r["routes"]}
        results[method] = {"layers": L, "fake_ppl": fake_ppl, "packed_ppl": packed_ppl,
                           "fake_ppl_router_quantized": fake_all_ppl,
                           "tokens_per_s": {s: r["tokens_per_s"] for s, r in engines.items()}}
        del packed
        torch.cuda.empty_cache()
    del params_full, models
    torch.cuda.empty_cache()
    emit({"phase": "moe_methods_summary", "model": "Mixtral-8x7B", "results": results,
          "seconds": secs, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": ctx["smi"]})

    # the benchmark on a 1-layer Mixtral-width checkpoint, its artifact served
    bcfg = MIXTRAL_8X7B.replace(num_layers=1)
    fixture = f"fixture:{FIXTURE_DIR}"
    bench_methods = {m: MOE_METHOD_MCFG[m] for m in ("awq", "smoothquant")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        hf_dir, art = tmp / "hf", tmp / "artifact"
        hf_dir.mkdir()
        ck_bytes = _write_hf_mixtral(torch, hf_dir, bcfg)
        config = {
            "model_name": "Mixtral-8x7B-1-layer-local", "checkpoint_path": str(hf_dir),
            "quantization_methods": list(bench_methods),
            "calibration_dataset": fixture, "n_calibration_samples": CALIB_BLOCKS,
            "calibration_block_size": CALIB_BLOCK,
            "test_dataset": fixture, "n_test_samples": EVAL_BLOCKS,
            "test_block_size": EVAL_BLOCK, "quantization_config": bench_methods,
            "packed_eval": True,
            "serving": {"benchmark": True, "kv_cache_dtype": "int8", "max_batch_size": 2,
                        "pack_method": "awq"},
            "save_artifacts": {"dir": str(art), "method": "awq"},
            "seed": 0, "device": "cuda", "verbose": False,
        }
        cfg_path, out_path = tmp / "config.json", tmp / "results.json"
        cfg_path.write_text(json.dumps(config))
        t0 = time.perf_counter()
        rc = bench_main([str(cfg_path), "--out", str(out_path)])
        torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
        res = json.loads(out_path.read_text())["results"]
        errors = {k: v.get("error") or v.get("packed_error") for k, v in res.items()}
        packed, qmeta, art_meta = load_quantized(str(art), device="cuda")
        out = {"phase": "moe_methods_bench", "model": "Mixtral-8x7B 1 layer (checkpoint)",
               "checkpoint_bytes": ck_bytes, "rc": rc, "bench_s": bench_s,
               "perplexity": {m: {"fake": res.get(m, {}).get("perplexity"),
                                  "packed": res.get(m, {}).get("packed_perplexity")}
                              for m in bench_methods},
               "model_size_mb": {m: res.get(m, {}).get("model_size_mb") for m in bench_methods},
               "serving_tokens_per_s": res.get("serving", {}).get("tokens_per_second"),
               "errors": errors, "artifact_method": art_meta.get("method"),
               "artifact_files": sorted(f.name for f in art.iterdir()), "card": ctx["smi"]}
        if rc != 0 or any(errors.values()) or set(res) != {"raw", *bench_methods, "serving"}:
            raise AssertionError(f"the MoE benchmark failed: {out}")
        # the bench's fake-quant quantizes the router, its artifact keeps it
        # dense (qtpu's rule): the gap is printed, the gate held above
        for m, p in out["perplexity"].items():
            if not all(v is not None and math.isfinite(v) for v in p.values()):
                raise AssertionError(f"{m}: perplexities not finite: {out}")
            p["packed_vs_fake"] = p["packed"] / p["fake"] - 1
        emit(out)
        if dict(qmeta).get("exp_gate") != (4, MOE_GROUP, bcfg.hidden_size,
                                           bcfg.intermediate_size):
            raise AssertionError(f"the artifact's qmeta: {qmeta}")
        engines = {}
        for mode in ("graph", "eager"):
            eng = ContinuousBatcher(packed, bcfg, qmeta=qmeta, max_batch=2,
                                    max_seq_len=SERVE_PROMPT + SERVE_NEW, kv_dtype="int8",
                                    seed=0, device="cuda", cuda_graphs=mode == "graph")
            eng.warmup()
            rng = np.random.default_rng(2)
            reqs = [eng.submit(rng.integers(0, bcfg.vocab_size, size=SERVE_PROMPT,
                                            dtype=np.int32), max_new_tokens=SERVE_NEW)
                    for _ in range(2)]
            _reset_counts()
            eng.run()
            counts, m = _counts(), eng.metrics()
            want = _moe_method_launches("awq", 1, E, m["decode_steps"], m["prefill_calls"], True)
            engines[mode] = [r.output for r in reqs]
            if counts != want or not all(len(r.output) == SERVE_NEW for r in reqs):
                raise AssertionError(f"the loaded artifact's {mode} engine: launches {counts} "
                                     f"!= {want}")
            paths[f"moe_methods_artifact_{mode}"] = counts
            del eng
        emit({"phase": "moe_methods_artifact", "greedy_tokens_equal":
              engines["graph"] == engines["eager"], "card": ctx["smi"]})
        if engines["graph"] != engines["eager"]:
            raise AssertionError(f"the artifact's graph and eager tokens differ: {engines}")
        del packed
    torch.cuda.empty_cache()
    emit({"phase": "moe_methods_done", "seconds": time.perf_counter() - t_phase})


def phase_utils(torch, ctx):
    """qtpu_torch.utils on the card: the bench's eval under profile_dir
    (`python -m qtpu_torch.bench`'s main() in this process, tiny-test with
    RTN W4 g128 and packed_eval) writes a Chrome trace per eval, and the
    packed eval's names K1's and K5's kernels; Timer's host seconds against
    its own CUDA events and against a second pair of events recorded around
    it (~80 ms of warm matmuls), within 5%; checked() raising on a NaN made mid-function on the
    card (and not on a clean K1 call); debug_nans scoped."""
    import tempfile

    from qtpu_torch.bench.__main__ import main as bench_main
    from qtpu_torch.core.packing import quantize_pack
    from qtpu_torch.kernels.dequant_matmul import quantized_matmul
    from qtpu_torch.utils import debug, timing

    out = {"phase": "utils"}
    config = {"model_name": "tiny-test", "quantization_methods": ["rtn"],
              "calibration_dataset": "synthetic", "test_dataset": "synthetic",
              "n_calibration_samples": 2, "calibration_block_size": 256, "n_test_samples": 2,
              "test_block_size": 256, "quantization_config": {"rtn": {"w_bit": 4,
                                                                     "q_group_size": 128}},
              "packed_eval": True, "serving": {"benchmark": False}, "seed": 0,
              "device": "cuda", "verbose": False}
    with tempfile.TemporaryDirectory() as tmp:
        config["profile_dir"] = str(Path(tmp) / "prof")
        cfg_path = Path(tmp) / "config.json"
        cfg_path.write_text(json.dumps(config))
        t0 = time.perf_counter()
        rc = bench_main([str(cfg_path), "--out", str(Path(tmp) / "results.json")])
        out["bench_s"] = time.perf_counter() - t0
        traces = sorted(Path(config["profile_dir"]).glob("trace-*.json"),
                        key=lambda f: f.stat().st_mtime)
        out["traces"] = [f.stat().st_size for f in traces]
        names = {e.get("name", "") for e in json.loads(traces[-1].read_text())["traceEvents"]
                 if e.get("cat") == "kernel"} if traces else set()
    out["bench_rc"] = rc
    out["packed_trace_kernels"] = sorted({_kind(n) for n in names})
    k1 = any(_kind(n) == "K1 dequant_matmul" for n in names)
    k5 = any(_kind(n) == "K5 flash_attention" for n in names)

    a = torch.randn(4096, 4096, device="cuda")

    def work(a):
        for _ in range(30):  # ~80 ms of f32 matmuls on the card
            a = torch.tanh(a @ a * 1e-2)
        return a

    a = work(a)  # warm: kernels chosen, clocks up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    with timing.Timer(True) as t:  # fences on the current device, records its own events
        a = work(a)
    e1.record()
    torch.cuda.synchronize()
    ev = e0.elapsed_time(e1) / 1e3
    out["timer"] = {"host_s": t.elapsed, "timer_events_s": t.device_elapsed, "events_s": ev,
                    "vs_own_events": t.elapsed / t.device_elapsed - 1, "vs_events": t.elapsed / ev - 1}

    def inner_nan(x):
        return torch.nan_to_num(torch.sqrt(x - 1.0))  # NaN made where x < 1, none left after

    x = torch.rand(1024, device="cuda")
    try:
        debug.checked(inner_nan)(x)
        caught = False
    except FloatingPointError:
        caught = True
    g = torch.Generator(device="cuda").manual_seed(0)
    qt = quantize_pack(torch.randn(2048, 2560, generator=g, device="cuda") * 0.02, 4, 128)
    xb = torch.randn(8, 2048, generator=g, device="cuda").to(torch.bfloat16)
    y = debug.checked(quantized_matmul)(xb, qt.data, qt.scales, qt.zeros, (4, 128, 2048, 2560))
    with debug.debug_nans():
        with debug.debug_nans(False):
            torch.sqrt(x - 1.0)
        try:
            torch.sqrt(x - 1.0)
            scoped = False
        except FloatingPointError:
            scoped = True
    out.update(checked_caught_inner_nan=caught, inner_nan_output_finite=bool(
        torch.isfinite(inner_nan(x)).all()), checked_k1_clean=bool(torch.isfinite(y).all()),
        debug_nans_scoped=scoped, card=ctx["smi"])
    emit(out)
    if rc != 0 or len(traces) != 3 or not (k1 and k5):
        raise AssertionError(f"utils: the bench under profile_dir: rc {rc}, {len(traces)} traces, "
                             f"kernels {out['packed_trace_kernels']}")
    if max(abs(out["timer"]["vs_own_events"]), abs(out["timer"]["vs_events"])) >= 0.05:
        raise AssertionError(f"utils: Timer against CUDA events: {out['timer']}")
    if not (caught and out["inner_nan_output_finite"] and out["checked_k1_clean"] and scoped):
        raise AssertionError(f"utils: the finite checks: {out}")


def phase_synth(torch, ctx):
    """qtpu_torch.bench.synth and qtpu_torch.native on the card's machine.
    tiled_packed_llama(TinyLlama-1.1B) on the card (one random weight per
    site from a seeded generator, RTN W4 g128, fused on one layer and tiled
    over 22 as stride-0 views): the bytes it allocates against one layer's
    and 22 layers' reckoning, and the serve traffic (8 x (128 + 32), greedy,
    graph engines capturing at first use, so these tokens/s and TTFT carry
    the captures) on it and on a materialized copy (every layer's bytes its
    own), tokens equal. Then the native host packer: available(), its
    bytes at TinyLlama's site widths equal to qtpu_torch.core.packing's and
    its block_pack's to data.pipeline's, and its pack rates in GB/s."""
    import numpy as np

    from qtpu_torch import native
    from qtpu_torch.bench.synth import tiled_packed_llama
    from qtpu_torch.convert import map_tree
    from qtpu_torch.core import packing
    from qtpu_torch.data import pipeline
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.serve.batching import ContinuousBatcher

    D, F, V, Q, KV, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.q_dim,
                         cfg.kv_dim, cfg.num_layers)
    sites = {"qkv": (D, Q + 2 * KV), "o": (Q, D), "gateup": (D, 2 * F), "down": (F, D)}
    layer = sum(k * n // 2 + 3 * (k // 128) * n for k, n in sites.values()) + 4 * D
    outer = V * D * 2 + D * V // 2 + 3 * (D // 128) * V + 2 * D
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, qmeta = tiled_packed_llama(cfg)
    torch.cuda.synchronize()
    out = {"phase": "synth", "model": "TinyLlama-1.1B", "build_s": time.perf_counter() - t0,
           "allocated_bytes": torch.cuda.memory_allocated() - m0,
           "reckoned_bytes": {"one_layer": layer, "all_layers": L * layer, "embed_and_head": outer}}
    dense = map_tree(params, lambda t: t.contiguous())
    torch.cuda.synchronize()
    out["materialized_bytes"] = torch.cuda.memory_allocated() - m0 - out["allocated_bytes"]
    B, P, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    prompts = _serve_prompts(cfg, B, seed=2)
    toks = {}
    for name, tree in (("synth", params), ("materialized", dense)):
        # graphs captured at first use (the run's bucket and block): no warmup()
        eng = ContinuousBatcher(tree, cfg, qmeta=qmeta, max_batch=B, max_seq_len=P + new,
                                kv_dtype="int8", seed=0, device="cuda")
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks[name] = [r.output for r in reqs]
        out[name] = {"tokens_per_s": sum(len(o) for o in toks[name]) / wall,
                     "mean_ttft_s": eng.metrics().get("mean_ttft_s"),
                     "graphs": [sorted(eng.graphs), sorted(eng.prefill_graphs)]}
        del eng
    out["greedy_tokens_equal"] = toks["synth"] == toks["materialized"]
    del dense
    torch.cuda.empty_cache()

    # the native host packer at TinyLlama's site widths (unfused, as qtpu packs them)
    rng = np.random.default_rng(0)
    nat = {"available": native.available(), "build": native.build_info(), "sites": {}}
    for name, (K, N) in {"q": (D, Q), "k": (D, KV), "o": (Q, D), "gate": (D, F), "down": (F, D),
                         "lm_head": (D, V)}.items():
        w = (rng.standard_normal((K, N), dtype=np.float32) * 0.02)
        t0 = time.perf_counter()
        data, scales, zeros = native.quantize_pack(w, 4, 128)
        sec = time.perf_counter() - t0
        qt = packing.quantize_pack(torch.from_numpy(w), 4, 128)
        q = packing.unpack_int4(qt.data, 128).numpy()
        t1 = time.perf_counter()
        packed = native.pack_int4(q, 128)
        psec = time.perf_counter() - t1
        nat["sites"][name] = {
            "K": K, "N": N, "quantize_pack_gb_per_s": w.nbytes / sec / 1e9,
            "pack_int4_gb_per_s": q.nbytes / psec / 1e9,
            "bytes_equal": bool(np.array_equal(data, qt.data.numpy())
                                and np.array_equal(zeros, qt.zeros.numpy())
                                and torch.equal(torch.from_numpy(scales).bfloat16(), qt.scales)
                                and np.array_equal(packed, qt.data.numpy()))}
    samples = [rng.integers(0, V, size=n, dtype=np.int32) for n in (700, 2048, 5000, 300)]
    got, want = native.block_pack(samples, 2048), pipeline.block_pack(samples, 2048)
    nat["block_pack_equal"] = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    out["native"] = nat
    out["card"] = ctx["smi"]
    emit(out)
    if not out["greedy_tokens_equal"]:
        raise AssertionError(f"synth: tokens differ from the materialized copy's: {toks}")
    if out["allocated_bytes"] > layer + outer + (64 << 20) \
            or out["materialized_bytes"] < (L - 1) * layer:
        raise AssertionError(f"synth: {out['allocated_bytes']} bytes allocated "
                             f"({out['materialized_bytes']} materialized), reckoned "
                             f"{out['reckoned_bytes']}")
    if not (nat["available"] and nat["block_pack_equal"]
            and all(v["bytes_equal"] for v in nat["sites"].values())):
        raise AssertionError(f"synth: the native packer: {nat}")


# ---------------------------------------------------------------- sharding
# the shard phase's depths, cut to keep the smoke within its time since the
# uneven cuts joined it (before: 32 TP 2 steps, 8 TP 8 steps, ring and MoE
# EP at 8 and 2 layers; PERF.md section 4)
SHARD_STEPS = 8  # decode steps of the TP 2 serve runs
SHARD_EVAL_BLOCKS = 2
SHARD_SEQ = 8192  # the ring attention's sequence, split over seq 2
# the ring's depth: two bf16 runs of this random model drift apart with
# depth (the ring 0.029-0.031 from the K5 forward at all 22 layers); at this
# depth the ring is held to the K5 forward within SHARD_TOL
SHARD_RING_LAYERS = 4
SHARD_MOE_LAYERS = 1
SHARD_TP8_STEPS = 4  # decode steps of the TP 8 serve runs (8 ranks on the card)
# TP 8's group: down_proj's K 5632 / 8 = 704 rows is 11 groups of 64, 5.5 of 128
SHARD_TP8_GROUP = 64
SHARD_TOL = 3e-2  # logits of a sharded run against the one-rank run (relative)
SHARD_GAP = 5e-2  # greedy tokens differing where the top-2 gap is below this: near-ties
# a token differing where the gap is at or above this is a fault: twice 0.15,
# the largest difference of one logit between the TP 2 and one-rank runs
# (0.143, measured on the card at this depth and seed)
SHARD_FLIP_GAP = 0.3
# K1 sites of TinyLlama-1.1B at TP 2: (K, N) of one rank's shard
SHARD_K1_SITES = {"qkv": (2048, 1280), "o": (1024, 2048), "gateup": (2048, 5632),
                  "down": (2816, 2048), "lm_head": (2048, 16000)}
# K6's two modes at TinyLlama's TP 2 row-parallel W8A8 sites: (K, N) of a
# rank's shard, and the M of decode (1, 8), a TP 8 batch's and a prefill
SHARD_K6_SITES = {"o": (1024, 2048), "down": (2816, 2048)}
SHARD_K6_M = (1, 8, 32, 1024)
# the uneven TP runs: Qwen2-7B's widths (QWEN2_7B) at TP 8, cut to this
# depth; served on the serve prompt (SERVE_B x SERVE_PROMPT) and its raw
# forward on one eval block of EVAL_BLOCK tokens
SHARD_QWEN7_LAYERS = 2


def _shard_inputs(torch, cfg):
    """The shard phase's token ids, from seeds (the same in every process)."""
    from qtpu_torch.data.synthetic import synthetic_token_stream

    V = cfg.vocab_size
    g = torch.Generator().manual_seed(11)
    return {"prompt": torch.randint(0, V, (SERVE_B, SERVE_PROMPT), generator=g),
            "stream": synthetic_token_stream(V, SHARD_EVAL_BLOCKS * EVAL_BLOCK + 1, seed=12),
            "calib": [torch.randint(0, V, (1, CALIB_BLOCK), generator=g).numpy()
                      for _ in range(CALIB_BLOCKS)],
            "seq": torch.randint(0, V, (1, SHARD_SEQ), generator=g),
            "moe": {B: torch.randint(0, V, (B, 16), generator=g) for B in (8, 2)}}


def _shard_serve(torch, cfg, packed, qmeta, prompt, tp=None, feed=None, timed=False,
                 steps=SHARD_STEPS):
    """Prefill + `steps` (SHARD_STEPS) greedy decode steps (teacher-forced on `feed`,
    the one-rank run's tokens, when given) on the int8 cache. Returns the
    logits [B, steps + 1, V] on the host, the tokens, the launches and
    routes of the prefill and of the decode steps, and (timed) each decode
    step's device ms with the collectives' ms."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding import collectives as coll

    dev = prompt.device
    B, T = prompt.shape
    cache = init_cache(cfg, B, T + steps + 16, quantized=True, device=dev)
    _reset_counts()
    logits, cache = prefill(packed, prompt, cache, cfg, qmeta, tp=tp)
    torch.cuda.synchronize()
    out = {"prefill": {"counts": _counts(), "routes": _route_counts()}}
    outs, toks, steps_ms = [logits.float().cpu()], [], []
    pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    _reset_counts()
    coll.STATS.reset()
    coll.STATS.timing = timed
    for i in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[:, i].to(dev)
        toks.append(tok.cpu())
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, cache = decode_step(packed, tok, pos, cache, cfg, qmeta, tp=tp)
        e1.record()
        outs.append(logits.float().cpu())
        if timed:
            torch.cuda.synchronize()
            steps_ms.append(e0.elapsed_time(e1))
        pos = pos + 1
    torch.cuda.synchronize()
    coll.STATS.timing = False
    out["decode"] = {"counts": _counts(), "routes": _route_counts()}
    out["logits"] = torch.stack(outs, 1)
    out["tokens"] = torch.stack(toks, 1)
    out["step_ms"] = steps_ms
    out["collectives"] = coll.STATS.as_dict()
    return out


def _token_check(got_logits, ref_logits, ref_tokens):
    """Greedy tokens of a sharded run against the one-rank run's, by the
    one-rank top-2 gap: a token differing under SHARD_GAP is a near-tie,
    one differing at a gap of SHARD_GAP or more is counted
    (`differ_gap_over_5e-2`), one differing at SHARD_FLIP_GAP or more, a
    fixed bound past the two bf16 runs' measured noise, is a fault
    (`differ_clear`)."""
    got = got_logits[:, :-1].argmax(-1)
    top2 = ref_logits[:, :-1].topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    noise = (got_logits[:, :-1] - ref_logits[:, :-1]).abs().amax(-1)
    near = gap < SHARD_GAP
    differ = got != ref_tokens
    at = differ.nonzero().tolist()
    return {"tokens": int(differ.numel()), "differ": int(differ.sum()),
            "differ_near_tie": int((differ & near).sum()),
            "differ_gap_over_5e-2": int((differ & ~near).sum()),
            "differ_clear": int((differ & (gap >= SHARD_FLIP_GAP)).sum()),
            "near_ties": int(near.sum()),
            "differing": [{"row": r, "step": i, "gap": float(gap[r, i]),
                           "row_max_abs_diff": float(noise[r, i])} for r, i in at],
            "max_abs_diff": float(noise.max())}


def _shard_kernel_rows(torch, ctx):
    """The kernels at TinyLlama's TP 2 shard shapes (K1's five sites at M 8
    and 1024, K2 / K3 on 2 KV heads of G 8, K4 at F 2816 with and without
    the residual, K5 at H 16 / KV 2 / S 2048) and K9 / K10 on 4 of
    Mixtral-8x7B's experts (a rank's at EP 2): each against its plain
    version, with its time, the plain version's, the library call's and the
    bound from this run's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    dev = torch.device("cuda")
    rows = {}
    for name, (K, N) in SHARD_K1_SITES.items():
        for M in (SERVE_B, SERVE_B * SERVE_PROMPT):
            r = _k1_case(torch, ctx, gen, dev, M, K, N, 4, 128)
            rows[f"K1_{name}_M{M}"] = {k: r[k] for k in ("M", "K", "N", "route", "rel_err", "ms",
                                                          "plain_ms", "library_ms", "bound_ms",
                                                          "bound_by")}
    rows["K2_kv2"], rows["K3_kv2"] = _k23_rows(torch, gen, dev, SERVE_B, 2, 16, 64, 176, 22)
    for resid in (True, False):
        rows[f"K4_f2816{'' if resid else '_no_resid'}"] = _k4_row(torch, gen, dev, SERVE_B,
                                                                   2048, 2816, 22, resid)
    rows["K5_h16_kv2"] = _k5_row(torch, gen, dev, 1, 16, 2, 64, EVAL_BLOCK)
    moe = _k9_k10_rows(torch, gen, dev, 4, {"gate_up": (4096, 14336), "down": (14336, 4096)},
                       SERVE_B, [(1, 3, 0, 3)])  # 2 slots x top-2
    rows.update({k.replace("_gs4", "").replace("_", "_e4_", 1): v for k, v in moe.items()})
    rows.update(_k6_mode_rows(torch, gen, dev))
    for r in rows.values():
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["over_library"] = r["ms"] / r["library_ms"] if r.get("library_ms") else None
    return rows


def _k6_mode_rows(torch, gen, dev):
    """K6's two modes for a row-parallel W8A8 site under TP at TinyLlama's
    TP 2 shard shapes (SHARD_K6_SITES) and SHARD_K6_M: absmax out
    (w8a8_absmax) bit for bit the plain absmax; absmax in (a rank's int32
    sums) with the row's own absmax bit for bit its plain version
    (w8a8_matmul_plain with that absmax), on the route w8a8_matmul takes and
    on the earlier body (dp4a at M <= 8, mma.sync above), and rescaled by
    w8a8_epilogue bit for bit the usual mode and the epilogue's plain
    version; with a foreign absmax (the own one doubled) the sums bit for
    bit the plain version's and their rescale within K6's band of the
    plain rescale (max |err| / max |ref| and relative error < 2e-2). Times:
    each mode, its plain version, the usual mode (absmax in's "was") and the
    library call (absmax out: torch.linalg.vector_norm(ord=inf); absmax in:
    torch.matmul on the weight dequantized to bf16 beforehand, as K6's
    rows); bounds from the shapes (absmax out: x's bytes read and the f32
    row maxima written; absmax in: K6's)."""
    from qtpu_torch.core.packing import dequantize_parts, quantize_pack
    from qtpu_torch.kernels import int8_matmul as k6

    rows = {}
    for site, (K, N) in SHARD_K6_SITES.items():
        meta = (8, K, K, N)
        wbytes = K * N + 3 * N
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / wbytes)))
        qts = [quantize_pack(torch.randn(K, N, generator=gen, device=dev) * 0.02, 8, K)
               for _ in range(copies)]
        nlib = max(1, min(copies, math.ceil(2 * L2_BYTES / (K * N * 2))))
        w_bf = [dequantize_parts(qt.data, qt.scales, qt.zeros, 8, K) for qt in qts[:nlib]]
        q0 = qts[0]
        for M in SHARD_K6_M:
            xs = [(torch.randn(M, K, generator=gen, device=dev) * 2).to(torch.bfloat16)
                  for _ in range(max(1, min(64, math.ceil(2 * L2_BYTES / (M * K * 2)))))]
            x = xs[0]
            amax = k6.w8a8_absmax(x)
            plain_amax = k6.absmax_plain(x)
            route = k6.w8a8_route(M, N, (q0.data.data_ptr(), q0.scales.data_ptr()))
            if route == "gemv":
                route = k6.w8a8_gemv_route(M, K, N, (x.data_ptr(), q0.data.data_ptr()))
            earlier = k6.w8a8_matmul_dp4a if M <= 8 else k6.w8a8_matmul_mma
            args = (x, q0.data, q0.scales, q0.zeros, meta)
            usual = k6.w8a8_matmul(*args)
            total = k6.w8a8_matmul(*args, absmax=amax)
            total_body = earlier(*args, absmax=amax)
            total_plain = k6.w8a8_matmul_plain(*args, absmax=amax)
            rescaled = k6.w8a8_epilogue(total, amax, q0.scales)
            rescaled_plain = k6.w8a8_epilogue_plain(total, amax, q0.scales)
            foreign = amax * 2
            got_total = k6.w8a8_matmul(*args, absmax=foreign)
            want_total = k6.w8a8_matmul_plain(*args, absmax=foreign)
            got = k6.w8a8_epilogue(got_total, foreign, q0.scales)
            want = k6.w8a8_epilogue_plain(want_total, foreign, q0.scales)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            epi_err = float((rescaled.float() - rescaled_plain.float()).abs().max())
            out = {"M": M, "K": K, "N": N, "route": route,
                   "absmax_bits_equal_plain": _bits_equal(torch, amax, plain_amax),
                   "own_absmax_sums_equal_plain": bool(torch.equal(total, total_plain)),
                   "own_absmax_sums_equal_earlier_body": bool(torch.equal(total_body, total)),
                   "own_absmax_rescaled_bits_equal_usual": _bits_equal(torch, rescaled, usual),
                   "epilogue_max_abs_err": epi_err,
                   "foreign_sums_equal_plain": bool(torch.equal(got_total, want_total)),
                   "foreign_err_max_over_max_ref": float(diff.max() / (want.float().abs().max()
                                                                        + 1e-6)),
                   "foreign_rel_err": rel_err(torch, got, want),
                   "max_abs_err": float(diff.max()), "tol": 2e-2}
            if not (out["absmax_bits_equal_plain"] and out["own_absmax_sums_equal_plain"]
                    and out["own_absmax_sums_equal_earlier_body"]
                    and out["own_absmax_rescaled_bits_equal_usual"] and epi_err == 0.0
                    and out["foreign_sums_equal_plain"]
                    and out["foreign_err_max_over_max_ref"] < 2e-2
                    and out["foreign_rel_err"] < 2e-2 and torch.isfinite(got.float()).all()):
                raise AssertionError(f"K6's TP modes at {site} M {M}: {out}")
            xbytes = M * K * 2
            a_row = {"M": M, "K": K, "route": "absmax_out", "max_abs_err": 0.0}
            a_row["bound_ms"], a_row["bound_by"] = bound(xbytes + M * 4, M * K)
            a_row["ms"], _ = cuda_ms(torch, [lambda t=t: k6.w8a8_absmax(t) for t in xs], xbytes)
            a_row["plain_ms"], _ = cuda_ms(torch, [lambda t=t: k6.absmax_plain(t) for t in xs],
                                           xbytes)
            a_row["library_ms"], _ = cuda_ms(
                torch, [lambda t=t: torch.linalg.vector_norm(t, float("inf"), dim=-1)
                        for t in xs], xbytes)
            rows[f"K6_absmax_out_{site}_M{M}"] = a_row
            # absmax in as the TP path runs it: the rank's int32 sums
            i_row = {k: out[k] for k in out}
            i_row["bound_ms"], i_row["bound_by"] = bound(xbytes + wbytes + M * N * 4 + M * 4,
                                                         2 * M * K * N, INT8_OP_PER_S)
            i_row["ms"], _ = cuda_ms(
                torch, [lambda q=q: k6.w8a8_matmul(x, q.data, q.scales, q.zeros, meta,
                                                   absmax=amax) for q in qts],
                wbytes)
            i_row["plain_ms"], _ = cuda_ms(
                torch, [lambda q=q: k6.w8a8_matmul_plain(x, q.data, q.scales, q.zeros, meta,
                                                         absmax=amax) for q in qts], wbytes)
            i_row["was_ms"], _ = cuda_ms(
                torch, [lambda q=q: k6.w8a8_matmul(x, q.data, q.scales, q.zeros, meta)
                        for q in qts], wbytes)
            i_row["was"] = "the usual mode (x's own absmax, bf16 out) on the same bytes"
            i_row["library_ms"], _ = cuda_ms(
                torch, [lambda w=w: torch.matmul(x, w) for w in w_bf], K * N * 2)
            rows[f"K6_absmax_in_{site}_M{M}"] = i_row
            # the rescale of the group's summed int32 sums (K6's epilogue)
            tbytes = M * N * 4
            e_row = {"M": M, "N": N, "route": "epilogue", "max_abs_err": epi_err}
            e_row["bound_ms"], e_row["bound_by"] = bound(tbytes + M * 4 + N * 2 + M * N * 2,
                                                         2 * M * N, 67e12)
            e_row["ms"], _ = cuda_ms(torch, [lambda: k6.w8a8_epilogue(total, amax, q0.scales)],
                                     tbytes)
            e_row["plain_ms"], _ = cuda_ms(
                torch, [lambda: k6.w8a8_epilogue_plain(total, amax, q0.scales)], tbytes)
            e_row["library_ms"] = None
            rows[f"K6_epilogue_{site}_M{M}"] = e_row
            del xs
        del qts, w_bf
    return rows


def _k6_mode_kernel_rows(rows, L):
    """The kernels line's rows of K6's TP modes (absmax out, absmax in with
    its int32 sums, the epilogue) at the work of one TP 2 W8A8 decode step
    of a rank (M 8): L x (o_proj + down_proj)."""
    out = {}
    for mode, name in (("absmax_out", "w8a8_absmax"), ("absmax_in", "w8a8_matmul_absmax_in"),
                       ("epilogue", "w8a8_epilogue")):
        rs = [rows[f"K6_{mode}_{s}_M8"] for s in SHARD_K6_SITES]
        out[name] = {
            "route": "cuda", "source": "qtpu_torch/csrc/w8a8_matmul.cu",
            "replaces": "qtpu/kernels/pallas_int8_matmul.py:58",
            "max_abs_err": max(r["max_abs_err"] for k, r in rows.items()
                               if k.startswith(f"K6_{mode}_")),
            **{k: L * sum(r[k] for r in rs) for k in ("ms", "plain_ms", "bound_ms")},
            "library_ms": (None if rs[0]["library_ms"] is None
                           else L * sum(r["library_ms"] for r in rs)),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations"}
    return out


def _tinyllama_sq_w8a8(torch):
    """TinyLlama-1.1B, all 22 layers, random weights from seed 0, SmoothQuant
    W8A8 (act_quant, alpha 0.5) calibrated on the fixture's blocks, smooth
    vectors folded where a norm takes them (serve_w8a8's packing): every
    site W8A8, o_proj and down_proj keep their smooth vectors."""
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import fold_smooth, fuse_packed_sites, pack_model

    params = llama.init_params(cfg, seed=0, device="cuda")
    stats = collect_calibration_stats(llama.forward, params, _calib_blocks(cfg), cfg)
    packed = fuse_packed_sites(*fold_smooth(*pack_model(params, "smoothquant", SQ_A8, stats)))
    del params, stats
    torch.cuda.empty_cache()
    return packed


def _qwen_w4(torch, cfg, group):
    """(dense params, packed params, qmeta) of a Qwen2 model: random weights
    on the card from seed 0, RTN W4 at `group`, fused qkv / gateup sites."""
    from qtpu_torch.models import llama
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    dense = llama.init_params(cfg, seed=0, device="cuda")
    packed, qmeta = fuse_packed_sites(*pack_model(dense, "rtn",
                                                  {"w_bit": 4, "q_group_size": group}))
    return dense, packed, qmeta


def _uneven_models(torch):
    """The TP 2 world's uneven runs: name -> (cfg, packed params, qmeta):
    TinyLlama SmoothQuant W8A8 (row-parallel W8A8 sites) and Qwen2-0.5B W4
    g128 (14 heads split 7 + 7 cut o_proj's 7 groups: the gathered
    attention output; down_proj's 38 groups 19 + 19)."""
    from qtpu_torch.models.config import QWEN2_0_5B, TINYLLAMA_1_1B

    _, qp, qq = _qwen_w4(torch, QWEN2_0_5B, 128)
    torch.cuda.empty_cache()
    return {"tinyllama_w8a8": (TINYLLAMA_1_1B, *_tinyllama_sq_w8a8(torch)),
            "qwen2_0_5b_w4_g128": (QWEN2_0_5B, qp, qq)}


def _shard_uneven_refs(torch, inputs, d):
    """The one-rank runs the uneven worlds are held to (saved to
    d/ref_uneven.pt): the TP 2 world's models served (prefill + SHARD_STEPS
    steps) and evaluated (one block); Qwen2-7B's widths at
    SHARD_QWEN7_LAYERS layers, W4 g64 served (the SERVE_PROMPT-token
    prompt, SHARD_TP8_STEPS steps) and its raw forward on an eval block of
    EVAL_BLOCK tokens (its bf16 logits in d/qwen2_7b_raw_logits.pt, which
    only the TP 8 ranks read)."""
    from qtpu_torch.eval.perplexity import evaluate_perplexity
    from qtpu_torch.models.config import QWEN2_7B

    out, models, secs = {}, {}, {}
    t0 = time.perf_counter()
    built = _uneven_models(torch)
    secs["build_tp2_models"] = time.perf_counter() - t0
    for name, (cfg, packed, qmeta) in built.items():
        run = _shard_serve(torch, cfg, packed, qmeta, inputs["prompt"].cuda())
        ppl = evaluate_perplexity(packed, inputs["stream"], cfg, 1, EVAL_BLOCK, qmeta=qmeta)
        out[name] = {"logits": run["logits"], "tokens": run["tokens"], "ppl": ppl}
        models[name] = (cfg, _tree_to(packed, "cpu"), qmeta)
        del packed
        built[name] = None
        torch.cuda.empty_cache()
    # the packed models for the TP 2 ranks (calibrating and packing them
    # there again would cost each rank as much as it cost here)
    t0 = time.perf_counter()
    torch.save(models, f"{d}/uneven_tp2.pt")
    secs["save_tp2_models"] = time.perf_counter() - t0
    del models
    cfg7 = QWEN2_7B.replace(num_layers=SHARD_QWEN7_LAYERS)
    t0 = time.perf_counter()
    dense, packed, qmeta = _qwen_w4(torch, cfg7, 64)
    secs["build_qwen2_7b"] = time.perf_counter() - t0
    prompt = inputs["prompt"].cuda()
    run = _shard_serve(torch, cfg7, packed, qmeta, prompt, steps=SHARD_TP8_STEPS)
    from qtpu_torch.models import llama

    raw = llama.forward(dense, _qwen7_eval_ids(torch, inputs), cfg7)
    out["qwen2_7b"] = {"logits": run["logits"], "tokens": run["tokens"]}
    torch.save(raw[0].cpu(), f"{d}/qwen2_7b_raw_logits.pt")
    # the model for the TP 8 ranks, which shard it on the host and move only
    # their shards to the card (8 ranks packing it there run the card out of
    # memory)
    t0 = time.perf_counter()
    torch.save({"dense": _tree_to(dense, "cpu"), "packed": _tree_to(packed, "cpu"),
                "qmeta": qmeta}, f"{d}/qwen2_7b.pt")
    secs["save_qwen2_7b"] = time.perf_counter() - t0
    del dense, packed, raw
    torch.cuda.empty_cache()
    torch.save(out, f"{d}/ref_uneven.pt")
    return {**{k: {"ppl": v.get("ppl")} for k, v in out.items()}, "part_seconds": secs}


def _tree_to(tree, device):
    """A params tree (nested dicts, None leaves kept) on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _qwen7_eval_ids(torch, inputs):
    return torch.from_numpy(inputs["stream"][:, :EVAL_BLOCK]).long().cuda()


def _uneven_run(torch, name, local, tp, prompt, ref, steps):
    """One uneven TP run of a rank on its shard (shard_model's local params,
    qmeta and config: its heads, KV heads, MLP width and o_gather), served
    teacher-forced on the one-rank run's tokens: its logits and greedy
    tokens against that run's, its launches per decode step and its
    collectives."""
    lp, lq, lc = local
    run = _shard_serve(torch, lc, lp, lq, prompt, tp=tp, feed=ref["tokens"], timed=True,
                       steps=steps)
    return {"model": name, "q_heads": lc.num_heads, "kv_heads": lc.num_kv_heads,
            "mlp_width": lc.intermediate_size, "o_gather": list(lc.o_gather[1:]),
            "rel_err_per_step": [rel_err(torch, run["logits"][:, i], ref["logits"][:, i])
                                 for i in range(steps + 1)],
            "tokens": _token_check(run["logits"], ref["logits"][:, :steps + 1],
                                   ref["tokens"][:, :steps]),
            "prefill_counts": run["prefill"]["counts"],
            "prefill_routes": run["prefill"]["routes"],
            "decode_counts": run["decode"]["counts"], "decode_routes": run["decode"]["routes"],
            "step_ms": sum(run["step_ms"]) / steps,
            "collectives_per_step": {k: v / steps for k, v in run["collectives"].items()}}


def _shard_one_rank(torch, ctx, inputs, d):
    """(a) The TP code in a 1-rank NCCL world against the unsharded path, bit
    for bit; and the one-rank references the 2-rank worlds are held to
    (saved to d/ref.pt): the serve run, the eval's perplexity, the
    calibration statistics."""
    import torch.distributed as dist

    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.eval.perplexity import evaluate_perplexity
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.multihost import initialize_multihost

    packed, qmeta = _tinyllama_w4(torch, ctx)
    torch.save((_tree_to(packed, "cpu"), qmeta), f"{d}/tinyllama_w4.pt")  # for the 2 ranks
    prompt = inputs["prompt"].cuda()
    ref = _shard_serve(torch, cfg, packed, qmeta, prompt, timed=True)
    t0 = time.perf_counter()
    ppl = evaluate_perplexity(packed, inputs["stream"], cfg, SHARD_EVAL_BLOCKS, EVAL_BLOCK,
                              qmeta=qmeta)
    eval_s = time.perf_counter() - t0
    dense = llama.init_params(cfg, seed=0, device="cuda")
    stats = collect_calibration_stats(llama.forward, dense, inputs["calib"], cfg)
    del dense
    initialize_multihost(f"file://{d}/nccl_init", 1, 0, device="cuda")
    try:
        mesh = make_mesh(data=1, model=1)
        one = _shard_serve(torch, cfg, packed, qmeta, prompt, tp=local_group(mesh, "model"),
                           timed=True)
        ppl_one = evaluate_perplexity(packed, inputs["stream"], cfg, SHARD_EVAL_BLOCKS,
                                      EVAL_BLOCK, qmeta=qmeta, mesh=mesh)
    finally:
        dist.destroy_process_group()
    res = {"bit_equal_logits": bool(torch.equal(one["logits"], ref["logits"])),
           "bit_equal_tokens": bool(torch.equal(one["tokens"], ref["tokens"])),
           "ppl_unsharded": ppl, "ppl_nccl_1rank": ppl_one, "eval_s": eval_s,
           "step_ms_unsharded": sum(ref["step_ms"]) / SHARD_STEPS,
           "step_ms_nccl_1rank": sum(one["step_ms"]) / SHARD_STEPS,
           "collectives_nccl_1rank": one["collectives"]}
    if not (res["bit_equal_logits"] and res["bit_equal_tokens"] and ppl_one == ppl):
        raise AssertionError(f"shard: the 1-rank NCCL TP run is not bit-equal: {res}")
    torch.save({"logits": ref["logits"], "tokens": ref["tokens"], "ppl": ppl,
                "stats": {"mean_abs": {k: v.cpu() for k, v in stats.mean_abs.items()},
                          "max_abs": {k: v.cpu() for k, v in stats.max_abs.items()}}},
               f"{d}/ref.pt")
    return res


def _shard_child(rank, world, d):
    """(b) One rank of the 2-process gloo world sharing the card: TP 2
    serve and eval, DP 2 eval and calibration, pipe 2 eval, ring attention
    at seq 2, MoE EP 2. Writes d/rank<r>.json; the parent applies the gates."""
    import torch

    from qtpu_torch.calib.sharded import collect_calibration_stats_sharded
    from qtpu_torch.eval.perplexity import evaluate_perplexity
    from qtpu_torch.models import llama, moe, ops
    from qtpu_torch.models.config import MIXTRAL_8X7B
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding import collectives as coll
    from qtpu_torch.sharding.mesh import build_mesh, local_group, make_mesh
    from qtpu_torch.sharding.pipeline import make_pipe_mesh
    from qtpu_torch.sharding.ring_attention import seq_sharded_forward, seq_sharded_nll
    from qtpu_torch.sharding.specs import shard_model

    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _shard_inputs(torch, cfg)
    ref = torch.load(f"{d}/ref.pt")
    res = {"rank": rank}
    packed, qmeta = torch.load(f"{d}/tinyllama_w4.pt", map_location="cuda",
                               weights_only=False)
    a0 = ops.plain_attention.launches

    # TP 2 serve, teacher-forced on the one-rank run's tokens
    mesh = make_mesh(data=1, model=2)
    tp = local_group(mesh, "model")
    lp, lq, lc = shard_model(packed, qmeta, cfg, mesh)
    run = _shard_serve(torch, lc, lp, lq, inputs["prompt"].cuda(), tp=tp, feed=ref["tokens"],
                       timed=True)
    res["tp2_serve"] = {
        "rel_err_per_step": [rel_err(torch, run["logits"][:, i], ref["logits"][:, i])
                             for i in range(SHARD_STEPS + 1)],
        "tokens": _token_check(run["logits"], ref["logits"], ref["tokens"]),
        "prefill_counts": run["prefill"]["counts"], "prefill_routes": run["prefill"]["routes"],
        "decode_counts": run["decode"]["counts"], "decode_routes": run["decode"]["routes"],
        "step_ms": sum(run["step_ms"]) / SHARD_STEPS,
        "collectives_per_step": {k: v / SHARD_STEPS for k, v in run["collectives"].items()},
        "kv_heads_per_rank": lc.num_kv_heads}
    del lp, run

    def timed_eval(mesh_):
        coll.STATS.reset()
        coll.STATS.timing = True
        _reset_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ppl = evaluate_perplexity(packed, inputs["stream"], cfg, SHARD_EVAL_BLOCKS, EVAL_BLOCK,
                                  qmeta=qmeta, mesh=mesh_)
        e1.record()
        torch.cuda.synchronize()
        coll.STATS.timing = False
        return {"ppl": ppl, "rel_to_one_rank": ppl / ref["ppl"] - 1, "counts": _counts(),
                "routes": _route_counts(), "ms_per_block": e0.elapsed_time(e1) / SHARD_EVAL_BLOCKS,
                "collectives": coll.STATS.as_dict()}

    res["tp2_eval"] = timed_eval(mesh)
    res["dp2_eval"] = timed_eval(make_mesh(data=2, model=1))
    res["pipe2_eval"] = timed_eval(make_pipe_mesh(2))
    dense = llama.init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    st = collect_calibration_stats_sharded(llama.forward, dense, inputs["calib"], cfg,
                                           make_mesh(data=2, model=1))
    del dense
    diff = 0.0
    for kind in ("mean_abs", "max_abs"):
        for site, want in ref["stats"][kind].items():
            got = getattr(st, kind)[site].cpu()
            diff = max(diff, float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()))
    res["dp2_calib"] = {"max_rel_diff": diff, "seconds": time.perf_counter() - t0,
                        "rows": len(inputs["calib"])}
    del st

    # ring attention at seq 2 on the first SHARD_RING_LAYERS layers: the
    # rank's half of the logits and the NLL
    seq = build_mesh((2,), ("seq",))
    g = local_group(seq, "seq")
    ids = inputs["seq"].cuda()
    rcfg = cfg.replace(num_layers=SHARD_RING_LAYERS)
    rp = {**packed, "layers": {s: {k: None if v is None else v[:SHARD_RING_LAYERS]
                                    for k, v in p.items()} if isinstance(p, dict)
                               else p[:SHARD_RING_LAYERS] for s, p in packed["layers"].items()}}
    coll.STATS.reset()
    coll.STATS.timing = True
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    got = seq_sharded_forward(rp, ids, rcfg, g, qmeta=qmeta)
    e1.record()
    torch.cuda.synchronize()
    coll.STATS.timing = False
    nll = float(seq_sharded_nll(rp, ids, rcfg, g, qmeta=qmeta))
    Sl = SHARD_SEQ // 2
    # the one-rank forward through the same ring code (no group: one rank
    # holds the whole sequence): what splitting the sequence changes
    ring1 = seq_sharded_forward(rp, ids, rcfg, None, qmeta=qmeta)[:, rank * Sl:(rank + 1) * Sl]
    full = llama.forward(rp, ids, rcfg, qmeta=qmeta)  # the one-rank forward on K5
    want = full[:, rank * Sl:(rank + 1) * Sl]
    nll_one = float(torch.nn.functional.cross_entropy(full[0, :-1], ids[0, 1:]))
    res["seq2_ring"] = {"S": SHARD_SEQ, "layers": SHARD_RING_LAYERS,
                        "rel_err_vs_k5_forward": rel_err(torch, got, want),
                        "max_abs_err_vs_k5_forward": float((got - want).abs().max()),
                        "nll": nll, "nll_one_rank_k5": nll_one,
                        "nll_rel_diff": abs(nll / nll_one - 1), "ms": e0.elapsed_time(e1),
                        "rel_err_vs_one_rank_ring": rel_err(torch, got, ring1),
                        "collectives": coll.STATS.as_dict()}
    del got, full, want, packed, rp, ring1

    # MoE EP 2 at Mixtral-8x7B widths: a prefill and one decode step, the
    # EP run routed to the one-rank run's experts (a near-tied router may
    # flip under other sum orders: counted, unforced, in route_flips)
    mcfg = MIXTRAL_8X7B.replace(num_layers=SHARD_MOE_LAYERS)
    mp, mq = pack_model(moe.init_params(mcfg, seed=7, device="cuda"), "rtn",
                        {"w_bit": 4, "q_group_size": MOE_GROUP}, arch="moe")
    torch.cuda.empty_cache()
    lp, lq, lc = shard_model(mp, mq, mcfg, mesh)
    route = moe._route

    def moe_run(p, q, c, ids, tp_, log, forced=None):
        moe._route = _route_tap(moe, route, log, forced)
        try:
            B, T = ids.shape
            cache = init_cache(c, B, T + 16, quantized=True, device="cuda")
            logits, cache = prefill(p, ids, cache, c, q, arch="moe", tp=tp_)
            tok = torch.argmax(logits, -1).to(torch.int32)
            _reset_counts()
            logits, cache = decode_step(p, tok, torch.full((B,), T, dtype=torch.int32,
                                                           device="cuda"), cache, c, q,
                                        arch="moe", tp=tp_)
            torch.cuda.synchronize()
            return logits.float().cpu(), _counts(), _route_counts()
        finally:
            moe._route = route

    res["moe_ep2"] = {}
    for B, ids in inputs["moe"].items():
        ids = ids.cuda()
        one_log, ep_log, free_log = [], [], []
        want, _, _ = moe_run(mp, mq, mcfg, ids, None, one_log)
        got, counts, routes = moe_run(lp, lq, lc, ids, tp, ep_log,
                                      forced=[t for _, t in one_log])
        free, _, _ = moe_run(lp, lq, lc, ids, tp, free_log)
        res["moe_ep2"][B] = {
            "rel_err": rel_err(torch, got, want), "rel_err_unforced": rel_err(torch, free, want),
            "route_flips_unforced": _route_flips(one_log, free_log, SHARD_MOE_LAYERS),
            "route": "gathered" if B * mcfg.num_experts_per_tok < mcfg.num_experts else "grouped",
            "experts_per_rank": lp["layers"]["exp_gate"]["data"].shape[1],
            "decode_counts": counts, "decode_routes": routes}
    del mp, mq, lp, lq
    torch.cuda.empty_cache()

    # the uneven runs (TinyLlama W8A8, Qwen2-0.5B W4 g128): served and one
    # eval block, against the one-rank runs (d/ref_uneven.pt)
    uref = torch.load(f"{d}/ref_uneven.pt")
    res["uneven_tp2"] = {}
    models = torch.load(f"{d}/uneven_tp2.pt", map_location="cuda", weights_only=False)
    for name, (ucfg, packed, qmeta) in models.items():
        r = _uneven_run(torch, name, shard_model(packed, qmeta, ucfg, mesh), tp,
                        inputs["prompt"].cuda(), uref[name], SHARD_STEPS)
        _reset_counts()
        ppl = evaluate_perplexity(packed, inputs["stream"], ucfg, 1, EVAL_BLOCK, qmeta=qmeta,
                                  mesh=mesh)
        r["eval"] = {"ppl": ppl, "rel_to_one_rank": ppl / uref[name]["ppl"] - 1,
                     "counts": _counts(), "routes": _route_counts()}
        res["uneven_tp2"][name] = r
        del packed
        models[name] = None
        torch.cuda.empty_cache()
    res["plain_attention"] = ops.plain_attention.launches - a0
    res["staging"] = {"gloo_card_ops": sorted(coll.GLOO_CARD_OPS)}
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def _shard_tp8_child(rank, world, d):
    """One rank of an 8-process gloo world sharing the card: TinyLlama-1.1B
    W4 g64 (SHARD_TP8_GROUP) at TP 8, twice its 4 KV heads (each rank holds
    the KV head its 4 q heads read): prefill and SHARD_TP8_STEPS decode
    steps teacher-forced on the one-rank run's tokens (d/ref_tp8.pt).
    Writes d/tp8_rank<r>.json."""
    import torch

    from qtpu_torch.models import ops
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.specs import shard_model

    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _shard_inputs(torch, cfg)
    ref = torch.load(f"{d}/ref_tp8.pt")
    mesh = make_mesh(data=1, model=8)
    model = torch.load(f"{d}/tinyllama_w4_g64.pt", map_location="cpu", mmap=True,
                       weights_only=False)
    lp, lq, lc = shard_model(model["packed"], model["qmeta"], cfg, mesh)
    lp = _tree_to(lp, "cuda")
    del model
    torch.cuda.empty_cache()
    a0 = ops.plain_attention.launches
    n = SHARD_TP8_STEPS
    run = _shard_serve(torch, lc, lp, lq, inputs["prompt"].cuda(), tp=local_group(mesh, "model"),
                       feed=ref["tokens"], timed=True, steps=n)
    res = {"rank": rank, "kv_heads_per_rank": lc.num_kv_heads, "q_heads_per_rank": lc.num_heads,
           "rel_err_per_step": [rel_err(torch, run["logits"][:, i], ref["logits"][:, i])
                                for i in range(n + 1)],
           "tokens": _token_check(run["logits"], ref["logits"][:, :n + 1], ref["tokens"][:, :n]),
           "decode_counts": run["decode"]["counts"], "decode_routes": run["decode"]["routes"],
           "step_ms": sum(run["step_ms"]) / n,
           "collectives_per_step": {k: v / n for k, v in run["collectives"].items()}}
    del lp, run
    torch.cuda.empty_cache()

    # Qwen2-7B's widths at TP 8 (28 heads: 4 + 3 a KV group), W4 g64 served
    # and its raw forward on an eval block, against the one-rank runs
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import QWEN2_7B

    uref = torch.load(f"{d}/ref_uneven.pt")["qwen2_7b"]
    cfg7 = QWEN2_7B.replace(num_layers=SHARD_QWEN7_LAYERS)
    model = torch.load(f"{d}/qwen2_7b.pt", map_location="cpu", mmap=True, weights_only=False)
    lp, lq, lc = shard_model(model["packed"], model["qmeta"], cfg7, mesh)
    tp = local_group(mesh, "model")
    res["qwen2_7b"] = _uneven_run(torch, "qwen2_7b_w4_g64", (_tree_to(lp, "cuda"), lq, lc), tp,
                                  inputs["prompt"].cuda(), uref, n)
    ld, _, dc = shard_model(model["dense"], None, cfg7, mesh)
    ld = _tree_to(ld, "cuda")
    del model, lp
    torch.cuda.empty_cache()
    _reset_counts()
    raw = llama.forward(ld, _qwen7_eval_ids(torch, inputs), dc, tp=tp)
    torch.cuda.synchronize()
    want = torch.load(f"{d}/qwen2_7b_raw_logits.pt", mmap=True).cuda()
    res["qwen2_7b"]["raw_eval"] = {"tokens": EVAL_BLOCK, "counts": _counts(),
                                   "routes": _route_counts(),
                                   "rel_err": _rel_err_rows(torch, raw[0], want)}
    del raw, want
    res["plain_attention"] = ops.plain_attention.launches - a0
    with open(f"{d}/tp8_rank{rank}.json", "w") as f:
        json.dump(res, f)


def _uneven_tp2_fails(tag, runs, L):
    """The gates of a TP 2 rank's uneven runs: logits within SHARD_TOL of
    the one-rank run at every step, no token differing at a top-2 gap of
    SHARD_FLIP_GAP or more, the eval's perplexity within 1% of the one-rank
    run's, the launches a decode step reckons (W8A8: K6 7 L + 1, of which
    the 2 L row-parallel sites in the absmax-in mode (int32 sums) on the
    tensor-core GEMV, after as many absmax passes and before as many
    epilogues; Qwen2-0.5B: K1 2 L + 1 with o_proj's
    gathered input, K2-K4 L), every other decode launch on the tensor-core
    GEMV, every prefill and eval launch on the Hopper route."""
    fails = []
    for name, r in runs.items():
        t = f"{tag} {name}"
        if max(r["rel_err_per_step"]) >= SHARD_TOL:
            fails.append(f"{t} logits {max(r['rel_err_per_step'])}")
        if r["tokens"]["differ_clear"]:
            fails.append(f"{t} greedy tokens differ off near-ties: {r['tokens']}")
        if abs(r["eval"]["rel_to_one_rank"]) >= 1e-2:
            fails.append(f"{t} eval ppl {r['eval']}")
        a8 = name == "tinyllama_w8a8"
        Lm = L if a8 else 24  # Qwen2-0.5B's layers
        if a8:
            want = {"w8a8_matmul": 7 * L + 1, "w8a8_absmax": 2 * L,
                    "w8a8_matmul_absmax_in": 2 * L, "w8a8_matmul_absmax_in_gemv_tc": 2 * L,
                    "w8a8_epilogue": 2 * L, "cache_band_write": L, "decode_attention": L}
        else:
            want = {"dequant_matmul": 2 * Lm + 1, "cache_band_write": Lm,
                    "decode_attention": Lm, "fused_mlp": Lm}
        want = {k: v * SHARD_STEPS for k, v in want.items()}
        dc = {**r["decode_counts"], **r["decode_routes"]}
        if {k: dc[k] for k in want} != want:
            fails.append(f"{t} decode launches {({k: dc[k] for k in want})} != {want}")
        try:
            _check_gemv(f"shard {t} decode", r["decode_counts"], r["decode_routes"])
            n1, n6 = (0, 7 * L + 1) if a8 else (4 * Lm + 1, 0)
            _check_routes(f"shard {t} prefill", r["prefill_routes"], k1=n1, k6=n6)
            _check_routes(f"shard {t} eval", r["eval"]["routes"], k1=n1, k6=n6)
        except AssertionError as ex:
            fails.append(str(ex))
    return fails


def _qwen7_tp8_fails(tag, r, n):
    """The gates of a TP 8 rank's Qwen2-7B run: 4 or 3 q heads and one KV
    head, logits within SHARD_TOL of the one-rank run, tokens as TP 2's,
    K1 2 L + 1, K2-K4 L a step on the tensor-core GEMV, the raw eval block
    within SHARD_TOL with K5 L launches."""
    fails, t, L = [], f"{tag} qwen2_7b", SHARD_QWEN7_LAYERS
    if r["q_heads"] not in (3, 4) or r["kv_heads"] != 1:
        fails.append(f"{t} heads {r['q_heads']} / {r['kv_heads']}")
    if max(r["rel_err_per_step"]) >= SHARD_TOL:
        fails.append(f"{t} logits {max(r['rel_err_per_step'])}")
    if r["tokens"]["differ_clear"]:
        fails.append(f"{t} greedy tokens differ off near-ties: {r['tokens']}")
    dc = r["decode_counts"]
    want = {"dequant_matmul": (2 * L + 1) * n, "cache_band_write": L * n,
            "decode_attention": L * n, "fused_mlp": L * n}
    if {k: dc[k] for k in want} != want:
        fails.append(f"{t} decode launches {({k: dc[k] for k in want})} != {want}")
    try:
        _check_gemv(f"shard {t} decode", dc, r["decode_routes"])
    except AssertionError as ex:
        fails.append(str(ex))
    raw = r["raw_eval"]
    if raw["rel_err"] >= SHARD_TOL or raw["counts"]["flash_attention"] != L:
        fails.append(f"{t} raw eval {raw['rel_err']} K5 {raw['counts']['flash_attention']}")
    return fails


def phase_shard(torch, ctx):
    """Sharding on the card. (a) The TP code in a 1-rank NCCL world, bit for
    bit the unsharded path (serve and eval). (b) A 2-process gloo world
    sharing the card (NCCL refuses two ranks on one card; the collectives
    stage through host memory what gloo takes no card tensor for) at
    TinyLlama-1.1B's full width, RTN W4 g128 fused, int8 KV, random weights
    from seed 0: TP 2 serve (prefill 8 x 128, SHARD_STEPS decode steps,
    teacher-forced; launches per rank and step K1 45, K2-K4 22, every decode
    launch on the tensor-core GEMV), TP 2 eval (2 blocks of 2048, K5 22 a
    block on its Hopper body, K1 on the Hopper route), DP 2 eval and
    calibration, pipe 2 eval (11 layers a stage), ring attention at seq 2
    (S 8192, the first SHARD_RING_LAYERS layers) and MoE EP 2 (Mixtral-8x7B
    widths, 2 layers, 8 slots on K9 and 2 on K10), and the uneven cuts
    (`_uneven_models`: TinyLlama SmoothQuant W8A8, its row-parallel sites on
    K6's TP modes; Qwen2-0.5B W4 g128 with o_proj's gathered input), each
    served and one eval block; (c) an 8-process gloo world on the card:
    TinyLlama-1.1B W4 g64 at TP 8, twice its 4 KV heads (one KV head a
    rank), SHARD_TP8_STEPS decode steps against a one-rank run of the same
    model, and Qwen2-7B's widths (4 + 3 heads a KV group) at
    SHARD_QWEN7_LAYERS layers, served and its raw eval block; and the
    kernels at the shard shapes (K6's TP modes too), timed. Gates:
    logits within 3e-2 (relative) of the one-rank run (the ring's of the
    one-rank forward on K5 and of the one-rank forward through the ring code,
    its NLL within 1e-3 of K5's; MoE EP routed to the one-rank run's experts,
    and also unforced where no token routes otherwise); greedy tokens equal
    where the top-2 gap is SHARD_FLIP_GAP or more (the differences under 5e-2
    and over it counted and printed); TP perplexity within 1%, DP / pipe
    perplexity and DP statistics within 1e-5; no plain attention. Any
    difference between two bf16 runs of this random 22-layer model, the f32
    order of a sum included, grows to 2-3% of the logits (PERF.md section 6)."""
    import tempfile

    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.sharding.multihost import spawn

    L = cfg.num_layers
    inputs = _shard_inputs(torch, cfg)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        one = _shard_one_rank(torch, ctx, inputs, d)
        one["seconds"] = time.perf_counter() - t0
        emit({"phase": "shard_one_rank_nccl", "card": ctx["smi"], **one})
        t0 = time.perf_counter()
        uneven = _shard_uneven_refs(torch, inputs, d)
        emit({"phase": "shard_uneven_one_rank", "card": ctx["smi"],
              "seconds": time.perf_counter() - t0, **uneven})
        t0 = time.perf_counter()
        rows = _shard_kernel_rows(torch, ctx)
        emit({"phase": "shard_kernels", "card": ctx["smi"], "seconds": time.perf_counter() - t0,
              "rows": rows})
        ctx.setdefault("kernel_rows", {}).update(_k6_mode_kernel_rows(rows, L))
        t0 = time.perf_counter()
        spawn(_shard_child, 2, (d,), init_file=f"{d}/gloo_init", device="cuda",
              timeout_s=300)
        ranks = [json.load(open(f"{d}/rank{r}.json")) for r in range(2)]
        world_s = time.perf_counter() - t0
        for r in ranks:
            emit({"phase": "shard_rank", "card": ctx["smi"], "world_s": world_s, **r})
        t0 = time.perf_counter()
        packed64, qmeta64 = _tinyllama_w4(torch, {}, SHARD_TP8_GROUP)
        ref8 = _shard_serve(torch, cfg, packed64, qmeta64, inputs["prompt"].cuda(),
                            steps=SHARD_TP8_STEPS)
        torch.save({"logits": ref8["logits"], "tokens": ref8["tokens"]}, f"{d}/ref_tp8.pt")
        # the model for the 8 ranks, which shard it on the host (8 ranks
        # drawing and packing it on one card cost more than the file)
        torch.save({"packed": _tree_to(packed64, "cpu"), "qmeta": qmeta64},
                   f"{d}/tinyllama_w4_g64.pt")
        del packed64, qmeta64, ref8
        torch.cuda.empty_cache()
        spawn(_shard_tp8_child, 8, (d,), init_file=f"{d}/gloo8_init", device="cuda",
              timeout_s=300)
        tp8 = [json.load(open(f"{d}/tp8_rank{r}.json")) for r in range(8)]
        tp8_s = time.perf_counter() - t0
    fails = []
    for r in ranks:
        tag = f"rank {r['rank']}"
        s = r["tp2_serve"]
        if max(s["rel_err_per_step"]) >= SHARD_TOL:
            fails.append(f"{tag} tp2 serve logits {max(s['rel_err_per_step'])}")
        if s["tokens"]["differ_clear"]:
            fails.append(f"{tag} tp2 greedy tokens differ off near-ties: {s['tokens']}")
        dc = s["decode_counts"]
        want = {"dequant_matmul": 45 * SHARD_STEPS, "cache_band_write": L * SHARD_STEPS,
                "decode_attention": L * SHARD_STEPS, "fused_mlp": L * SHARD_STEPS}
        if {k: dc[k] for k in want} != want:
            fails.append(f"{tag} tp2 decode launches {({k: dc[k] for k in want})} != {want}")
        try:
            _check_gemv(f"shard {tag} tp2 decode", dc, s["decode_routes"])
            _check_routes(f"shard {tag} tp2 prefill", s["prefill_routes"], k1=4 * L + 1)
            e = r["tp2_eval"]
            _check_routes(f"shard {tag} tp2 eval", e["routes"],
                          k1=(4 * L + 1) * SHARD_EVAL_BLOCKS)
            _check_gemv(f"shard {tag} tp2 eval", e["counts"], e["routes"])
        except AssertionError as ex:
            fails.append(str(ex))
        if r["tp2_eval"]["counts"]["flash_attention"] != L * SHARD_EVAL_BLOCKS:
            fails.append(f"{tag} tp2 eval K5 launches {r['tp2_eval']['counts']}")
        if abs(r["tp2_eval"]["rel_to_one_rank"]) >= 1e-2:
            fails.append(f"{tag} tp2 eval ppl {r['tp2_eval']}")
        for key in ("dp2_eval", "pipe2_eval"):
            if abs(r[key]["rel_to_one_rank"]) >= 1e-5:
                fails.append(f"{tag} {key} ppl {r[key]['ppl']} vs one rank")
        if r["dp2_calib"]["max_rel_diff"] >= 1e-5:
            fails.append(f"{tag} dp2 calibration {r['dp2_calib']}")
        ring = r["seq2_ring"]
        if (ring["rel_err_vs_k5_forward"] >= SHARD_TOL
                or ring["rel_err_vs_one_rank_ring"] >= SHARD_TOL or ring["nll_rel_diff"] >= 1e-3):
            fails.append(f"{tag} ring {ring}")
        for B, m in r["moe_ep2"].items():
            if m["rel_err"] >= SHARD_TOL:
                fails.append(f"{tag} moe ep2 B {B}: {m['rel_err']}")
            if not any(m["route_flips_unforced"]) and m["rel_err_unforced"] >= SHARD_TOL:
                fails.append(f"{tag} moe ep2 B {B} unforced, routed alike: "
                             f"{m['rel_err_unforced']}")
            k = "moe_gathered_matmul" if m["route"] == "gathered" else "moe_matmul"
            if m["decode_counts"][k] != 3 * SHARD_MOE_LAYERS or m["experts_per_rank"] != 4:
                fails.append(f"{tag} moe ep2 B {B} launches {m['decode_counts']}")
        if r["plain_attention"]:
            fails.append(f"{tag} plain attention {r['plain_attention']}")
        fails += _uneven_tp2_fails(tag, r["uneven_tp2"], L)
    w8 = ranks[0]["uneven_tp2"]["tinyllama_w8a8"]["decode_routes"]
    ctx.setdefault("path_launches", {})["shard_w8a8"] = {
        k: w8[k] for k in ("w8a8_absmax", "w8a8_matmul_absmax_in", "w8a8_epilogue")}
    emit({"phase": "shard_tp8", "card": ctx["smi"], "world_s": tp8_s, "ranks": tp8})
    n = SHARD_TP8_STEPS
    for r in tp8:
        tag = f"tp8 rank {r['rank']}"
        if (r["kv_heads_per_rank"], r["q_heads_per_rank"]) != (1, 4):
            fails.append(f"{tag} heads a rank {r['q_heads_per_rank']} / {r['kv_heads_per_rank']}")
        if max(r["rel_err_per_step"]) >= SHARD_TOL:
            fails.append(f"{tag} logits {max(r['rel_err_per_step'])}")
        if r["tokens"]["differ_clear"]:
            fails.append(f"{tag} greedy tokens differ off near-ties: {r['tokens']}")
        dc = r["decode_counts"]
        want = {"dequant_matmul": 45 * n, "cache_band_write": L * n, "decode_attention": L * n,
                "fused_mlp": L * n}
        if {k: dc[k] for k in want} != want:
            fails.append(f"{tag} decode launches {({k: dc[k] for k in want})} != {want}")
        try:
            _check_gemv(f"shard {tag} decode", dc, r["decode_routes"])
        except AssertionError as ex:
            fails.append(str(ex))
        if r["plain_attention"]:
            fails.append(f"{tag} plain attention {r['plain_attention']}")
        fails += _qwen7_tp8_fails(tag, r["qwen2_7b"], n)
    ctx.setdefault("path_launches", {})["shard_tp8"] = {
        "decode_attention_kv1": tp8[0]["decode_counts"]["decode_attention"]}
    if fails:
        raise AssertionError("shard: " + "; ".join(fails))



# ---------------------------------------------------------------- extras
# the shapes qtpu_torch.bench.extra gives the kernels (bench_extra.py's
# measurements): each kernel there against its plain version in the kernels
# phase, its launches counted in the extras phase's run of that measurement
EXTRA_TOL = 3e-2  # logits of a kernels' run against the plain functions' run (relative)
EXTRA_PLAIN_LAYERS = 2  # the depth at which the first decode blocks are held to the plain run


def _k23_rows(torch, gen, dev, B, KV, H, hd, S, L):
    """K2 and K3 on a stacked int8 cache of L layers [B, KV, S, hd], B
    sequences at positions spread over [S - 48, S - 1], layers cycled: K2's
    codes and scales against its plain write (codes within 1, scales 1e-6),
    K3 within 2e-2 of its plain version; times of both, their plain
    versions, SDPA(enable_gqa) on the cache dequantized to bf16 for K3 and
    the bounds."""
    from qtpu_torch.kernels import kv_attention as k23
    from qtpu_torch.serve.kvcache import dequantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
          for _ in range(2)]
    sc = [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01 for _ in range(2)]
    pos = torch.tensor([S - 48 + (47 * i) // max(1, B - 1) for i in range(B)], dtype=torch.int32,
                       device=dev)
    kn, vn = (torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    a, b = [t.clone() for t in kc + sc], [t.clone() for t in kc + sc]
    k23.cache_band_write(kn, vn, *a, pos, 3)
    k23.cache_band_write_plain(kn, vn, *b, pos, 3)
    torch.cuda.synchronize()
    code = max(int((x.int() - y.int()).abs().max()) for x, y in zip(a[:2], b[:2]))
    scale = max(float((x - y).abs().max()) for x, y in zip(a[2:], b[2:]))
    del a, b
    row_bytes = B * KV * (2 * hd * 2 + 2 * hd + 2 * 4) + B * 4
    k2 = {"B": B, "KV": KV, "S": S, "hd": hd, "max_abs_err": float(code), "scale_err": scale}
    if code > 1 or scale > 1e-6:
        raise AssertionError(f"K2 disagrees with its plain write: {k2}")
    k2["bound_ms"], k2["bound_by"] = bound(row_bytes, 0)
    k2["ms"], _ = cuda_ms(torch, [lambda l=l: k23.cache_band_write(kn, vn, *kc, *sc, pos, l)
                                  for l in range(L)], row_bytes)
    k2["plain_ms"], _ = cuda_ms(torch, [lambda l=l: k23.cache_band_write_plain(kn, vn, *kc, *sc,
                                                                                pos, l)
                                        for l in range(L)], row_bytes, reps=L, graph=False)
    k2["library_ms"] = None
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    got = k23.decode_attention(q, *kc, *sc, pos, 3)
    want = k23.decode_attention_plain(q, *kc, *sc, pos, 3)
    torch.cuda.synchronize()
    rows_read = sum(int(p) + 1 for p in pos.tolist())
    att_bytes = rows_read * KV * (2 * hd + 2 * 4) + 2 * B * H * hd * 2 + B * 4
    k3 = {"B": B, "H": H, "KV": KV, "S": S, "hd": hd, "rel_err": rel_err(torch, got, want),
          "max_abs_err": float((got.float() - want.float()).abs().max())}
    if k3["rel_err"] >= 2e-2 or not torch.isfinite(got.float()).all():
        raise AssertionError(f"K3 disagrees with its plain version: {k3}")
    k3["bound_ms"], k3["bound_by"] = bound(att_bytes, rows_read * H * hd * 4)
    k3["ms"], _ = cuda_ms(torch, [lambda l=l: k23.decode_attention(q, *kc, *sc, pos, l)
                                  for l in range(L)], att_bytes)
    k3["plain_ms"], _ = cuda_ms(torch, [lambda l=l: k23.decode_attention_plain(q, *kc, *sc, pos, l)
                                        for l in range(L)], att_bytes)
    n = min(4, L)
    kd, vd = dequantize_kv(kc[0][:n], sc[0][:n]), dequantize_kv(kc[1][:n], sc[1][:n])
    mask = k23.cache_mask(pos[:, None], S)[:, None]
    k3["library_ms"], _ = cuda_ms(torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l],
                                                           attn_mask=mask, enable_gqa=True)
                                          for l in range(n)], att_bytes)
    return k2, k3


def _k4_row(torch, gen, dev, B, D, F, L, resid=True):
    """K4 (W4 g128, M = B) against its plain version (relative 3e-2), the
    body its route counters saw, times of the kernel and the plain version
    over enough layers to exceed the L2, and the bound."""
    from qtpu_torch.kernels import fused_mlp as k4

    g = 128
    mlp_w = (D * 2 * F + F * D) / 2 + (D // g) * 2 * F * 3 + (F // g) * D * 3
    n = max(2, min(L, math.ceil(2 * L2_BYTES / mlp_w)))
    gu = _packed(torch, n, D, 2 * F, 4, g, gen, dev)
    dn = _packed(torch, n, F, D, 4, g, gen, dev)
    nw = torch.ones(n, D, dtype=torch.bfloat16, device=dev)
    x = torch.randn(B, 1, D, generator=gen, device=dev).to(torch.bfloat16)
    metas = ((4, g, D, 2 * F), (4, g, F, D))

    def mlp(fn, l):
        return fn(x, nw[l], gu[0][l], gu[1][l], gu[2][l], dn[0][l], dn[1][l], dn[2][l], *metas,
                  resid=resid)

    t0 = k4.fused_mlp.gemv_tc_launches
    got = mlp(k4.fused_mlp, 0)
    r = {"M": B, "D": D, "F": F, "resid": resid,
         "route": "gemv_tc" if k4.fused_mlp.gemv_tc_launches > t0 else "gemv",
         "rel_err": rel_err(torch, got, mlp(k4.fused_mlp_plain, 0))}
    r["max_abs_err"] = float((got.float() - mlp(k4.fused_mlp_plain, 0).float()).abs().max())
    if r["rel_err"] >= 3e-2:
        raise AssertionError(f"K4 disagrees with its plain version: {r}")
    r["bound_ms"], r["bound_by"] = bound(mlp_w + 2 * B * D * (3 if resid else 2),
                                         2 * B * (D * 2 * F + F * D))
    r["ms"], _ = cuda_ms(torch, [lambda l=l: mlp(k4.fused_mlp, l) for l in range(n)], mlp_w)
    r["plain_ms"], _ = cuda_ms(torch, [lambda l=l: mlp(k4.fused_mlp_plain, l) for l in range(n)],
                               mlp_w)
    r["library_ms"] = None
    return r


def _k5_row(torch, gen, dev, B, H, KV, hd, S):
    """K5 (causal) against its plain version, held one KV group of heads at
    a time (the plain scores of all 32 heads at S 8192 are 8.6 GB of f32);
    its body (the Hopper one); times of the kernel, of the plain version
    over the groups, of SDPA and the bound."""
    from qtpu_torch.kernels import flash_attention as k5

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = (torch.randn(B, H, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    k = (torch.randn(B, KV, S, hd, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    G = H // KV
    w0 = k5.flash_attention.wgmma_launches
    got = k5.flash_attention(q, k, v, 0)
    route = "wgmma" if k5.flash_attention.wgmma_launches > w0 else "mma"

    def plain():
        return [k5.flash_attention_plain(q[:, j * G:(j + 1) * G], k[:, j:j + 1], v[:, j:j + 1], 0)
                for j in range(KV)]

    want = torch.cat(plain(), 1)
    torch.cuda.synchronize()
    r = {"B": B, "H": H, "KV": KV, "hd": hd, "S": S, "route": route,
         "rel_err": rel_err(torch, got, want),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "plain": "one KV group of heads a call"}
    del want
    if r["rel_err"] >= 2e-2 or route != "wgmma" or not torch.isfinite(got.float()).all():
        raise AssertionError(f"K5 at the extras' shape: {r}")
    io_bytes = 2 * B * (2 * H * S * hd + 2 * KV * S * hd)
    pairs = S * (S + 1) // 2
    r["bound_ms"], r["bound_by"] = bound(io_bytes, 4 * B * H * hd * pairs)
    r["ms"], _ = cuda_ms(torch, [lambda: k5.flash_attention(q, k, v, 0)], io_bytes)
    r["plain_ms"], _ = cuda_ms(torch, [plain], io_bytes, reps=2, graph=False)
    r["library_ms"], _ = cuda_ms(torch, [lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)],
                                 io_bytes)
    return r


def _k11_extra_row(torch, gen, dev, B, H, KV, hd, S, L):
    """K11 (write and attend on a stacked int8 cache) against its plain
    version: codes and scales written equal, output within 2e-2; times of
    the kernel, the plain version, SDPA on the dequantized cache, bound."""
    from qtpu_torch.kernels import kv_attention as k11
    from qtpu_torch.serve.kvcache import dequantize_kv

    cache = [torch.randint(-127, 128, (L, B, KV, S, hd), generator=gen, device=dev).to(torch.int8)
             for _ in range(2)]
    cache += [torch.rand(L, B, KV, S, generator=gen, device=dev) * 0.05 + 0.01 for _ in range(2)]
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn(B, 1, KV, hd, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor([S - 48 + (47 * i) // max(1, B - 1) for i in range(B)], dtype=torch.int32,
                       device=dev)
    kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
    got = k11.decode_attention_write(q, kn, vn, *kc, pos, 2)
    want = k11.decode_attention_write_plain(q, kn, vn, *pc, pos, 2)
    torch.cuda.synchronize()
    r = {"B": B, "H": H, "KV": KV, "S": S, "rel_err": rel_err(torch, got, want),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "cache_equal": all(bool(torch.equal(a, b)) for a, b in zip(kc, pc))}
    del kc, pc
    if not r["cache_equal"] or r["rel_err"] >= 2e-2:
        raise AssertionError(f"K11 disagrees with its plain version: {r}")
    rows_read = sum(int(p) + 1 for p in pos.tolist())
    nbytes = (rows_read * KV * (2 * hd + 2 * 4) + B * KV * (2 * hd * 2 + 2 * hd + 2 * 4)
              + 2 * B * H * hd * 2 + B * 4)
    r["bound_ms"], r["bound_by"] = bound(nbytes, rows_read * H * hd * 4)
    r["ms"], _ = cuda_ms(torch, [lambda l=l: k11.decode_attention_write(q, kn, vn, *cache, pos, l)
                                 for l in range(L)], nbytes)
    r["plain_ms"], _ = cuda_ms(
        torch, [lambda l=l: k11.decode_attention_write_plain(q, kn, vn, *cache, pos, l)
                for l in range(L)], nbytes, reps=L, graph=False)
    n = min(4, L)
    kd, vd = dequantize_kv(cache[0][:n], cache[2][:n]), dequantize_kv(cache[1][:n], cache[3][:n])
    mask = k11.cache_mask(pos[:, None], S)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r["library_ms"], _ = cuda_ms(torch, [lambda l=l: sdpa(q[:, :, None], kd[l], vd[l],
                                                          attn_mask=mask, enable_gqa=True)
                                         for l in range(n)], nbytes)
    return r


def _k12_s16k_row(torch, gen, dev):
    """K12's flash entry at the s16k measurement's layer (TinyLlama, B 4,
    per-layer cache of S 16384, every sequence at 16000 + 128 + the block):
    against its plain version (_k12_case), timed with the plain version and
    SDPA on the dequantized layer."""
    from qtpu_torch.kernels import kv_attention as k12
    from qtpu_torch.serve.kvcache import dequantize_kv

    S, B = 16384, 4
    pos = [16128 + 3 * i for i in range(B)]
    row, (cache, q, kn, vn, pos_t, entry) = _k12_case(torch, gen, dev, B, 4, 8, 64, S, pos, 0)
    one = [t[0] for t in cache]
    row["ms"], _ = cuda_ms(torch, [lambda: entry(q, kn, vn, *one, pos_t)], row["bytes"], reps=20)
    row["plain_ms"], _ = cuda_ms(torch, [lambda: k12.flash_decode_plain(q, kn, vn, *one, pos_t)],
                                 row["bytes"], reps=3, graph=False)
    kd, vd = dequantize_kv(one[0], one[2]), dequantize_kv(one[1], one[3])
    mask = (torch.arange(S, device=dev)[None, :] < pos_t[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"], _ = cuda_ms(
        torch, [lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True)],
        row["bytes"], reps=20)
    return row


def _k9_k10_rows(torch, gen, dev, E, sites, M9, eidx):
    """K9 (grouped, M9 rows on every expert) and K10 (gathered, the slots of
    eidx) at each (K, N) expert site of `sites` against their plain
    versions (relative 2e-2); times of both, their plain versions,
    torch.bmm on the bf16 experts (K10: the routed experts gathered), and
    the bounds (K10 from the distinct routed experts)."""
    from qtpu_torch.kernels import moe_matmul as k9

    rows = {}
    for name, (K, N) in sites.items():
        site = _expert_site(torch, gen, dev, E, K, N)
        meta = (4, MOE_GROUP, K, N)
        wd = _dequant_experts(torch, site)
        wbytes = E * (K * N / 2 + (K // MOE_GROUP) * N * 3)
        xm = torch.randn(M9, K, generator=gen, device=dev).to(torch.bfloat16)
        got = k9.moe_matmul(xm, *site, meta)
        want = k9.moe_matmul_plain(xm, *site, meta)
        r = {"E": E, "M": M9, "K": K, "N": N, "rel_err": rel_err(torch, got, want),
             "max_abs_err": float((got.float() - want.float()).abs().max())}
        r["bound_ms"], r["bound_by"] = bound(wbytes + M9 * K * 2 + E * M9 * N * 2,
                                             2 * E * M9 * K * N)
        r["ms"], _ = cuda_ms(torch, [lambda: k9.moe_matmul(xm, *site, meta)], wbytes)
        r["plain_ms"], _ = cuda_ms(torch, [lambda: k9.moe_matmul_plain(xm, *site, meta)], wbytes)
        r["library_ms"], _ = cuda_ms(torch, [lambda: torch.bmm(xm.expand(E, M9, K), wd)],
                                     wd.numel() * 2)
        rows[f"K9_{name}"] = r
        for slots in eidx:
            ei = torch.tensor(slots, dtype=torch.int32, device=dev)
            Gs, distinct = len(slots), len(set(slots))
            xg = torch.randn(Gs, K, generator=gen, device=dev).to(torch.bfloat16)
            t0 = k9.moe_gathered_matmul.gemv_tc_launches
            got = k9.moe_gathered_matmul(xg, ei, *site, meta)
            want = k9.moe_gathered_matmul_plain(xg, ei, *site, meta)
            r = {"E": E, "Gs": Gs, "K": K, "N": N, "rel_err": rel_err(torch, got, want),
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "route": "gemv_tc" if k9.moe_gathered_matmul.gemv_tc_launches > t0 else "gemv"}
            gbytes = distinct * (K * N / 2 + (K // MOE_GROUP) * N * 3)
            r["bound_ms"], r["bound_by"] = bound(gbytes + Gs * (K + N) * 2 + Gs * 4,
                                                 2 * Gs * K * N)
            r["ms"], _ = cuda_ms(torch, [lambda: k9.moe_gathered_matmul(xg, ei, *site, meta)],
                                 gbytes)
            r["plain_ms"], _ = cuda_ms(
                torch, [lambda: k9.moe_gathered_matmul_plain(xg, ei, *site, meta)], gbytes,
                reps=8, graph=False)
            wsel = wd[ei.long()]
            r["library_ms"], _ = cuda_ms(torch, [lambda: torch.bmm(xg[:, None], wsel)],
                                         wsel.numel() * 2)
            rows[f"K10_{name}_gs{Gs}"] = r
            del wsel
        for key in [k for k in rows if name in k]:
            if rows[key]["rel_err"] >= 2e-2:
                raise AssertionError(f"{key} disagrees with its plain version: {rows[key]}")
        del site, wd
    return rows


def _k1_sum(rows, sites, L, key):
    """The work of one step or block of K1 at those sites: L x the layer's
    sites + lm_head."""
    return L * sum(rows[s][key] for s in sites if s != "lm_head") + rows["lm_head"][key]


# (row of the kernels line, wrapper counter, extras measurement that runs it)
EXTRA_ROWS = {
    "dequant_matmul_llama2_7b": ("dequant_matmul", "llama2_7b_w4_decode_tokens_per_s"),
    "dequant_matmul_m32": ("dequant_matmul", "tinyllama_w4_decode_tokens_per_s_b32"),
    "dequant_matmul_m8192": ("dequant_matmul", "tinyllama_w4_prefill_tokens_per_s_s8192"),
    "dequant_matmul_w8": ("dequant_matmul", "tinyllama_w8_decode_tokens_per_s_staged"),
    "cache_band_write_b32": ("cache_band_write", "tinyllama_w4_decode_tokens_per_s_b32"),
    "cache_band_write_llama2_7b": ("cache_band_write", "llama2_7b_w4_decode_tokens_per_s"),
    "decode_attention_b32": ("decode_attention", "tinyllama_w4_decode_tokens_per_s_b32"),
    "decode_attention_llama2_7b": ("decode_attention", "llama2_7b_w4_decode_tokens_per_s"),
    "decode_attention_kv1": ("decode_attention", "shard_tp8"),
    "fused_mlp_llama2_7b": ("fused_mlp", "llama2_7b_w4_decode_tokens_per_s"),
    "fused_mlp_m32": ("fused_mlp", "tinyllama_w4_decode_tokens_per_s_b32"),
    "flash_attention_s8192": ("flash_attention", "tinyllama_w4_prefill_tokens_per_s_s8192"),
    "flash_attention_s2048_b2": ("flash_attention", "tinyllama_w4_prefill_tokens_per_s_s2048"),
    "decode_attention_write_moe_b8": ("decode_attention_write", "moe_8x1b_w4_decode_tokens_per_s"),
    "decode_attention_write_moe_b2": ("decode_attention_write",
                                      "moe_8x1b_w4_decode_tokens_per_s_b2"),
    "decode_attention_write_moe_b1": ("decode_attention_write",
                                      "moe_8x1b_w4_decode_tokens_per_s_b1"),
    "decode_attention_flash_s16k": ("decode_attention_flash",
                                    "tinyllama_w4_decode_tokens_per_s_s16k_cache"),
    "moe_matmul_8x1b_m8": ("moe_matmul", "moe_8x1b_w4_decode_tokens_per_s"),
    "moe_matmul_8x1b_m1": ("moe_matmul", "moe_8x1b_w4_decode_tokens_per_s_b1_dense"),
    "moe_gathered_matmul_8x1b_b1": ("moe_gathered_matmul", "moe_8x1b_w4_decode_tokens_per_s_b1"),
    "moe_gathered_matmul_8x1b_b2": ("moe_gathered_matmul", "moe_8x1b_w4_decode_tokens_per_s_b2"),
}
KERNEL_SOURCE = {
    "dequant_matmul": ("dequant_matmul.cu", "pallas_dequant_matmul.py:385"),
    "cache_band_write": ("kv_attention.cu", "pallas_kv_attention.py:1067"),
    "decode_attention": ("kv_attention.cu", "pallas_kv_attention.py:1147"),
    "fused_mlp": ("fused_mlp.cu", "pallas_fused_mlp.py:221"),
    "flash_attention": ("flash_attention.cu", "pallas_flash_attention.py:86"),
    "decode_attention_write": ("kv_attention.cu", "pallas_kv_attention.py:313"),
    "decode_attention_flash": ("kv_flash_decode.cu", "pallas_kv_attention.py:804"),
    "moe_matmul": ("moe_matmul.cu", "pallas_moe_matmul.py:40"),
    "moe_gathered_matmul": ("moe_matmul.cu", "pallas_moe_matmul.py:165"),
}


def _extras_kernel_rows(torch, ctx):
    """The kernels at the shapes of qtpu_torch.bench.extra's measurements
    (Llama-2-7B at B 8, TinyLlama at B 32, prefill at S 8192 and 2 x 2048,
    W8 at B 8, the 16k per-layer cache at B 4, the 8x1B MoE at B 8 / 2 / 1,
    and K3 at one KV head a rank, TinyLlama's tp 8), each
    against its plain version with its times and bound. Returns the detail;
    adds one entry a shape to the kernels line (EXTRA_ROWS), at the work of
    one decode step (prefill: one forward) of its measurement."""
    from qtpu_torch.bench.extra import MOE_8X1B
    from qtpu_torch.models.config import LLAMA2_7B as c7
    from qtpu_torch.models.config import TINYLLAMA_1_1B as ct

    gen = torch.Generator(device="cuda").manual_seed(31)
    dev = torch.device("cuda")
    detail, line = {}, {}

    def k1(tag, cfg, M, bits, sites):
        D, Q, KVd, F = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
        shapes = {"qkv": (D, Q + 2 * KVd), "o": (Q, D), "gateup": (D, 2 * F), "down": (F, D),
                  "lm_head": (D, cfg.vocab_size)}
        rows = {s: _k1_case(torch, ctx, gen, dev, M, *shapes[s], bits, 128) for s in sites}
        detail[f"K1_{tag}"] = rows
        return rows

    def put(name, rows_or_row, n=1, k1_sites=None, L=1):
        kernel = EXTRA_ROWS[name][0]
        src, rep = KERNEL_SOURCE[kernel]
        if k1_sites is not None:
            num = {key: _k1_sum(rows_or_row, k1_sites, L, key)
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
            err = max(r["max_abs_err"] for r in rows_or_row.values())
            by = max(rows_or_row.values(), key=lambda r: r["bound_ms"])["bound_by"]
        else:
            r = rows_or_row
            num = {key: None if r.get(key) is None else n * r[key]
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
            err, by = r["max_abs_err"], r["bound_by"]
        line[name] = {"route": "cuda", "source": f"qtpu_torch/csrc/{src}",
                      "replaces": f"qtpu/kernels/{rep}", "max_abs_err": err, **num,
                      "bound_by": by, "measurement": EXTRA_ROWS[name][1]}

    step = ("qkv", "o", "lm_head")
    rows = k1("llama2_7b_m8", c7, 8, 4, ("qkv", "o", "gateup", "down", "lm_head"))
    put("dequant_matmul_llama2_7b", rows, k1_sites=step, L=c7.num_layers)
    put("dequant_matmul_m32", k1("tinyllama_m32", ct, 32, 4, step), k1_sites=step,
        L=ct.num_layers)
    block = ("qkv", "o", "gateup", "down", "lm_head")
    put("dequant_matmul_m8192", k1("tinyllama_m8192", ct, 8192, 4, block), k1_sites=block,
        L=ct.num_layers)
    put("dequant_matmul_w8", k1("tinyllama_w8_m8", ct, 8, 8, step), k1_sites=step,
        L=ct.num_layers)
    L7, Lt = c7.num_layers, ct.num_layers
    for tag, (B, KV, H, hd, L) in {"b32": (32, 4, 32, 64, Lt), "llama2_7b": (8, 32, 32, 128, L7),
                                   "kv1": (8, 1, 4, 64, Lt)}.items():
        k2, k3 = _k23_rows(torch, gen, dev, B, KV, H, hd, 176, L)
        detail[f"K2_{tag}"], detail[f"K3_{tag}"] = k2, k3
        if tag != "kv1":
            put(f"cache_band_write_{tag}", k2, L)
        put(f"decode_attention_{tag}", k3, L)
    for tag, (B, c, L) in {"llama2_7b": (8, c7, L7), "m32": (32, ct, Lt)}.items():
        D, F = c.hidden_size, c.intermediate_size
        detail[f"K4_{tag}"] = r = _k4_row(torch, gen, dev, B, D, F, L)
        put(f"fused_mlp_{tag}", r, L)
    for tag, (B, S) in {"s8192": (1, 8192), "s2048_b2": (2, 2048)}.items():
        detail[f"K5_{tag}"] = r = _k5_row(torch, gen, dev, B, 32, 4, 64, S)
        put(f"flash_attention_{tag}", r, Lt)
        torch.cuda.empty_cache()
    for B in (8, 2, 1):
        detail[f"K11_moe_b{B}"] = r = _k11_extra_row(torch, gen, dev, B, 32, 4, 64, 176, Lt)
        put(f"decode_attention_write_moe_b{B}", r, Lt)
    detail["K12_s16k"] = r = _k12_s16k_row(torch, gen, dev)
    put("decode_attention_flash_s16k", r, Lt)
    torch.cuda.empty_cache()
    D, F, E = (MOE_8X1B[k] for k in ("hidden_size", "intermediate_size", "num_experts"))
    sites = {"gate_up": (D, F), "down": (F, D)}
    moe = {}
    for M9, slots in ((8, [(1, 5), (0, 3, 3, 6)]), (1, [])):
        moe[M9] = _k9_k10_rows(torch, gen, dev, E, sites, M9, slots)
        detail[f"K9_K10_8x1b_m{M9}"] = moe[M9]

    def moe_step(rows, prefix, suffix=""):
        r = {key: Lt * (2 * rows[f"{prefix}_gate_up{suffix}"][key]
                        + rows[f"{prefix}_down{suffix}"][key])
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        r["max_abs_err"] = max(rows[f"{prefix}_{s}{suffix}"]["max_abs_err"]
                               for s in ("gate_up", "down"))
        r["bound_by"] = rows[f"{prefix}_down{suffix}"]["bound_by"]
        return r

    put("moe_matmul_8x1b_m8", moe_step(moe[8], "K9"))
    put("moe_matmul_8x1b_m1", moe_step(moe[1], "K9"))
    put("moe_gathered_matmul_8x1b_b1", moe_step(moe[8], "K10", "_gs2"))
    put("moe_gathered_matmul_8x1b_b2", moe_step(moe[8], "K10", "_gs4"))
    ctx["kernel_rows"].update(line)
    return detail


PLAIN_OF = {  # (model module, wrapper name) -> (kernel module, plain version)
    ("ops", "quantized_matmul"): ("dequant_matmul", "quantized_matmul_plain"),
    ("llama", "quantized_matmul"): ("dequant_matmul", "quantized_matmul_plain"),
    ("ops", "flash_attention"): ("flash_attention", "flash_attention_plain"),
    ("ops", "w8a8_matmul"): ("int8_matmul", "w8a8_matmul_plain"),
    ("ops", "codebook_matmul"): ("codebook_matmul", "codebook_matmul_plain"),
    ("llama", "cache_band_write"): ("kv_attention", "cache_band_write_plain"),
    ("llama", "decode_attention"): ("kv_attention", "decode_attention_plain"),
    ("llama", "decode_attention_flash"): ("kv_attention", "flash_decode_plain"),
    ("llama", "decode_attention_write"): ("kv_attention", "decode_attention_write_plain"),
    ("llama", "decode_attention_write_bf16"): ("kv_attention",
                                                "decode_attention_write_bf16_plain"),
    ("moe", "moe_matmul"): ("moe_matmul", "moe_matmul_plain"),
    ("moe", "moe_gathered_matmul"): ("moe_matmul", "moe_gathered_matmul_plain"),
}


class _PlainKernels:
    """Within it the models call every kernel's plain version on the card
    (PLAIN_OF, and K4's module attribute): the same steps without a kernel,
    but for the kernels of `keep` (WRAPPERS' names), which run as usual.
    On leaving, it checks that no other wrapper counted a launch."""

    def __init__(self, keep=()):
        self.keep = set(keep)

    def __enter__(self):
        import importlib

        from qtpu_torch.kernels import fused_mlp as k4

        kept = {WRAPPERS[k][1] for k in self.keep}
        self.before = _counts()
        self.saved = []
        for (mod, name), (kmod, plain) in PLAIN_OF.items():
            if name in kept:
                continue
            m = importlib.import_module(f"qtpu_torch.models.{mod}")
            self.saved.append((m, name, getattr(m, name)))
            setattr(m, name, getattr(importlib.import_module(f"qtpu_torch.kernels.{kmod}"), plain))
        if "fused_mlp" not in self.keep:
            self.saved.append((k4, "fused_mlp", k4.fused_mlp))
            k4.fused_mlp = k4.fused_mlp_plain
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        moved = {k: v - self.before[k] for k, v in _counts().items()
                 if v != self.before[k] and k not in self.keep}
        if moved and exc[0] is None:
            raise AssertionError(f"the plain run launched kernels: {moved}")


def _forced_block(torch, packed, qmeta, cfg, rec):
    """decode_tps's first run up to its first block, eagerly and
    teacher-forced on its recorded tokens: the logits each token was drawn
    from, [B, 1 + block, V] (the prefill's first), on the host."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    prompt, arch, pad = rec["prompt"], rec["arch"], rec["cache_pad"]
    (B, P), dev = prompt.shape, prompt.device
    toks = torch.cat([rec["prefill_token"][:, None], rec["first_block"]], 1)
    cache = init_cache(cfg, B, rec["S"], quantized=True, device=dev, per_layer=rec["per_layer"])
    start = torch.full((B,), pad, dtype=torch.int32, device=dev) if pad else None
    logits, cache = prefill(packed, prompt, cache, cfg, qmeta, start=start, arch=arch)
    outs = [logits.float().cpu()]
    for i in range(toks.shape[1] - 1):
        pos = torch.full((B,), pad + P + i, dtype=torch.int32, device=dev)
        logits, cache = decode_step(packed, toks[:, i].contiguous(), pos, cache, cfg, qmeta,
                                    arch=arch)
        outs.append(logits.float().cpu())
    return torch.stack(outs, 1), toks.cpu()


def _cut(packed, n):
    """The first n layers of a params tree (views)."""
    return {**packed, "layers": {s: {k: None if v is None else v[:n] for k, v in p.items()}
                                 if isinstance(p, dict) else p[:n]
                                 for s, p in packed["layers"].items()}}


def _f32(packed):
    """The params with their dense leaves (embedding, norms) in f32, so the
    plain functions run the model in f32 on the same packed bytes."""
    return {k: ({s: p if isinstance(p, dict) else p.float() for s, p in v.items()}
                if k == "layers" else v if isinstance(v, dict) else v.float())
            for k, v in packed.items()}


def _block_vs_plain(torch, rec):
    """The recorded first block of a decode_tps run (CUDA graphs) against
    the same steps run eagerly on the kernels, whose argmax must be its
    tokens bit for bit; then, on the first EXTRA_PLAIN_LAYERS layers fed
    the same tokens, the kernels against the plain functions on the card:
    logits within EXTRA_TOL each step and the kernels' tokens equal to the
    plain run's where its top-2 gap is SHARD_FLIP_GAP or more (e2e's
    2-layer gate). Printed, not gated: the same at 4 layers and at full
    depth, and at 4 layers both runs against the plain functions in f32 on
    the same bytes. These models repeat one random layer (synth), and a
    bf16 difference grows through the repeats: the 7B's prefill logits
    8.5e-2 apart at 32 layers and 3.2e-2 at 4 (my chip call 4), each kernel
    within 5e-3 of its plain version at these shapes."""
    packed, qmeta = rec["model"]
    cfg = rec["cfg"]
    got, toks = _forced_block(torch, packed, qmeta, cfg, rec)
    out = {"steps": toks.shape[1], "B": toks.shape[0],
           "graph_tokens_are_eager_argmax": bool(torch.equal(got.argmax(-1).to(toks.dtype),
                                                             toks))}

    def per_step(a, b):
        return [rel_err(torch, a[:, i], b[:, i]) for i in range(a.shape[1])]

    L = cfg.num_layers
    for n in sorted({min(d, L) for d in (EXTRA_PLAIN_LAYERS, 4, L)}):
        cut, ccfg = _cut(packed, n), cfg.replace(num_layers=n)
        kern = got if n == L else _forced_block(torch, cut, qmeta, ccfg, rec)[0]
        with _PlainKernels():
            plain, _ = _forced_block(torch, cut, qmeta, ccfg, rec)
            f32 = (_forced_block(torch, _f32(cut), qmeta, ccfg, rec)[0] if n == min(4, L)
                   else None)
        r = {"rel_err_per_step": per_step(kern, plain)}
        if f32 is not None:
            r["kernels_vs_f32"] = max(per_step(kern, f32))
            r["plain_vs_f32"] = max(per_step(plain, f32))
        if n == min(EXTRA_PLAIN_LAYERS, L):
            pad = torch.cat([plain, plain[:, -1:]], 1)  # _token_check drops the last logits
            r["tokens"] = _token_check(pad, pad, kern.argmax(-1))
        out[f"layers_{n}"] = r
    gated = out[f"layers_{min(EXTRA_PLAIN_LAYERS, L)}"]
    if (not out["graph_tokens_are_eager_argmax"] or max(gated["rel_err_per_step"]) >= EXTRA_TOL
            or gated["tokens"]["differ_clear"]):
        raise AssertionError(f"extras: the first decode block against the plain run: {out}")
    return out


def _extras_reckon(key, rec, plan, L, L7):
    """What each kernel launches over one measurement's decode_tps or
    prefill_tps calls: 3 runs (n_small, n_large, n_small) of a prefill and
    their blocks, and the warm-up block before the capture."""
    if "prefill" in key:
        iters = plan.prefill[0 if key.endswith("s2048") else 1][2]
        n = iters + 3  # run(1), run(iters + 1), run(1)
        return {"dequant_matmul": n * (4 * L + 1), "flash_attention": n * L}
    steps = plan.block * (2 * plan.n_small + plan.n_large[_plan_key(key)] + 1)
    Lm = L7 if "7b" in key else L
    out = {"prefills": 3, "steps": steps}
    if "moe" in key:
        c = rec["cfg"]
        gathered = rec["B"] * c.num_experts_per_tok < c.num_experts and not key.endswith("_dense")
        out.update(dequant_matmul=(3 + steps) * (4 * Lm + 1),
                   decode_attention_write=steps * Lm,
                   moe_matmul=3 * 3 * Lm + (0 if gathered else steps * 3 * Lm),
                   moe_gathered_matmul=steps * 3 * Lm if gathered else 0)
    elif "w8a8" in key:
        out.update(w8a8_matmul=(3 + steps) * (7 * Lm + 1), dequant_matmul=0, fused_mlp=0,
                   cache_band_write=steps * Lm, decode_attention=steps * Lm)
    elif "s16k" in key:
        out.update(dequant_matmul=3 * (4 * Lm + 1) + steps * (2 * Lm + 1),
                   fused_mlp=steps * Lm, decode_attention_flash=steps * Lm,
                   cache_band_write=0, decode_attention=0)
    else:
        out.update(dequant_matmul=3 * (4 * Lm + 1) + steps * (2 * Lm + 1),
                   fused_mlp=steps * Lm, cache_band_write=steps * Lm,
                   decode_attention=steps * Lm)
    return out


def _plan_key(key):
    for tag, n in (("llama2_7b", "7b"), ("s16k", "s16k"), ("w8", "w8"), ("b32", "b32"),
                   ("moe", "moe")):
        if tag in key:
            return n
    raise KeyError(key)


EXTRA_PLAIN_CHECKS = ("llama2_7b_w4_decode_tokens_per_s",
                      "tinyllama_w4_decode_tokens_per_s_s16k_cache")


def phase_extras(torch, ctx):
    """qtpu's last entry points on the card at full width. (1) Every
    measurement of qtpu_torch.bench.extra (bench_extra.py's keys: Llama-2-7B
    W4 at B 8, TinyLlama W4 prefill at 2 x 2048 and 1 x 8192, decode over a
    16k per-layer cache at B 4, W8 and W8A8 at B 8, B 32, the batcher cold
    and warm, the 8x1B MoE at B 8, 1, 2 and 1 forced onto the grouped
    route) once, with the fewest blocks qtpu's estimator takes (n_small 1,
    n_large 2, prefill 2 forwards against 1): each rate on a line of its
    own with the launches of each kernel, held to the reckoning of its runs
    (K12 in s16k, K9 at B 8 and b1_dense, K10 at B 1 and 2, K6 and no K1 in
    W8A8, K5 in prefill on its Hopper body, K4 at M 32 on dq_core's GEMV
    since the tensor-core one takes M <= 8). (2) The first decode block of
    the 7B run and of the s16k run (graphs) against the same steps eagerly
    on the kernels (bit for bit) and, on their first EXTRA_PLAIN_LAYERS
    layers, on the plain functions on the card (_block_vs_plain: 4 layers,
    f32 and the full depth printed, not gated). (3) graft.entry()'s forward on
    the kernels against the plain functions. (4) scaling_sweep at (1, 1) and
    (2, 1) on TinyLlama W4, the two ranks gloo processes sharing the card (a
    functional run: its efficiency means nothing). (5)
    graft.dryrun_multichip(4): 4 gloo ranks on the card, the TP logits against
    the one-rank forward."""
    from qtpu_torch.bench import extra, graft
    from qtpu_torch.bench.scaling import scaling_sweep
    from qtpu_torch.bench.synth import tiled_packed_llama
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import LLAMA2_7B, TINY_TEST
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg
    from qtpu_torch.quant.apply import pack_model

    L, L7 = cfg.num_layers, LLAMA2_7B.num_layers
    plan = extra.Plan().quick()
    records, rates, paths = {}, {}, ctx.setdefault("path_launches", {})
    for keys, thunk in extra.measurements(plan, "cuda", records):
        _reset_counts()
        t0 = time.perf_counter()
        vals = thunk()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, routes = _counts(), _route_counts()
        rates.update(vals)
        emit({"phase": "extras_rate", "card": ctx["smi"], **vals, "seconds": secs,
              "launches": {k: v for k, v in counts.items() if v},
              "routes": {k: v for k, v in routes.items() if v}})
        paths[f"extras_{keys[0]}"] = {**counts, **routes}
        for name, (kernel, key) in EXTRA_ROWS.items():
            if key in keys:
                paths[f"extras_{keys[0]}"][name] = counts[kernel]
        if keys[0].startswith("batcher"):  # 12 slots: K1 on the Hopper route, K4 on dq_core's
            path = ("dequant_matmul", "cache_band_write", "decode_attention", "fused_mlp")
            if (not all(counts[k] for k in path)
                    or any(v for k, v in counts.items() if k not in path)
                    or routes["dequant_matmul_wgmma"] != counts["dequant_matmul"]):
                raise AssertionError(f"extras: the batcher's launches {counts}, {routes}")
            continue
        if len(keys) == 2:  # W8 and W8A8 ran in one thunk: held to their sum
            want = {}
            for k in keys:
                for kernel, n in _extras_reckon(k, records[k], plan, L, L7).items():
                    if kernel not in ("prefills", "steps"):
                        want[kernel] = want.get(kernel, 0) + n
        else:
            want = {k: v for k, v in _extras_reckon(keys[0], records.get(keys[0], {}), plan,
                                                     L, L7).items()
                    if k not in ("prefills", "steps")}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"extras {keys}: launches {got} != reckoned {want}")
        if "prefill" in keys[0]:
            _check_routes(f"extras {keys[0]}", routes, k1=want["dequant_matmul"])
            _check_gemv(f"extras {keys[0]}", counts, routes)
        elif "b32" in keys[0]:  # M 32: K1 on the Hopper route, K4 on dq_core's GEMV
            if routes["fused_mlp_gemv"] != counts["fused_mlp"] or routes["fused_mlp_gemv_tc"]:
                raise AssertionError(f"extras b32: K4's bodies {routes}")
        else:
            _check_gemv(f"extras {keys[0]}", counts, routes)
    emit({"phase": "extras_rates", "card": ctx["smi"], "plan": "quick (n_small 1, n_large 2)",
          **rates})

    t0 = time.perf_counter()
    plain = {k: _block_vs_plain(torch, records[k]) for k in EXTRA_PLAIN_CHECKS}
    emit({"phase": "extras_vs_plain", "card": ctx["smi"], "seconds": time.perf_counter() - t0,
          **plain})
    records.clear()
    torch.cuda.empty_cache()

    fn, (packed, ids) = graft.entry()
    _reset_counts()
    got = fn(packed, ids)
    torch.cuda.synchronize()
    counts, routes = _counts(), _route_counts()
    with _PlainKernels():
        want = fn(packed, ids)
    r = {"rel_err": rel_err(torch, got, want), "shape": list(got.shape),
         "launches": {k: v for k, v in counts.items() if v}}
    emit({"phase": "extras_entry", "card": ctx["smi"], **r})
    if r["rel_err"] >= EXTRA_TOL or counts["flash_attention"] != L:
        raise AssertionError(f"extras: graft.entry's forward {r}")
    _check_routes("extras entry", routes, k1=4 * L + 1)
    _check_gemv("extras entry", counts, routes)
    paths["extras_entry"] = {**counts, **routes}
    del packed, got, want

    t0 = time.perf_counter()
    packed, qmeta = tiled_packed_llama(cfg, 4, 128)
    recs = {}
    rows = scaling_sweep(packed, cfg, qmeta, mesh_shapes=((1, 1), (2, 1)), records=recs)
    one, two = recs[(1, 1)][0], recs[(2, 1)]
    scal = {"rows": rows, "seconds": time.perf_counter() - t0,
            "rank0_tokens_equal_one_rank": bool(torch.equal(two[0]["tokens"], one["tokens"])),
            "note": "two gloo ranks sharing one card: a functional run, its efficiency "
                    "means nothing"}
    emit({"phase": "extras_scaling", "card": ctx["smi"], **scal})
    if (len(rows) != 2 or rows[0]["scaling_efficiency"] != 1.0
            or not all(r["tokens_per_second"] > 0 for r in rows)
            or not scal["rank0_tokens_equal_one_rank"]):
        raise AssertionError(f"extras: the scaling sweep {scal}")
    del packed

    t0 = time.perf_counter()
    res = graft.dryrun_multichip(4)
    params = llama.init_params(TINY_TEST, seed=0, device="cuda")
    pk, pq = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64})
    ids = res[0]["ids"].cuda()
    want = llama.forward(pk, ids, TINY_TEST, qmeta=pq).float().cpu()
    got = torch.cat([res[0]["tp_logits"], res[2]["tp_logits"]])
    dry = {"line": res[0]["line"], "seconds": time.perf_counter() - t0,
           "tp_rel_err_vs_one_rank": rel_err(torch, got, want)}
    emit({"phase": "extras_dryrun", "card": ctx["smi"], **dry})
    if dry["tp_rel_err_vs_one_rank"] >= SHARD_TOL or "over seq=4" not in dry["line"]:
        raise AssertionError(f"extras: the dry run {dry}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, from {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p}; phases: {PHASES}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        import qtpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the qtpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from qtpu_torch.models import ops

    ctx = {}
    phase_device(torch, ctx)
    t_all = time.perf_counter()
    for p in phases:
        if p == "device":
            continue
        t0 = time.perf_counter()
        a0 = ops.plain_attention.launches
        globals()[f"phase_{p}"](torch, ctx)
        # attention calls a kernel did not take by its shape (the plain
        # route): none but those a phase reckons (none at all today)
        plain = ops.plain_attention.launches - a0
        reckoned = ctx.pop("plain_attention_reckoned", 0)
        emit({"phase_done": p, "seconds": time.perf_counter() - t0,
              "plain_attention_launches": plain, "plain_attention_reckoned": reckoned})
        if plain != reckoned:
            raise AssertionError(f"{p}: {plain} attention calls took the plain route, "
                                 f"{reckoned} reckoned")
    emit({"phases": phases, "seconds": time.perf_counter() - t_all})
    print(ctx["smi"], flush=True)
    if "kernel_rows" in ctx:
        # launches: the sum over the main paths' runs (serve, long_ctx,
        # serve_gpt2's two models, opt_2_7b's two engines and packed eval,
        # eval, quant, serve_w8a8, pot_apot, serve_bf16, serve_moe's two
        # engines, ckpt's bench and two engines, e2e's head-dim models for
        # the <kernel>_hd80 / _hd96 rows, the extras' measurements and
        # entry() for the rows of EXTRA_ROWS and shard's TP 8 rank 0 for
        # decode_attention_kv1), each counted from 0 just before it
        # gemv_tc_launches: those of them on the tensor-core GEMV (the
        # decode launches of K1, K4, K6, K7, K9 and every K10 launch)
        paths = ctx.get("path_launches", {}).values()
        rows = []
        for name, row in ctx["kernel_rows"].items():
            rows.append({"name": name, "launches": sum(c.get(name, 0) for c in paths), **row})
            if any(f"{name}_gemv_tc" in c for c in paths):
                rows[-1]["gemv_tc_launches"] = sum(c.get(f"{name}_gemv_tc", 0) for c in paths)
        emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": ctx["name"], "count": ctx["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
