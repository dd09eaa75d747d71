"""Continuous batching engine (port of qtpu/serve/batching.py).

A fixed table of `max_batch` sequence slots over one stacked KV cache.
Requests join mid-flight: their prompt is prefilled into a free slot (in
chunks of `prefill_chunk` tokens, up to `prefill_parallel` requests per
prefill call) while the other slots keep decoding in blocks of
`decode_block` steps; a slot frees on EOS or max_new_tokens. Sampling runs
on the device, and only the sampled ids of a block are read back.

Invariants per active slot i with request r:
  r.output    -- tokens emitted so far (the first is sampled from the
                 prefill logits at the last real prompt position)
  input token =  r.output[-1], at position prompt_len + len(output) - 1
Inactive slots decode with pos = S (the cache length), which the cache
write skips.

A prefill call runs qtpu's bucketed shapes (qtpu's `_prefill_chunk_arrays`):
P rows, 1 for one in-flight prefill, else min(_bucket(n), prefill_parallel,
max_batch); Tb tokens, prefill_chunk while any row has more than a chunk
left, else min(_bucket(longest remainder), prefill_chunk). Pad rows name
distinct slots that are not prefilling (a decoding slot among them) with
start = S, so the cache write leaves their rows as they are; a row whose
bucket runs past the cache end is written at S - Tb, as qtpu's
dynamic_update_slice clamps it. The call writes the rows' K/V straight into
their slots of the live cache.

kv_layout="per_layer" keeps the cache as L per-layer buffers (qtpu's
long-context layout), whose int8 decode runs K12 when the cache length S is a
multiple of 2048. S is max_seq_len + decode_block rounded up to 8, as in
qtpu, so pick max_seq_len = 2048 k - decode_block (32752 with decode_block
16 gives S 32768; max_seq_len 32768 gives S 32784, and K11). The per-layer
layout serves the llama and moe arches; gpt2 and opt raise, as qtpu's layer
scan over the stacked cache does.

Decode blocks as qtpu runs them: `decode_block` steps while admissions
are pending; with nothing queued or prefilling (qtpu's drain mode) a block
of 64 or 32 where every active slot has at least that many tokens left.
The block reads the engine's static device inputs `token`, `pos` and
`temps` [max_batch], into which each block copies its host arrays; only the
sampled ids come back, in one copy a block.

On a CUDA device (cuda_graphs=True, the default) each (block size, greedy
or sampling) decode block is a CUDA graph captured on those inputs and the
live cache, which the graph writes in place, and replayed (serve/graphs.py;
the sampler's generator registered with the sampling graphs). So is each
(P, Tb) prefill bucket: the embedding, every layer with its cache write
through `slots`, the first-column gather and mixed_sample (the generator
registered), on static ids, starts, slots, first_cols and ptemps of that
bucket. qtpu fuses a prefill and a decode block into one program
(`_fused_step`, a relay-dispatch workaround); here they are two graphs
replayed back to back. All graphs share one memory pool, so a graph captured
later may reuse, in its replay, memory that holds an earlier one's output:
a prefill graph writes its sampled ids into a buffer of its own outside the
pool, which the decode block replayed after it cannot touch. `warmup()`
captures qtpu's warm set before traffic, as qtpu's warmup() compiles its
program zoo (the decode blocks, then `prefill_buckets`); any other block or
bucket is captured at its first use. A graph keeps what the step decided at
capture: QTPU_BOUNDARY and QTPU_FUSE_NORM_RESID, read on each forward, are
frozen into an engine's decode and prefill graphs as they stood when it
captured them. A capture or replay that fails raises; the engine never
falls back to eager. A CPU engine, or one with cuda_graphs=False, has
nothing to capture and runs the same shapes eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from qtpu_torch.serve.decode import decode_multi, mixed_sample, prefill_full
from qtpu_torch.serve.graphs import capture
from qtpu_torch.serve.kvcache import init_cache
from qtpu_torch.utils.compcache import enable_compilation_cache

DRAIN_BLOCKS = (64, 32)  # qtpu's drain-mode decode blocks, largest first
WARM_TOKENS = (16, 32, 64, 128, 256, 512)  # qtpu's warm chunk lengths, before the chunk itself


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int = 64
    temperature: float = 0.0
    output: list = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def ttft(self) -> float:
        """Time to first token."""
        return self.first_token_at - self.submitted_at

    @property
    def tokens_per_second(self) -> float:
        dt = self.finished_at - self.first_token_at
        return (len(self.output) - 1) / dt if dt > 0 else float("inf")


@dataclass
class _Prefill:
    """An in-flight chunked prefill: `done` tokens of `req` are in slot
    `slot`'s cache."""

    req: Request
    slot: int
    done: int = 0


def _bucket(n: int) -> int:
    """qtpu's admission bucket: the least 16 * 2^k >= n."""
    b = 16
    while b < n:
        b *= 2
    return b


@dataclass
class _PrefillGraph:
    """A captured (P, Tb) prefill: its static inputs (ids, starts, slots,
    first_cols, ptemps), the sampled ids it writes (outside the graphs'
    pool) and the graph."""

    inputs: tuple
    firsts: torch.Tensor
    graph: object


class ContinuousBatcher:
    def __init__(
        self,
        params,
        cfg,
        qmeta=None,
        max_batch: int = 8,
        max_seq_len: int = 1024,
        kv_dtype: str = "bfloat16",
        eos_token: int | None = None,
        seed: int = 0,
        decode_block: int = 16,
        prefill_chunk: int = 256,
        prefill_parallel: int | None = None,
        device="cuda",
        kv_layout: str | None = None,
        cuda_graphs: bool = True,
    ):
        # qtpu's cold-start switch: here QTPU_COMPILE_CACHE places the kernels' build
        enable_compilation_cache()
        self.params = params
        self.cfg = cfg
        self.arch = cfg.arch
        self.qmeta = qmeta
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.eos = eos_token
        self.device = torch.device(device)
        self.decode_block = max(1, decode_block)
        self.prefill_chunk = max(16, prefill_chunk)
        self.prefill_parallel = max(
            1, max_batch if prefill_parallel is None else prefill_parallel
        )
        self.kv_layout = "stacked" if kv_layout is None else kv_layout
        if self.kv_layout not in ("stacked", "per_layer"):
            raise ValueError(f"kv_layout must be 'stacked' or 'per_layer', got {kv_layout!r}")
        # decode blocks may overshoot a slot's last token by block-1 steps;
        # size the cache so those writes stay in range
        self.cache = init_cache(
            cfg, max_batch, max_seq_len + self.decode_block,
            quantized=(kv_dtype == "int8"), device=self.device,
            per_layer=self.kv_layout == "per_layer",
        )
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.prefilling: list[_Prefill] = []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._uid = 0
        self.prefill_calls = 0
        self.decode_steps = 0
        # the decode blocks' static inputs, as qtpu's programs take them
        self.token = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.temps = torch.zeros((max_batch,), dtype=torch.float32, device=self.device)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self.graphs = {}  # (block, sampling) -> CapturedGraph
        self.prefill_graphs = {}  # (P, Tb) -> _PrefillGraph
        self.prefill_shapes = {}  # (P, Tb) -> prefill calls run at that shape
        self._pool = None  # the graphs' shared memory pool, made at the first capture

    @property
    def decode_blocks(self) -> list[int]:
        """The block sizes step() runs: decode_block and the larger drain
        blocks (those warmup() captures)."""
        return sorted({self.decode_block} | {b for b in DRAIN_BLOCKS if b > self.decode_block})

    @property
    def prefill_buckets(self) -> list[tuple[int, int]]:
        """qtpu's warm set of (P, Tb) prefill shapes (its warmup()): P in {1,
        min(16, prefill_parallel, max_batch)}, Tb in {min(_bucket(x),
        min(prefill_chunk, max_seq_len))} over WARM_TOKENS and the chunk."""
        cap = min(self.prefill_chunk, self.max_seq_len)
        tbs = sorted({min(_bucket(x), cap) for x in (*WARM_TOKENS, self.prefill_chunk)})
        ps = sorted({1, min(16, self.prefill_parallel, self.max_batch)})
        return [(p, t) for p in ps for t in tbs]

    def warmup(self, include_sampling: bool = False) -> float:
        """Gets the engine ready for traffic, as qtpu's warmup(): builds every
        kernel library, then on a graph engine captures the greedy decode
        graph of each block size (with include_sampling, the sampling ones
        too) and the prefill graph of each of `prefill_buckets`; an eager
        engine runs the largest of those buckets once on a scratch cache.
        The live cache and the generator's state are left as they were, so
        a warmed engine answers as a cold one does. Returns wall seconds."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            from qtpu_torch.kernels import _build

            _build.build()
        if self.cuda_graphs:  # each capture runs its shape eagerly first
            for block in self.decode_blocks:
                for sampling in (False, True) if include_sampling else (False,):
                    self._graph(block, sampling)
            for P, Tb in self.prefill_buckets:
                self._prefill_graph(P, Tb)
        else:
            state = self.generator.get_state()
            P, T = max(self.prefill_buckets)
            scratch = init_cache(self.cfg, P, self.cache.max_len, quantized=self.cache.quantized,
                                 device=self.device, per_layer=self.cache.per_layer)
            logits, _ = prefill_full(
                self.params, torch.zeros((P, T), dtype=torch.int32, device=self.device), scratch,
                self.cfg, self.qmeta, start=torch.zeros((P,), dtype=torch.int32, device=self.device),
                arch=self.arch, slots=torch.arange(P, device=self.device),
            )
            mixed_sample(logits[:, -1], torch.ones((P,), device=self.device), self.generator)
            del scratch, logits
            self.generator.set_state(state)
        if cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ----------------------------------------------------------- client API
    def submit(self, prompt_ids, max_new_tokens: int = 64, temperature: float = 0.0):
        req = Request(
            uid=self._uid,
            prompt=np.asarray(prompt_ids, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            submitted_at=time.perf_counter(),
        )
        self._uid += 1
        self.queue.append(req)
        return req

    def run(self, max_steps: int = 100_000):
        """Drive until queue and slots drain. Returns finished requests."""
        steps = 0
        while (
            self.queue or self.prefilling or any(s is not None for s in self.slots)
        ) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    @property
    def active(self) -> list[int]:
        return [i for i in range(self.max_batch) if self.slots[i] is not None]

    # ------------------------------------------------------------ internals
    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _start_prefill(self):
        """Admit queued requests into free slots, up to prefill_parallel
        in-flight prefills."""
        while self.queue and len(self.prefilling) < self.prefill_parallel:
            free = next((i for i in range(self.max_batch) if self.slots[i] is None), None)
            if free is None:
                return
            req = self.queue.pop(0)
            T = len(req.prompt)
            if T == 0 or T + req.max_new_tokens > self.max_seq_len:
                req.done = True
                req.finished_at = time.perf_counter()
                self.finished.append(req)
                continue
            self.slots[free] = req  # reserved; the first token comes with the last chunk
            self.prefilling.append(_Prefill(req=req, slot=free, done=0))

    def _prefill_chunk_arrays(self):
        """This step's bucketed admission arrays (qtpu's): (ids [P, Tb],
        starts [P], slots [P] (int64), ns tokens consumed per live row,
        first_cols [P], ptemps [P]). Live rows come first; pad rows take
        distinct slots that are not prefilling, with start = S and token 0."""
        pfs = self.prefilling
        P = _bucket(len(pfs)) if len(pfs) > 1 else 1
        P = min(P, self.prefill_parallel, self.max_batch)
        chunk = self.prefill_chunk
        rems = [len(pf.req.prompt) - pf.done for pf in pfs]
        Tb = min(_bucket(max(rems)), chunk) if all(r <= chunk for r in rems) else chunk
        ids = np.zeros((P, Tb), np.int32)
        starts = np.full((P,), self.cache.max_len, np.int32)  # pad rows: masked
        first_cols = np.zeros((P,), np.int32)
        ptemps = np.zeros((P,), np.float32)
        ns = []
        for r, pf in enumerate(pfs):
            n = min(len(pf.req.prompt) - pf.done, Tb)
            ids[r, :n] = pf.req.prompt[pf.done : pf.done + n]
            starts[r] = pf.done
            first_cols[r] = max(n - 1, 0)
            ptemps[r] = pf.req.temperature
            ns.append(n)
        live = {pf.slot for pf in pfs}
        spare = [i for i in range(self.max_batch) if i not in live]
        slots = np.asarray([pf.slot for pf in pfs] + spare[: P - len(pfs)], np.int64)
        return ids, starts, slots, ns, first_cols, ptemps

    def run_prefill(self, ids, starts, slots, first_cols, ptemps):
        """One prefill call from host arrays (those of _prefill_chunk_arrays):
        the bucket's graph replayed, or eager. Returns the sampled ids [P] on
        the device, valid until the bucket's next replay."""
        P, Tb = ids.shape
        if Tb > self.cache.max_len:  # qtpu's dynamic_update_slice refuses an update wider than S
            raise ValueError(f"a prefill of {Tb} tokens is wider than the cache ({self.cache.max_len})")
        host = (ids, starts, slots, first_cols, ptemps)
        if self.cuda_graphs:
            g = self._prefill_graph(P, Tb)
            for dst, src in zip(g.inputs, host):
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src)), non_blocking=True)
            g.graph.replay()
            firsts = g.firsts
        else:
            dtypes = (torch.int32, torch.int32, torch.int64, torch.int64, torch.float32)
            firsts = self._prefill_forward(*(self._tensor(a, d) for a, d in zip(host, dtypes)))
        self.prefill_calls += 1
        self.prefill_shapes[(P, Tb)] = self.prefill_shapes.get((P, Tb), 0) + 1
        return firsts

    def _prefill_forward(self, ids, starts, slots, first_cols, ptemps):
        """Prefill the rows into their slots of the live cache and sample each
        row's next token at its first_col (all device tensors)."""
        logits, self.cache = prefill_full(self.params, ids, self.cache, self.cfg, self.qmeta,
                                          start=starts, arch=self.arch, slots=slots)
        row_logits = logits[torch.arange(ids.shape[0], device=self.device), first_cols]
        return mixed_sample(row_logits, ptemps, self.generator)

    def _prefill_graph(self, P, Tb):
        """The (P, Tb) prefill's CUDA graph, captured at its first use on
        static inputs made as pad rows (slots 0..P-1, start = S) after one
        eager run of them."""
        g = self.prefill_graphs.get((P, Tb))
        if g is None:
            self._ensure_pool()
            dev = self.device
            inputs = (torch.zeros((P, Tb), dtype=torch.int32, device=dev),
                      torch.full((P,), self.cache.max_len, dtype=torch.int32, device=dev),
                      torch.arange(P, dtype=torch.int64, device=dev),
                      torch.zeros((P,), dtype=torch.int64, device=dev),
                      torch.zeros((P,), dtype=torch.float32, device=dev))
            firsts = torch.zeros((P,), dtype=torch.int32, device=dev)  # outside the pool
            self._side_run(lambda: self._prefill_forward(*inputs))
            graph = capture(lambda: firsts.copy_(self._prefill_forward(*inputs)), self._pool,
                            self.generator)
            g = self.prefill_graphs[(P, Tb)] = _PrefillGraph(inputs, firsts, graph)
        return g

    def _apply_prefill_results(self, ns, firsts):
        """Advance the in-flight admissions by this chunk; requests whose
        prompt completed take their sampled first token."""
        still = []
        now = time.perf_counter()
        for r, pf in enumerate(self.prefilling):
            pf.done += ns[r]
            if pf.done >= len(pf.req.prompt):
                pf.req.output.append(int(firsts[r]))
                pf.req.first_token_at = now
                self._finish_if_done(pf.slot, pf.req)
            else:
                still.append(pf)
        self.prefilling = still

    def _finish_if_done(self, i, req) -> bool:
        tok = req.output[-1] if req.output else None
        hit_eos = self.eos is not None and tok == self.eos
        total = len(req.prompt) + len(req.output)
        if hit_eos or len(req.output) >= req.max_new_tokens or total >= self.max_seq_len:
            req.done = True
            req.finished_at = time.perf_counter()
            self.finished.append(req)
            self.slots[i] = None
            return True
        return False

    def step(self):
        """One engine step: admissions (one prefill chunk) and a decode
        block for the running slots; with nothing to admit, qtpu's drain
        mode: the largest of DRAIN_BLOCKS above decode_block that every
        active slot has tokens left for."""
        self._start_prefill()
        mid_prefill = {pf.slot for pf in self.prefilling}
        active = [i for i in self.active if i not in mid_prefill]
        if not self.prefilling:
            if active:
                block = self.decode_block
                if not self.queue:
                    remaining = min(self.slots[i].max_new_tokens - len(self.slots[i].output)
                                    for i in active)
                    block = next((b for b in DRAIN_BLOCKS if block < b <= remaining), block)
                self._decode_block(active, block)
            return
        ids, starts, slots, ns, first_cols, ptemps = self._prefill_chunk_arrays()
        firsts = self.run_prefill(ids, starts, slots, first_cols, ptemps)
        toks = self._decode_block_tokens(active, self.decode_block) if active else None
        self._apply_prefill_results(ns, firsts.cpu().numpy())
        if active:
            self._apply_decode_results(active, toks, self.decode_block)

    def _decode_arrays(self, active):
        S_cap = self.cache.max_len
        tokens = np.zeros((self.max_batch,), np.int32)
        pos = np.full((self.max_batch,), S_cap, np.int32)  # inactive: masked
        temps = np.zeros((self.max_batch,), np.float32)
        for i in active:
            req = self.slots[i]
            tokens[i] = req.output[-1]
            pos[i] = len(req.prompt) + len(req.output) - 1
            temps[i] = req.temperature
        return tokens, pos, temps

    def _decode_block_tokens(self, active, block):
        return self.run_decode_block(*self._decode_arrays(active), block)

    def run_decode_block(self, tokens, pos, temps, block: int):
        """One decode block of `block` steps from the host arrays tokens, pos
        [max_batch] (int32; pos = the cache length S for an inactive slot)
        and temps [max_batch] (f32; all 0: greedy). Returns the sampled ids
        [max_batch, block], read back in one copy."""
        return self.launch_decode_block(tokens, pos, temps, block).cpu().numpy()

    def launch_decode_block(self, tokens, pos, temps, block: int):
        """run_decode_block without the read-back: copies the host arrays
        into the static inputs and replays the block's graph (eager:
        decode_multi on them), with no host synchronization once the graph
        exists. Returns the ids on the device (a graph's static output,
        valid until its next replay)."""
        sampling = bool(np.any(temps > 0.0))
        for dst, src in ((self.token, tokens), (self.pos, pos), (self.temps, temps)):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)), non_blocking=True)
        if self.cuda_graphs:
            toks = self._graph(block, sampling).replay()
        else:
            toks, self.cache = self._decode_multi(block, sampling)
        self.decode_steps += block
        return toks

    def _decode_multi(self, block, sampling):
        return decode_multi(self.params, self.token, self.pos, self.cache,
                            self.temps if sampling else None, self.generator, self.cfg, block,
                            self.qmeta, arch=self.arch)

    def _graph(self, block, sampling):
        """The block's CUDA graph, captured at its first use."""
        g = self.graphs.get((block, sampling))
        if g is None:
            self._ensure_pool()
            g = capture(lambda: self._decode_multi(block, sampling)[0], self._pool,
                        self.generator if sampling else None)
            self.graphs[(block, sampling)] = g
        return g

    def _ensure_pool(self):
        """Before the engine's first capture: one eager sampling decode step
        with every slot inactive (pos = S, so the cache rows stay unwritten;
        the static inputs restored after it), then the graphs' shared pool."""
        if self._pool is not None:
            return
        saved = [t.clone() for t in (self.token, self.pos, self.temps)]
        self.pos.fill_(self.cache.max_len)
        self.temps.fill_(1.0)
        self._side_run(lambda: self._decode_multi(1, True))
        for t, v in zip((self.token, self.pos, self.temps), saved):
            t.copy_(v)
        self._pool = torch.cuda.graph_pool_handle()

    def _side_run(self, fn):
        """fn() eagerly on a side stream before a capture (torch.cuda.graph's
        warm-up: loads the kernel libraries and sets their attributes outside
        the capture); the cache length and the generator's state are
        restored after it."""
        state, length = self.generator.get_state(), self.cache.length.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.cache.length.copy_(length)
        torch.cuda.synchronize(self.device)
        self.generator.set_state(state)

    def _apply_decode_results(self, active, toks_np, block):
        for i in active:
            req = self.slots[i]
            for j in range(block):
                req.output.append(int(toks_np[i, j]))
                if self._finish_if_done(i, req):
                    break

    def _decode_block(self, active, block):
        """Pure-decode step (no admissions pending): one decode block."""
        self._apply_decode_results(active, self._decode_block_tokens(active, block), block)

    def metrics(self) -> dict:
        """Aggregate serving metrics over finished requests, and the
        engine's counts of prefill calls and decode steps."""
        done = [r for r in self.finished if r.output]
        out = {"prefill_calls": self.prefill_calls, "decode_steps": self.decode_steps}
        if not done:
            return {"requests": 0, **out}
        multi = [r.tokens_per_second for r in done if len(r.output) > 1]
        return {
            "requests": len(done),
            "total_tokens": sum(len(r.output) for r in done),
            "mean_ttft_s": float(np.mean([r.ttft for r in done])),
            "mean_tokens_per_second": float(np.mean(multi)) if multi else 0.0,
            **out,
        }
