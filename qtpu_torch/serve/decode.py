"""Prefill and decode steps and sampling (port of qtpu/serve/decode.py).

qtpu's `decode_multi` is one compiled lax.scan with the cache donated; here
it is a loop of decode steps that update the cache in place, the sampled
tokens staying on the device until the caller reads the block. Nothing in a
block synchronizes with the host, so the engine captures a block as one
CUDA graph (serve/graphs.py) and replays it. Random
sampling draws from an explicit torch.Generator (qtpu's jax.random keys
give other numbers from the same seed; greedy decoding is identical).

Tensor-parallel serving (qtpu's TP decode, tests/test_sharding.py:111-143):
every entry takes a `tp` group with the rank's local params, config and
cache (init_cache with the local config holds the rank's KV heads); the
logits come back whole on every rank, so each rank samples the same
tokens. Under tp the steps run eager: a collective inside a captured CUDA
graph is not in this port.
"""

from __future__ import annotations

import torch


def _fwc(arch):
    from qtpu_torch.models import get_arch

    return get_arch(arch).forward_with_cache


def _positions(B, T, start, device):
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=device)
    return start[:, None] + torch.arange(T, dtype=torch.int32, device=device)[None, :]


def prefill(params, ids, cache, cfg, qmeta=None, start=None, arch="llama", tp=None):
    """Process a [B, T] prompt; returns (last-position logits [B, V], cache).
    start: [B] per-sequence offsets (default zeros)."""
    logits, cache = prefill_full(params, ids, cache, cfg, qmeta, start, arch, tp=tp)
    return logits[:, -1, :], cache


def prefill_full(params, ids, cache, cfg, qmeta=None, start=None, arch="llama", slots=None,
                 tp=None):
    """Like prefill but returns the logits at every position [B, T, V].
    slots: [B] cache rows of the batch rows (default: row b is cache row b)."""
    B, T = ids.shape
    positions = _positions(B, T, start, ids.device)
    return _fwc(arch)(params, ids, positions, cache, cfg, qmeta, slots=slots, tp=tp)


def decode_step(params, token, pos, cache, cfg, qmeta=None, arch="llama", tp=None):
    """One token per sequence: token [B], pos [B] absolute positions.
    Returns (logits [B, V], cache)."""
    logits, cache = _fwc(arch)(params, token[:, None], pos[:, None], cache, cfg, qmeta, tp=tp)
    return logits[:, 0, :], cache


def _categorical(logits, generator):
    """One draw per row from softmax(logits): torch.multinomial's own
    algorithm for a single sample (argmax of p / q, q ~ Exp(1) from
    `generator`), so the same numbers, without its host-side checks of p,
    which synchronize with the device and cannot run inside a CUDA graph."""
    probs = torch.softmax(logits.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def sample_token(logits, generator=None, temperature=0.0, top_k=0, top_p=0.0):
    """Greedy (temperature 0) / temperature / top-k / top-p sampling."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, -torch.inf), logits)
    return _categorical(logits, generator)


def mixed_sample(logits, temps, generator=None):
    """Per-row sampling: greedy where temps <= 0, categorical at temps[i]
    otherwise; temps=None is all greedy. logits [B, V] -> [B] int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temps is None:
        return greedy
    z = logits / torch.clamp(temps, min=1e-6)[:, None]
    samp = _categorical(z, generator)
    return torch.where(temps > 0.0, samp, greedy)


def decode_multi(params, token, pos, cache, temps, generator, cfg, n_steps: int,
                 qmeta=None, arch: str = "llama", tp=None):
    """n_steps decode steps; token/pos [B] (pos = the position of `token`),
    temps [B] or None (all greedy). Inactive slots pass pos >= S so their
    cache writes do nothing. Returns (tokens [B, n_steps], cache):
    tokens[:, i] is the token sampled after step i."""
    toks = []
    tok, p = token, pos
    for _ in range(n_steps):
        logits, cache = decode_step(params, tok, p, cache, cfg, qmeta, arch=arch, tp=tp)
        tok = mixed_sample(logits, temps, generator)
        p = p + 1
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def greedy_generate(params, prompt_ids, cache, cfg, n_tokens: int, qmeta=None,
                    temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                    generator=None, arch: str = "llama", tp=None):
    """Prefill a [B, T] prompt, then run n_tokens decode steps. Returns
    (tokens [B, n_tokens], cache); tokens[:, 0] is sampled from the prefill
    logits, as in qtpu."""
    B, T = prompt_ids.shape
    logits, cache = prefill(params, prompt_ids, cache, cfg, qmeta, arch=arch, tp=tp)
    tok = sample_token(logits, generator, temperature, top_k, top_p)
    pos = torch.full((B,), T, dtype=torch.int32, device=prompt_ids.device)
    toks = []
    for _ in range(n_tokens):
        toks.append(tok)
        logits, cache = decode_step(params, tok, pos, cache, cfg, qmeta, arch=arch, tp=tp)
        tok = sample_token(logits, generator, temperature, top_k, top_p)
        pos = pos + 1
    return torch.stack(toks, dim=1), cache
