"""Sequence parallelism: ring attention over a `seq` mesh dim (port of
qtpu/sharding/ring_attention.py).

Rank i of n holds the i-th contiguous shard of the sequence: its queries
Q_i and its keys and values K_i, V_i. At ring step t it attends Q_i
against the K/V shard that started on rank (i - t) mod n, keeping the
running (max m, denominator l, accumulator acc) of each query row in f32;
after n steps out = acc / l is exact softmax attention. Within a step the
shard is taken in `chunk`-key blocks (a second online-softmax level,
qtpu's `_chunk_update`), so the live score tile is
[B, KV, G, S_local, chunk]. A shard wholly after the rank's queries
(causality) or wholly before the sliding window is skipped: the ring still
rotates, the work is not done. The K/V rotation is one batch_isend_irecv
around the `seq` group (collectives.ring_shift; qtpu's ppermute). GQA keeps
K/V in their [KV] heads and contracts per group by einsum, as qtpu. Plain
torch, as qtpu's is plain XLA.

`seq_sharded_forward` runs the llama forward on the rank's shard of the
tokens with ring attention as its `attn_impl`; `seq_sharded_nll` the mean
next-token NLL of the whole sequence from it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from qtpu_torch.sharding import collectives as coll

_NEG = -1e30


def _chunk_update(m, l, acc, q5, k_c, v_c, q_pos, k_pos, window: int):
    """One online-softmax update of the running (m, l, acc) with a K/V
    chunk. q5 [B, KV, G, Sq, hd]; k_c / v_c [B, C, KV, hd]; q_pos [Sq], k_pos
    [C] global positions; m / l [B, KV, G, Sq, 1], acc [B, KV, G, Sq, hd] f32.
    The probabilities stay f32 in the P V product (qtpu casts them to v's
    dtype): rounded against each chunk's running max they would add a bf16
    error of their own beside the one the attention kernels make."""
    hd = q5.shape[-1]
    scores = torch.einsum("bkgqd,bckd->bkgqc", q5.float(), k_c.float()) / math.sqrt(hd)
    valid = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgqc,bckd->bkgqd", p, v_c.float())
    return m_new, l, acc


def _pick_chunk(S_local: int, chunk: int | None) -> int:
    """The largest divisor of S_local that is <= the requested chunk (512
    by default)."""
    c = min(S_local, 512 if chunk is None else int(chunk))
    while S_local % c:
        c -= 1
    return c


def ring_attention(q, k, v, group, window: int = 0, chunk: int | None = None):
    """Causal attention with the sequence split over `group`'s ranks.

    q [B, S_local, H, hd], k / v [B, S_local, KV, hd]: this rank's shard
    (rank i holds positions [i·S_local, (i+1)·S_local)). Returns
    [B, S_local, H·hd] in q's dtype."""
    n, idx = coll.size(group), coll.rank(group)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError("H must be a multiple of KV heads")
    G = H // KV
    c = _pick_chunk(Sq, chunk)
    dev = q.device
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    q5 = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)  # [B, KV, G, Sq, hd]
    m = torch.full((B, KV, G, Sq, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    q_last, q_first = (idx + 1) * Sq - 1, idx * Sq
    for t in range(n):
        k0 = ((idx - t) % n) * Sq
        skip = k0 > q_last or (window > 0 and k0 + Sq - 1 <= q_first - window)
        if not skip:
            for c0 in range(0, Sq, c):
                k_pos = k0 + c0 + torch.arange(c, device=dev)
                m, l, acc = _chunk_update(m, l, acc, q5, k_blk[:, c0:c0 + c],
                                          v_blk[:, c0:c0 + c], q_pos, k_pos, window)
        if t < n - 1:  # rotate K/V one rank on (qtpu's last rotation only returns them home)
            k_blk, v_blk = coll.ring_shift([k_blk, v_blk], group)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype).reshape(B, Sq, H * hd)


def _shard(input_ids, group):
    n, idx = coll.size(group), coll.rank(group)
    S = input_ids.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} must divide over seq={n}")
    Sl = S // n
    return input_ids[:, idx * Sl:(idx + 1) * Sl], idx * Sl, S


def seq_sharded_forward(params, input_ids, cfg, group, qmeta=None, chunk: int | None = None):
    """The llama forward of one long sequence with the sequence split over
    `group`: input_ids [B, S] (the whole sequence, on every rank); returns
    this rank's logits [B, S / n, V] f32 (positions [i·S/n, (i+1)·S/n))."""
    from qtpu_torch.models import llama

    if cfg.arch not in ("llama",):
        raise NotImplementedError("seq_sharded_forward runs the llama family")
    ids, offset, S = _shard(input_ids, group)

    def attn(q, k, v, window):
        return ring_attention(q, k, v, group, window=window, chunk=chunk)

    return llama.forward(params, ids, cfg, qmeta=qmeta, attn_impl=attn, pos_offset=offset,
                         seq_len=S)


def seq_sharded_nll(params, input_ids, cfg, group, qmeta=None, chunk: int | None = None):
    """Mean next-token NLL over one long sequence from the seq-sharded
    forward (f32 scalar, the same on every rank): each rank's positions
    scored against the next token, the sums all-reduced over `group`."""
    logits = seq_sharded_forward(params, input_ids, cfg, group, qmeta=qmeta, chunk=chunk)
    B, Sl, V = logits.shape
    _, offset, S = _shard(input_ids, group)
    tgt = input_ids[:, offset + 1:offset + Sl + 1].to(torch.int64)
    take = tgt.shape[1]  # the last rank's last position has no next token
    nll = Fn.cross_entropy(logits[:, :take].reshape(-1, V), tgt.reshape(-1), reduction="sum")
    return coll.all_reduce(nll.float(), group) / (B * (S - 1))
