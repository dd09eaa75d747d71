"""K2, K3, K8, K11 and K12: the decode step's KV-cache kernels
(csrc/kv_attention.cu, csrc/kv_flash_decode.cu).

`cache_band_write` replaces pallas_cache_band_write_stacked and
`decode_attention` replaces pallas_decode_attention_stacked
(qtpu/kernels/pallas_kv_attention.py:1067, :1147), on the int8 cache
([L, B, KV, S, hd] int8, [L, B, KV, S] f32 scales). K2 is launched with
programmatic dependent launch (its launch overlaps the tail of the kernel
before it, which must not write pos); `cache_band_write_serial` launches
the same kernel without it and `cache_band_write_simt` the earlier kernel,
for chip_smoke.py's comparison.
`decode_attention_layer` replaces pallas_decode_attention (:404): K3's
kernel on one layer [B, KV, S, hd] of a cache, through a zero-copy [1, ...]
view.
`decode_attention_write_bf16` replaces pallas_decode_attention_write_bf16
(:262): on the bf16 cache, the row write and the attention in one launch.
`decode_attention_write` replaces pallas_decode_attention_write (:313): the
same on the int8 cache, the new rows quantized with K2's rounding.
Each of those takes the FULL stacked cache and a layer index and works on
the view of that layer: writes are in place.
K12 (split-S flash decoding) computes one function behind three entries:
`decode_attention_flash` (pallas_decode_attention_flash, :804, a per-layer
buffer with S % 2048 == 0), `decode_attention_write_banded` (:554, any S)
and `decode_attention_write_banded_stacked` (:907, one layer of a stacked
cache): attention over the cache rows strictly before pos plus a column for
the UNQUANTIZED new token, then the quantized new rows written at pos.
A CUDA tensor launches the kernel; a CPU tensor takes the plain version,
which is the math of qtpu's XLA path (`cache_layer_write` at T = 1 and
`_cached_attention`) or, for K12, the same function in f32 (`flash_decode_plain`).
K3's kernel (K3, K8, K11, the one-layer entry) splits each (sequence,
kv-head) over a thread-block cluster of `decode_cluster` blocks, each taking
its slice of `decode_slices`; it and K12's split body run the shared core of
csrc/kv_decode_core.cuh (mma.sync over int8 chunks in a cp.async ring). The
`*_simt` entries run the earlier bodies on the same arguments, for
chip_smoke.py's "was" times: card tensors only, counted in their own
`.launches`; no model path calls them.
The head dims each kernel takes are `decode_supported` (K3's kernel: a
multiple of 8 from 8 to 256, any number of q heads a kv head) and
`flash_supported` (K12: the same), the checks its entries make: every shape
qtpu hands a Pallas kernel (its K2 stops at 256). A model's route asks them
before the call and runs the plain version only on card tensors outside
that (hd % 8 != 0, hd > 256). A block of the shared core takes at most
32 q heads (`BLOCK_HEADS`); more are split over head groups on a grid axis
(`head_groups`), each group reading the same rows.
The `_simt` bodies keep their narrow domains (K3's: hd % 16 == 0, hd <= 128,
G <= 32; K12's: SIMT_FLASH_HEAD_DIMS): no default route runs them.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require
from qtpu_torch.kernels.dequant_matmul import _sm_count
from qtpu_torch.serve.kvcache import KVCache, cache_layer_write, dequantize_kv

_SIG = {
    "qtpu_kv_band_write": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "qtpu_kv_band_write_simt": [P, P, P, P, P, P, P, I, I, I, I, P],
    "qtpu_decode_attention": [P] * 7 + [I] * 7 + [P],
    "qtpu_decode_attention_write_bf16": [P] * 7 + [I] * 7 + [P],
    "qtpu_decode_attention_write": [P] * 9 + [I] * 7 + [P],
    "qtpu_decode_attention_simt": [P] * 7 + [I] * 6 + [P],
    "qtpu_decode_attention_write_bf16_simt": [P] * 7 + [I] * 6 + [P],
    "qtpu_decode_attention_write_simt": [P] * 9 + [I] * 6 + [P],
}
_FLASH_SIG = {"qtpu_flash_decode": [P] * 10 + [I] * 7 + [P],
              "qtpu_flash_decode_simt": [P] * 10 + [I] * 7 + [P],
              "qtpu_flash_split_blocks_per_sm": [I]}
FLASH_SBLK = 2048  # the S granule of qtpu's flash entry (its 2048-row blocks)
DECODE_CHUNK = 64  # cache rows of a chunk of the shared core (kvd::kRows)
MAX_CLUSTER = 8  # the portable thread-block cluster size


HEAD_DIMS = tuple(range(8, 264, 8))  # the instances of K3's kernel and of K12 (QTPU_HEAD_DIMS)
HEAD_DIM_RULE = "a multiple of 8, 8 <= hd <= 256"
SIMT_FLASH_HEAD_DIMS = (32, 64, 128)  # K12's earlier split body (its lanes own hd / 32 dims)


def decode_supported(hd: int, group: int) -> bool:
    """Whether K3's kernel (K3, K8, K11, the one-layer entry) takes head dim
    hd with `group` q heads a kv head (the checks of `_k3`, `_check_decode`)."""
    return hd in HEAD_DIMS and group > 0


def flash_supported(hd: int) -> bool:
    """Whether K12 takes head dim hd (the check of `_flash`)."""
    return hd in HEAD_DIMS


def simt_supported(hd: int, group: int) -> bool:
    """Whether K3's earlier body (the `_simt` entries of K3, K8, K11) takes
    the shape: hd % 16 == 0, hd <= 128, at most 32 q heads a kv head."""
    return hd % 16 == 0 and 0 < hd <= 128 and 0 < group <= 32


BLOCK_HEADS = 32  # q heads one block of the shared decode core takes (kvd::kMaxG)


def head_groups(group: int) -> tuple:
    """(blocks, heads a block) K3's kernel and K12's split body split the
    `group` q heads of a kv head over (kvd::head_groups, group_heads): as
    few blocks as BLOCK_HEADS allows, the heads spread evenly, the last
    block holding the rest."""
    n = -(-group // BLOCK_HEADS)
    return n, -(-group // n)


def decode_cluster(sm_count: int, B: int, KV: int, S: int) -> int:
    """Blocks of one (sequence, kv-head) in K3's kernel, one cluster: as many
    as let B * KV * cluster blocks each have an SM of its own (sm_count of
    them), at most 8 (the portable cluster size) and at most one per 64-row
    chunk of S; at least 1. The kernel takes it as given."""
    return max(1, min(MAX_CLUSTER, sm_count // (B * KV), -(-S // DECODE_CHUNK)))


def decode_slices(p: int, S: int, window: int, cluster: int) -> list:
    """The rows [beg, end) each block of a cluster reads for a sequence at
    pos p (csrc/kv_attention.cu: kvd_slice): the rows s <= min(p, S - 1)
    (an inactive slot, p >= S, reads [0, S)), and s > p - window when
    window > 0, cut into `cluster` slices of whole chunks but the last, in
    rank order; a slice may be empty (beg == end)."""
    hi = min(p, S - 1)
    lo = max(0, p - window + 1) if window > 0 else 0
    n = max(0, hi - lo + 1)
    per = -(-n // cluster)  # rows a block, rounded up to whole chunks
    per = -(-per // DECODE_CHUNK) * DECODE_CHUNK
    out = []
    for rank in range(cluster):
        beg = lo + rank * per
        out.append((beg, max(beg, min(hi + 1, beg + per))))
    return out


def _launched(rc: int, what: str, cluster: int) -> None:
    if rc == -2:
        raise RuntimeError(f"{what}: no cluster of {cluster} blocks fits on the card")
    _build.check(rc, what)


def cached_attention(q, layer_kv, mask):
    """q [B, T, H, hd] against one cache layer (k/v [B, KV, S, hd], bf16, or
    int8 with [B, KV, S] scales); mask [B, T, S] True = attend. Returns
    [B, T, H*hd]. The plain math of qtpu.models.llama._cached_attention:
    dequantize, repeat the kv heads, f32 scores, -1e30 mask, softmax in f32,
    probabilities cast to the activation dtype."""
    k_c, v_c, ks_c, vs_c = layer_kv
    B, T, H, hd = q.shape
    KV = k_c.shape[1]
    if ks_c is not None:
        K = dequantize_kv(k_c, ks_c, q.dtype)
        V = dequantize_kv(v_c, vs_c, q.dtype)
    else:
        K, V = k_c, v_c
    if KV != H:
        K = K.repeat_interleave(H // KV, dim=1)
        V = V.repeat_interleave(H // KV, dim=1)
    scores = torch.einsum("bqhd,bhkd->bhqk", q.float(), K.float()) / math.sqrt(hd)
    scores.masked_fill_(~mask[:, None], -1e30)  # in place: [B, H, T, S] f32 is the largest buffer
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.float(), V.float()).to(q.dtype)
    return out.reshape(B, T, H * hd).contiguous()


def cache_mask(positions, S, window=0):
    """[B, T, S] mask of queries at positions [B, T] over a cache of S rows:
    key s <= position, and s > position - window when window > 0."""
    kpos = torch.arange(S, device=positions.device)
    mask = kpos[None, None, :] <= positions[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > positions[:, :, None] - window
    return mask


def _write_rows(k_new, v_new, k_c, v_c, ks_c, vs_c, pos):
    """The new rows [B, 1, KV, hd] quantized with K2's rounding and written
    in place into one layer [B, KV, S, hd] at pos [B]; rows with pos outside
    [0, S) keep what they hold (`cache_layer_write` on a one-layer cache)."""
    one = KVCache(k=(k_c,), v=(v_c,), k_scale=(ks_c,), v_scale=(vs_c,), length=None)
    cache_layer_write(one, 0, k_new, v_new, pos)


def cache_band_write_plain(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    cache = KVCache(k=k_all, v=v_all, k_scale=ks_all, v_scale=vs_all, length=None)
    cache_layer_write(cache, layer, k_new, v_new, pos)


def decode_attention_plain(q, k_all, v_all, ks_all, vs_all, pos, layer, window=0):
    layer_kv = (k_all[layer], v_all[layer], ks_all[layer], vs_all[layer])
    mask = cache_mask(pos[:, None], k_all.shape[3], window)
    B, H, hd = q.shape
    return cached_attention(q[:, None], layer_kv, mask).reshape(B, H, hd)


def _check_cache(k_all, v_all, ks_all, vs_all, pos, device):
    L, B, KV, S, hd = k_all.shape
    require(k_all.dtype == torch.int8 and v_all.dtype == torch.int8, "cache must be int8")
    require(tuple(v_all.shape) == (L, B, KV, S, hd), "k/v cache shapes differ")
    for s in (ks_all, vs_all):
        require(s.dtype == torch.float32 and tuple(s.shape) == (L, B, KV, S),
                "cache scales must be f32 [L, B, KV, S]")
    require(pos.dtype == torch.int32 and tuple(pos.shape) == (B,), "pos must be int32 [B]")
    for t in (k_all, v_all, ks_all, vs_all, pos):
        require(t.device == device, f"cache tensors must lie on {device}")
        require(t.is_contiguous(), "cache tensors must be contiguous")


def _check_aligned(k, v):
    """The decode attention core copies cache rows in 16-byte pieces (8-byte
    ones where an int8 row is hd % 16 == 8 bytes): 16-byte aligned k / v."""
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
            "k/v cache must be 16-byte aligned")


def _band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, launch: str):
    """One launch of K2 on card tensors: launch "pdl" (the kernel with
    programmatic dependent launch), "serial" (the same kernel, a plain
    launch) or "simt" (the earlier kernel)."""
    require(k_new.is_cuda, f"unsupported device {k_new.device}")
    L, B, KV, S, hd = k_all.shape
    for t in (k_new, v_new):
        require(t.dtype == torch.bfloat16 and tuple(t.shape) == (B, 1, KV, hd),
                "new k/v must be bf16 [B, 1, KV, hd]")
        require(t.is_contiguous() and t.device == k_new.device, "new k/v must be contiguous")
    _check_cache(k_all, v_all, ks_all, vs_all, pos, k_new.device)
    require(0 <= layer < L, f"layer {layer} out of range")
    args = [k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(), v_all[layer].data_ptr(),
            ks_all[layer].data_ptr(), vs_all[layer].data_ptr(), pos.data_ptr(), B, KV, S, hd]
    lib = _build.load("kv_attention", _SIG)
    if launch == "simt":
        rc = lib.qtpu_kv_band_write_simt(*args, _build.stream_of(k_new))
    else:
        require(hd % 8 == 0 and hd <= 256, f"head_dim {hd} must be a multiple of 8, <= 256")
        require(k_new.data_ptr() % 16 == 0 and v_new.data_ptr() % 16 == 0,
                "new k/v must be 16-byte aligned")
        require(args[2] % 4 == 0 and args[3] % 4 == 0, "k/v cache must be 4-byte aligned")
        rc = lib.qtpu_kv_band_write(*args, int(launch == "pdl"), _build.stream_of(k_new))
    _build.check(rc, "cache_band_write")


def cache_band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    """Quantize this step's k/v rows [B, 1, KV, hd] to int8 and write them in
    place into layer `layer` of the stacked cache at `pos` [B]; rows with
    pos outside [0, S) write nothing. On the card pos must not be written by
    the kernel launched just before (programmatic dependent launch)."""
    if k_new.device.type == "cpu":
        return cache_band_write_plain(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer)
    _band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, "pdl")
    cache_band_write.launches += 1


def cache_band_write_serial(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    """cache_band_write's kernel launched without programmatic dependent
    launch, for chip_smoke.py's comparison of the two launches. Card
    tensors only; counted in its own `.launches`."""
    _band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, "serial")
    cache_band_write_serial.launches += 1


def cache_band_write_simt(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    """cache_band_write on the earlier kernel (a plain launch, scalar loads
    and stores), for chip_smoke.py's "was" time. Card tensors only; counted
    in its own `.launches`."""
    _band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, "simt")
    cache_band_write_simt.launches += 1


def _cluster_of(q, B, KV, S, simt):
    """The cluster argument of K3's kernel (none for the earlier body)."""
    return [] if simt else [decode_cluster(_sm_count(q.device.index or 0), B, KV, S)]


def _k3(q, k_all, v_all, ks_all, vs_all, pos, layer, window, simt=False):
    L, B, KV, S, hd = k_all.shape
    H = q.shape[1]
    require(q.dtype == torch.bfloat16 and q.dim() == 3 and q.shape[0] == B
            and q.shape[2] == hd and q.is_contiguous(), "q must be contiguous bf16 [B, H, hd]")
    require(H % KV == 0, f"H={H} must be a multiple of KV={KV}")
    require(decode_supported(hd, H // KV), f"head_dim {hd} must be {HEAD_DIM_RULE}")
    require(not simt or simt_supported(hd, H // KV),
            f"the earlier body takes hd % 16 == 0 <= 128 and G <= 32, not hd {hd}, G {H // KV}")
    _check_cache(k_all, v_all, ks_all, vs_all, pos, q.device)
    _check_aligned(k_all, v_all)
    require(0 <= layer < L, f"layer {layer} out of range")
    out = torch.empty_like(q)
    lib = _build.load("kv_attention", _SIG)
    cl = _cluster_of(q, B, KV, S, simt)
    fn = lib.qtpu_decode_attention_simt if simt else lib.qtpu_decode_attention
    rc = fn(
        q.data_ptr(), k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr(), vs_all[layer].data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, KV, H // KV, S, hd, int(window), *cl, _build.stream_of(q),
    )
    _launched(rc, "decode_attention", *cl or [1])
    return out


def decode_attention(q, k_all, v_all, ks_all, vs_all, pos, layer, window=0):
    """GQA decode attention of q [B, H, hd] over layer `layer` of the int8
    stacked cache, causal by pos [B] with an optional sliding window.
    Returns [B, H, hd] bf16."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, ks_all, vs_all, pos, layer, window)
    require(q.is_cuda, f"unsupported device {q.device}")
    out = _k3(q, k_all, v_all, ks_all, vs_all, pos, layer, window)
    decode_attention.launches += 1
    return out


def decode_attention_layer(q, k_c, v_c, ks_c, vs_c, pos, window=0):
    """pallas_decode_attention's function: read-only GQA decode attention
    of q [B, H, hd] over one layer of the int8 cache (k/v [B, KV, S, hd],
    scales [B, KV, S]), keys s <= pos [B], and s > pos - window when
    window > 0. K3's kernel on [1, ...] views of the layer (no copy).
    Returns [B, H, hd] bf16."""
    one = [t.unsqueeze(0) for t in (k_c, v_c, ks_c, vs_c)]
    if q.device.type == "cpu":
        return decode_attention_plain(q, *one, pos, 0, window)
    require(q.is_cuda, f"unsupported device {q.device}")
    out = _k3(q, *one, pos, 0, window)
    decode_attention_layer.launches += 1
    return out


def decode_attention_simt(q, k_all, v_all, ks_all, vs_all, pos, layer, window=0):
    """decode_attention on K3's earlier body (card tensors only)."""
    require(q.is_cuda, f"unsupported device {q.device}")
    out = _k3(q, k_all, v_all, ks_all, vs_all, pos, layer, window, simt=True)
    decode_attention_simt.launches += 1
    return out


def _write_attend_plain(q, k_new, v_new, cache, layer, pos, window):
    cache_layer_write(cache, layer, k_new, v_new, pos)
    mask = cache_mask(pos[:, None], cache.max_len, window)
    B, H, hd = q.shape
    return cached_attention(q[:, None], cache.layer(layer), mask).reshape(B, H, hd)


def decode_attention_write_bf16_plain(q, k_new, v_new, k_all, v_all, pos, layer, window=0):
    cache = KVCache(k=k_all, v=v_all, k_scale=None, v_scale=None, length=None)
    return _write_attend_plain(q, k_new, v_new, cache, layer, pos, window)


def _check_decode(q, k_new, v_new, k_all, pos, layer, simt=False):
    """Shape, type and device checks of the decode write + attention
    kernels (K8, K11, K12) on everything but the cache's dtype; simt: K3's
    earlier body's narrower domain. Returns (L, B, KV, S, hd, H)."""
    require(q.is_cuda, f"unsupported device {q.device}")
    L, B, KV, S, hd = k_all.shape
    H = q.shape[1]
    require(q.dtype == torch.bfloat16 and q.dim() == 3 and q.shape[0] == B
            and q.shape[2] == hd and q.is_contiguous(), "q must be contiguous bf16 [B, H, hd]")
    require(H % KV == 0, f"H={H} must be a multiple of KV={KV}")
    require(decode_supported(hd, H // KV), f"head_dim {hd} must be {HEAD_DIM_RULE}")
    require(not simt or simt_supported(hd, H // KV),
            f"the earlier body takes hd % 16 == 0 <= 128 and G <= 32, not hd {hd}, G {H // KV}")
    require(0 <= layer < L, f"layer {layer} out of range")
    for t in (k_new, v_new):
        require(t.dtype == torch.bfloat16 and tuple(t.shape) == (B, 1, KV, hd),
                "new k/v must be bf16 [B, 1, KV, hd]")
        require(t.data_ptr() % 16 == 0, "new k/v must be 16-byte aligned")
        require(t.device == q.device and t.is_contiguous(), "new k/v must be contiguous")
    require(pos.dtype == torch.int32 and tuple(pos.shape) == (B,), "pos must be int32 [B]")
    return L, B, KV, S, hd, H


def decode_attention_write_bf16(q, k_new, v_new, k_all, v_all, pos, layer, window=0):
    """Write this step's k/v rows [B, 1, KV, hd] in place into layer `layer`
    of the stacked bf16 cache at pos [B] (rows with pos outside [0, S)
    write nothing), then GQA decode attention of q [B, H, hd] over that
    layer, causal by pos with an optional sliding window. Returns
    [B, H, hd] bf16."""
    if q.device.type == "cpu":
        return decode_attention_write_bf16_plain(q, k_new, v_new, k_all, v_all, pos, layer,
                                                 window)
    out = _k8(q, k_new, v_new, k_all, v_all, pos, layer, window)
    decode_attention_write_bf16.launches += 1
    return out


def _k8(q, k_new, v_new, k_all, v_all, pos, layer, window, simt=False):
    L, B, KV, S, hd, H = _check_decode(q, k_new, v_new, k_all, pos, layer, simt)
    for t in (k_all, v_all):
        require(t.dtype == torch.bfloat16 and tuple(t.shape) == (L, B, KV, S, hd),
                "cache must be bf16 [L, B, KV, S, hd]")
    for t in (k_all, v_all, pos):
        require(t.device == q.device, f"cache tensors must lie on {q.device}")
        require(t.is_contiguous(), "cache tensors must be contiguous")
    _check_aligned(k_all, v_all)
    out = torch.empty_like(q)
    lib = _build.load("kv_attention", _SIG)
    cl = _cluster_of(q, B, KV, S, simt)
    fn = (lib.qtpu_decode_attention_write_bf16_simt if simt
          else lib.qtpu_decode_attention_write_bf16)
    rc = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(),
        v_all[layer].data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, KV, H // KV, S, hd, int(window), *cl, _build.stream_of(q),
    )
    _launched(rc, "decode_attention_write_bf16", *cl or [1])
    return out


def decode_attention_write_bf16_simt(q, k_new, v_new, k_all, v_all, pos, layer, window=0):
    """decode_attention_write_bf16 on K8's earlier body (card tensors only)."""
    out = _k8(q, k_new, v_new, k_all, v_all, pos, layer, window, simt=True)
    decode_attention_write_bf16_simt.launches += 1
    return out


def decode_attention_write_plain(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer,
                                 window=0):
    cache = KVCache(k=k_all, v=v_all, k_scale=ks_all, v_scale=vs_all, length=None)
    return _write_attend_plain(q, k_new, v_new, cache, layer, pos, window)


def decode_attention_write(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer,
                           window=0):
    """Quantize this step's k/v rows [B, 1, KV, hd] to int8 (K2's rounding,
    `quantize_kv`) and write codes and scales in place into layer `layer` of
    the stacked int8 cache at pos [B] (rows with pos outside [0, S) write
    nothing), then GQA decode attention of q [B, H, hd] over that layer,
    causal by pos with an optional sliding window. Returns [B, H, hd] bf16."""
    if q.device.type == "cpu":
        return decode_attention_write_plain(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos,
                                            layer, window)
    out = _k11(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, window)
    decode_attention_write.launches += 1
    return out


def _k11(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, window, simt=False):
    _check_decode(q, k_new, v_new, k_all, pos, layer, simt)
    _check_cache(k_all, v_all, ks_all, vs_all, pos, q.device)
    _check_aligned(k_all, v_all)
    out = torch.empty_like(q)
    L, B, KV, S, hd = k_all.shape
    lib = _build.load("kv_attention", _SIG)
    cl = _cluster_of(q, B, KV, S, simt)
    fn = lib.qtpu_decode_attention_write_simt if simt else lib.qtpu_decode_attention_write
    rc = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(),
        v_all[layer].data_ptr(), ks_all[layer].data_ptr(), vs_all[layer].data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, KV, q.shape[1] // KV, S, hd, int(window), *cl,
        _build.stream_of(q),
    )
    _launched(rc, "decode_attention_write", *cl or [1])
    return out


def decode_attention_write_simt(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer,
                                window=0):
    """decode_attention_write on K11's earlier body (card tensors only)."""
    out = _k11(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer, window, simt=True)
    decode_attention_write_simt.launches += 1
    return out


def flash_decode_plain(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window=0):
    """K12's function in plain torch, f32 throughout: q [B, H, hd] over one
    int8 layer (k/v [B, KV, S, hd], scales [B, KV, S]), keys s < pos [B]
    (and s > pos - window when window > 0), plus one column for the new
    token, q . k_new / sqrt(hd) with value v_new ([B, 1, KV, hd] bf16), when
    pos < S; a row with no key at all gives zeros. Then the new rows are
    written at pos (`_write_rows`). Returns [B, H, hd] bf16."""
    B, H, hd = q.shape
    KV, S = k_c.shape[1], k_c.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, G, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k_c.float() * ks_c[..., None]) * scale
    p = pos.to(torch.int64)
    s_idx = torch.arange(S, device=q.device)
    keep = s_idx[None, :] < p[:, None]
    if window > 0:
        keep &= s_idx[None, :] > p[:, None] - window
    scores = scores.masked_fill(~keep[:, None, None, :], float("-inf"))
    s_new = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, 0].float()) * scale
    s_new = s_new.masked_fill(~(p < S)[:, None, None], float("-inf"))
    mx = torch.maximum(scores.amax(dim=-1), s_new)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(scores - mx[..., None])
    e_new = torch.exp(s_new - mx)
    den = e.sum(dim=-1) + e_new
    acc = torch.einsum("bkgs,bksd->bkgd", e, v_c.float() * vs_c[..., None])
    acc = acc + e_new[..., None] * v_new[:, 0].float()[:, :, None, :]
    out = torch.where(den[..., None] > 0, acc / den[..., None], torch.zeros_like(acc))
    _write_rows(k_new, v_new, k_c, v_c, ks_c, vs_c, pos)
    return out.reshape(B, H, hd).to(q.dtype)


FLASH_MIN_ROWS = 512  # rows of a K12 slice at least: 8 chunks of the shared core


def flash_splits(sm_count: int, blocks_per_sm: int, B: int, KV: int, rows: int) -> int:
    """Slices per (sequence, kv-head) for K12: at most as many blocks as the
    card runs at once, about four per SM (fewer where fewer fit:
    blocks_per_sm is the split body's occupancy) over the B * KV heads, so no
    second wave and no SM with a block more than another runs late; and each
    slice at least 512 rows, so a block's set-up and merge stay small beside
    its chunks. rows: what a sequence reads, S (or the window when one is
    narrower)."""
    per_sm = min(4, blocks_per_sm)
    return max(1, min(sm_count * per_sm // (B * KV), -(-rows // FLASH_MIN_ROWS)))


@lru_cache(maxsize=None)
def flash_blocks_per_sm(index: int, hd: int) -> int:
    """Blocks of K12's split body an SM of card `index` runs at once at
    head_dim hd."""
    with torch.cuda.device(index):
        n = _build.load("kv_flash_decode", _FLASH_SIG).qtpu_flash_split_blocks_per_sm(hd)
    require(n > 0, f"no block of K12's split body fits an SM at head_dim {hd} ({n})")
    return n


def _flash(entry, q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window, simt=False):
    """K12 on one layer [B, KV, S, hd] of the int8 cache (views of a stacked
    cache included); counts the launch on `entry`; simt: the earlier split
    body."""
    if q.device.type == "cpu" and not simt:
        return flash_decode_plain(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window)
    one = [t.unsqueeze(0) for t in (k_c, v_c, ks_c, vs_c)]
    _check_decode(q, k_new, v_new, one[0], pos, 0)
    _check_cache(*one, pos, q.device)
    _check_aligned(k_c, v_c)
    B, KV, S, hd = k_c.shape
    G = q.shape[1] // KV
    require(flash_supported(hd), f"head_dim {hd} must be {HEAD_DIM_RULE}")
    require(not simt or (hd in SIMT_FLASH_HEAD_DIMS and G <= 32),
            f"the earlier split body takes head_dim {SIMT_FLASH_HEAD_DIMS} and G <= 32, "
            f"not {hd}, G {G}")
    require(window >= 0, "window must be >= 0")
    sms = _sm_count(q.device.index or 0)
    if simt:  # the earlier body's own split: about four blocks an SM, 256 rows a slice
        nsplit = max(1, min(-(-4 * sms // (B * KV)), -(-S // 256)))
    else:
        rows = min(S, window) if window > 0 else S
        nsplit = flash_splits(sms, flash_blocks_per_sm(q.device.index or 0, hd), B, KV, rows)
    part = torch.empty(B * KV * nsplit * G * (hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.load("kv_flash_decode", _FLASH_SIG)
    rc = (lib.qtpu_flash_decode_simt if simt else lib.qtpu_flash_decode)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_c.data_ptr(), v_c.data_ptr(),
        ks_c.data_ptr(), vs_c.data_ptr(), pos.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, KV, G, S, hd, int(window), nsplit, _build.stream_of(q),
    )
    _build.check(rc, "flash_decode")
    entry.launches += 1
    return out


def decode_attention_flash(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window=0):
    """pallas_decode_attention_flash's contract on a per-layer buffer with
    S % 2048 == 0: q [B, H, hd] bf16 attends over the int8 cache rows
    s < pos [B] (window: also s > pos - window) and this step's unquantized
    k_new/v_new [B, 1, KV, hd]; the new rows are quantized and written in
    place at pos (nothing for pos outside [0, S)). Returns [B, H, hd] bf16."""
    if k_c.shape[2] % FLASH_SBLK:
        raise NotImplementedError(f"flash decode needs S % {FLASH_SBLK} == 0")
    return _flash(decode_attention_flash, q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window)


def flash_decode_simt(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window=0):
    """K12 on one layer at any S % 8 == 0, on the earlier split body with its
    own split count, at SIMT_FLASH_HEAD_DIMS (card tensors only)."""
    require(k_c.shape[2] % 8 == 0, "decode attention needs S % 8 == 0")
    return _flash(flash_decode_simt, q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window,
                  simt=True)


def decode_attention_write_banded(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, window=0):
    """pallas_decode_attention_write_banded: decode_attention_flash's
    function at any S % 8 == 0."""
    if k_c.shape[2] % 8:
        raise NotImplementedError("decode attention needs S % 8 == 0")
    return _flash(decode_attention_write_banded, q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos,
                  window)


def decode_attention_write_banded_stacked(q, k_new, v_new, k_all, v_all, ks_all, vs_all, pos,
                                          layer, window=0):
    """pallas_decode_attention_write_banded_stacked: the same on layer
    `layer` of a stacked cache [L, B, KV, S, hd] (written in place; the
    other layers untouched)."""
    if k_all.shape[3] % 8:
        raise NotImplementedError("decode attention needs S % 8 == 0")
    require(0 <= layer < k_all.shape[0], f"layer {layer} out of range")
    return _flash(decode_attention_write_banded_stacked, q, k_new, v_new, k_all[layer],
                  v_all[layer], ks_all[layer], vs_all[layer], pos, window)


cache_band_write.launches = 0
cache_band_write_serial.launches = 0
cache_band_write_simt.launches = 0
decode_attention.launches = 0
decode_attention_layer.launches = 0
decode_attention_flash.launches = 0
decode_attention_write_banded.launches = 0
decode_attention_write_banded_stacked.launches = 0
decode_attention_write_bf16.launches = 0
decode_attention_write.launches = 0
decode_attention_simt.launches = 0
decode_attention_write_bf16_simt.launches = 0
decode_attention_write_simt.launches = 0
flash_decode_simt.launches = 0
