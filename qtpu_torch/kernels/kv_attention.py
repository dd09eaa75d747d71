"""K2, K3, K8 and K11: the decode step's KV-cache kernels
(csrc/kv_attention.cu).

`cache_band_write` replaces pallas_cache_band_write_stacked and
`decode_attention` replaces pallas_decode_attention_stacked
(qtpu/kernels/pallas_kv_attention.py:1067, :1147), on the int8 cache
([L, B, KV, S, hd] int8, [L, B, KV, S] f32 scales).
`decode_attention_write_bf16` replaces pallas_decode_attention_write_bf16
(:262): on the bf16 cache, the row write and the attention in one launch.
`decode_attention_write` replaces pallas_decode_attention_write (:313): the
same on the int8 cache, the new rows quantized with K2's rounding.
Each takes the FULL stacked cache and a layer index and works on the view
of that layer: writes are in place. A CUDA tensor launches the kernel; a
CPU tensor takes the plain version, which is the math of qtpu's XLA path
(`cache_layer_write` at T = 1 and `_cached_attention`).
"""

from __future__ import annotations

import math

import torch

from qtpu_torch.kernels import _build
from qtpu_torch.kernels._build import I, P, require
from qtpu_torch.serve.kvcache import KVCache, cache_layer_write, dequantize_kv, quantize_kv

_SIG = {
    "qtpu_kv_band_write": [P, P, P, P, P, P, P, I, I, I, I, P],
    "qtpu_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "qtpu_decode_attention_write_bf16": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "qtpu_decode_attention_write": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
}


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
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
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


def cache_band_write_plain(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    S = k_all.shape[3]
    qk, sk = quantize_kv(k_new[:, 0])  # [B, KV, hd], [B, KV]
    qv, sv = quantize_kv(v_new[:, 0])
    rows = torch.nonzero((pos >= 0) & (pos < S)).flatten()
    p = pos[rows].long()
    k_all[layer][rows, :, p] = qk[rows]
    v_all[layer][rows, :, p] = qv[rows]
    ks_all[layer][rows, :, p] = sk[rows]
    vs_all[layer][rows, :, p] = sv[rows]


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


def cache_band_write(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer):
    """Quantize this step's k/v rows [B, 1, KV, hd] to int8 and write them in
    place into layer `layer` of the stacked cache at `pos` [B]; rows with
    pos outside [0, S) write nothing."""
    if k_new.device.type == "cpu":
        return cache_band_write_plain(k_new, v_new, k_all, v_all, ks_all, vs_all, pos, layer)
    require(k_new.is_cuda, f"unsupported device {k_new.device}")
    L, B, KV, S, hd = k_all.shape
    for t in (k_new, v_new):
        require(t.dtype == torch.bfloat16 and tuple(t.shape) == (B, 1, KV, hd),
                "new k/v must be bf16 [B, 1, KV, hd]")
        require(t.is_contiguous() and t.device == k_new.device, "new k/v must be contiguous")
    _check_cache(k_all, v_all, ks_all, vs_all, pos, k_new.device)
    require(0 <= layer < L, f"layer {layer} out of range")
    lib = _build.load("kv_attention", _SIG)
    rc = lib.qtpu_kv_band_write(
        k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr(), vs_all[layer].data_ptr(), pos.data_ptr(),
        B, KV, S, hd, _build.stream_of(k_new),
    )
    _build.check(rc, "cache_band_write")
    cache_band_write.launches += 1


def decode_attention(q, k_all, v_all, ks_all, vs_all, pos, layer, window=0):
    """GQA decode attention of q [B, H, hd] over layer `layer` of the int8
    stacked cache, causal by pos [B] with an optional sliding window.
    Returns [B, H, hd] bf16."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, ks_all, vs_all, pos, layer, window)
    require(q.is_cuda, f"unsupported device {q.device}")
    L, B, KV, S, hd = k_all.shape
    H = q.shape[1]
    require(q.dtype == torch.bfloat16 and q.dim() == 3 and q.shape[0] == B
            and q.shape[2] == hd and q.is_contiguous(), "q must be contiguous bf16 [B, H, hd]")
    require(H % KV == 0 and H // KV <= 32, f"H={H} must be a multiple of KV={KV}, G <= 32")
    require(hd % 32 == 0 and hd <= 128, f"head_dim {hd} must be a multiple of 32, <= 128")
    _check_cache(k_all, v_all, ks_all, vs_all, pos, q.device)
    require(0 <= layer < L, f"layer {layer} out of range")
    out = torch.empty_like(q)
    lib = _build.load("kv_attention", _SIG)
    rc = lib.qtpu_decode_attention(
        q.data_ptr(), k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr(), vs_all[layer].data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, KV, H // KV, S, hd, int(window), _build.stream_of(q),
    )
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


def _write_attend_plain(q, k_new, v_new, cache, layer, pos, window):
    cache_layer_write(cache, layer, k_new, v_new, pos)
    mask = cache_mask(pos[:, None], cache.max_len, window)
    B, H, hd = q.shape
    return cached_attention(q[:, None], cache.layer(layer), mask).reshape(B, H, hd)


def decode_attention_write_bf16_plain(q, k_new, v_new, k_all, v_all, pos, layer, window=0):
    cache = KVCache(k=k_all, v=v_all, k_scale=None, v_scale=None, length=None)
    return _write_attend_plain(q, k_new, v_new, cache, layer, pos, window)


def _check_decode(q, k_new, v_new, k_all, pos, layer):
    """Shape, type and device checks of the decode write + attention
    kernels (K8, K11) on everything but the cache's dtype. Returns
    (L, B, KV, S, hd, H)."""
    require(q.is_cuda, f"unsupported device {q.device}")
    L, B, KV, S, hd = k_all.shape
    H = q.shape[1]
    require(q.dtype == torch.bfloat16 and q.dim() == 3 and q.shape[0] == B
            and q.shape[2] == hd and q.is_contiguous(), "q must be contiguous bf16 [B, H, hd]")
    require(H % KV == 0 and H // KV <= 32, f"H={H} must be a multiple of KV={KV}, G <= 32")
    require(hd % 32 == 0 and hd <= 128, f"head_dim {hd} must be a multiple of 32, <= 128")
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
    L, B, KV, S, hd, H = _check_decode(q, k_new, v_new, k_all, pos, layer)
    for t in (k_all, v_all):
        require(t.dtype == torch.bfloat16 and tuple(t.shape) == (L, B, KV, S, hd),
                "cache must be bf16 [L, B, KV, S, hd]")
    for t in (k_all, v_all, pos):
        require(t.device == q.device, f"cache tensors must lie on {q.device}")
        require(t.is_contiguous(), "cache tensors must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load("kv_attention", _SIG)
    rc = lib.qtpu_decode_attention_write_bf16(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(),
        v_all[layer].data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, KV, H // KV, S, hd, int(window), _build.stream_of(q),
    )
    _build.check(rc, "decode_attention_write_bf16")
    decode_attention_write_bf16.launches += 1
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
    _check_decode(q, k_new, v_new, k_all, pos, layer)
    _check_cache(k_all, v_all, ks_all, vs_all, pos, q.device)
    out = torch.empty_like(q)
    L, B, KV, S, hd = k_all.shape
    lib = _build.load("kv_attention", _SIG)
    rc = lib.qtpu_decode_attention_write(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all[layer].data_ptr(),
        v_all[layer].data_ptr(), ks_all[layer].data_ptr(), vs_all[layer].data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, KV, q.shape[1] // KV, S, hd, int(window),
        _build.stream_of(q),
    )
    _build.check(rc, "decode_attention_write")
    decode_attention_write.launches += 1
    return out


cache_band_write.launches = 0
decode_attention.launches = 0
decode_attention_write_bf16.launches = 0
decode_attention_write.launches = 0
