"""KV-cache storage: bf16 or int8 (port of qtpu/serve/kvcache.py).

Layout as in qtpu: k/v [L, B, KV, S, hd] (one head's sequence is a
contiguous [S, hd] tile), and in int8 mode one f32 scale per (layer,
sequence, kv-head, position), [L, B, KV, S]. The per-layer layout
(`init_cache(per_layer=True)`, qtpu's long-context format) keeps k/v as
tuples of L [B, KV, S, hd] tensors and the scales as tuples of L
[B, KV, S]; its int8 decode runs K12 when S % 2048 == 0. The port updates
the cache IN PLACE (qtpu's functional updates return new arrays);
`forward_with_cache` returns the same object it was given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: object  # [L, B, KV, S, hd] bf16 or int8, or a tuple of L [B, KV, S, hd]
    v: object
    k_scale: object | None  # [L, B, KV, S] f32 (int8 mode), or a tuple of L [B, KV, S]
    v_scale: object | None
    length: torch.Tensor  # [B] int32, tokens filled per sequence

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def per_layer(self) -> bool:
        return isinstance(self.k, (tuple, list))

    @property
    def num_layers(self) -> int:
        return len(self.k) if self.per_layer else self.k.shape[0]

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] if self.per_layer else self.k.shape[3]

    def layer(self, l: int, slots=None):
        """(k, v, k_scale, v_scale) of layer l: views, or with `slots` [B]
        a copy of those sequence rows."""
        def sel(c):
            if c is None:
                return None
            return c[l] if slots is None else c[l][slots]
        return sel(self.k), sel(self.v), sel(self.k_scale), sel(self.v_scale)

    def stacked(self, l: int):
        """(k, v, k_scale, v_scale, layer index) in the stacked form the
        kernels of a stacked cache take: the cache itself and l, or for the
        per-layer layout layer l's buffers as zero-copy [1, ...] views and
        index 0."""
        if not self.per_layer:
            return self.k, self.v, self.k_scale, self.v_scale, l
        one = [None if c is None else c.unsqueeze(0) for c in self.layer(l)]
        return (*one, 0)


def init_cache(
    cfg, batch: int, max_len: int, dtype=torch.bfloat16, quantized: bool = False,
    device="cuda", per_layer: bool = False,
) -> KVCache:
    """Zeroed cache; max_len is rounded up to a multiple of 8 (as in qtpu).
    per_layer: k/v (and scales) as tuples of L per-layer tensors."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    max_len = max_len + (-max_len) % 8
    shape = (batch, KV, max_len, hd)

    def alloc(shp, dt):
        if per_layer:
            return tuple(torch.zeros(shp, dtype=dt, device=device) for _ in range(L))
        return torch.zeros((L, *shp), dtype=dt, device=device)

    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quantized:
        return KVCache(
            k=alloc(shape, torch.int8),
            v=alloc(shape, torch.int8),
            k_scale=alloc(shape[:-1], torch.float32),
            v_scale=alloc(shape[:-1], torch.float32),
            length=length,
        )
    return KVCache(k=alloc(shape, dtype), v=alloc(shape, dtype), k_scale=None, v_scale=None,
                   length=length)


def quantize_kv(x: torch.Tensor):
    """[..., hd] -> (int8 values, f32 scale over the trailing head dim)."""
    xf = x.float()
    # a true division, on every device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which moves some scales by an ulp
    # from the CPU's (and the kernels') absmax / 127; the divisor is filled
    # on the device, so no host copy waits
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def cache_layer_write(cache: KVCache, l: int, new_k, new_v, start, slots=None) -> None:
    """Write new keys/values [B, T, KV, hd] into layer l of the cache, in
    place, at per-sequence positions `start` [B], into cache rows `slots`
    [B] (default: row b of the batch is row b of the cache). Rows whose
    start lies outside the cache write nothing (T = 1: start outside
    [0, S); T > 1: start >= S, and a start that would run past the end is
    moved back to S - T, as qtpu's dynamic_update_slice clamps it).

    Inactive rows write back what their clamped positions already hold, so
    the call never reads the mask on the host (no device synchronization)."""
    if cache.quantized:
        write_k, sk = quantize_kv(new_k)  # [B, T, KV, hd], [B, T, KV]
        write_v, sv = quantize_kv(new_v)
        pairs = ((cache.k, write_k), (cache.v, write_v),
                 (cache.k_scale, sk), (cache.v_scale, sv))
    else:
        dt = cache.k[l].dtype  # a stacked tensor's or layer l's own buffer's
        pairs = ((cache.k, new_k.to(dt)), (cache.v, new_v.to(dt)))
    B, T = new_k.shape[:2]
    S = cache.max_len
    start = start.to(torch.int64)
    active = start < S
    if T == 1:
        active &= start >= 0
    s_eff = torch.clamp(start, 0, max(S - T, 0))
    idx = s_eff[:, None] + torch.arange(T, device=start.device)[None, :]  # [B, T]
    rows = torch.arange(B, device=start.device) if slots is None else slots.to(torch.int64)
    r2 = rows[:, None]
    for store, new in pairs:
        layer = store[l]
        old = layer[r2, :, idx]  # [B, T, KV(, hd)]
        keep = active.view(B, *([1] * (new.dim() - 1)))
        layer[r2, :, idx] = torch.where(keep, new, old)
