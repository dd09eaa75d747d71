#!/usr/bin/env python3
"""Which pieces of a tensor-parallel TinyLlama W8A8 step give other bits
than the one-rank step, on the card, one process (no collectives): each
piece at TinyLlama-1.1B's shapes is run whole and as the two halves TP 2
gives a rank (heads, KV heads, columns or K rows), the halves put back
together, and the share of bf16 outputs that differ is printed.

  * prefill attention (the plain `cached_attention` over the int8 cache,
    8 x 128 rows) on 32 heads against 2 x 16 (KV 4 against 2 x 2);
  * decode attention (K3) on 32 heads against 2 x 16;
  * a column-parallel W8A8 site (K6, N 2048 against 2 x 1024), M 8 and 1024;
  * a row-parallel W8A8 site (K6, K 2048 against 2 x 1024: the absmax
    all-reduced, the absmax-in mode's int32 sums added, then the epilogue),
    M 8 and 1024.

    python3 tools/exp_tp_w8a8.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _differ(a, b) -> float:
    return float((a.float() != b.float()).float().mean())


def main() -> None:
    import torch

    from qtpu_torch.core.packing import quantize_pack
    from qtpu_torch.kernels import int8_matmul as k6
    from qtpu_torch.kernels.kv_attention import (cache_band_write, cache_mask,
                                                 cached_attention, decode_attention)
    from qtpu_torch.serve.kvcache import cache_layer_write, init_cache
    from qtpu_torch.models.config import TINYLLAMA_1_1B as cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    out = {"card": torch.cuda.get_device_name(0)}
    B, T, H, KV, hd = 8, 128, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    # prefill attention on the int8 cache
    one = cfg.replace(num_layers=1)
    q, k, v = rnd(B, T, H, hd), rnd(B, T, KV, hd), rnd(B, T, KV, hd)
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    mask = cache_mask(pos, T + 48, 0)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    caches = {}
    for name, (h0, h1, v0, v1) in {"whole": (0, H, 0, KV), "r0": (0, H // 2, 0, KV // 2),
                                   "r1": (H // 2, H, KV // 2, KV)}.items():
        c = init_cache(one.replace(num_heads=h1 - h0, num_kv_heads=v1 - v0), B, T + 48,
                       quantized=True, device=dev)
        cache_layer_write(c, 0, k[:, :, v0:v1].contiguous(), v[:, :, v0:v1].contiguous(),
                          start, None)
        caches[name] = (c, cached_attention(q[:, :, h0:h1], c.layer(0, None), mask))
    whole = caches["whole"][1]
    halves = torch.cat([caches["r0"][1], caches["r1"][1]], dim=-1)
    out["prefill_attention_differ"] = _differ(whole, halves)
    # decode attention (K3) at position T on the same caches
    q1, k1, v1_ = rnd(B, H, hd), rnd(B, 1, KV, hd), rnd(B, 1, KV, hd)
    p = torch.full((B,), T, dtype=torch.int32, device=dev)
    dec = {}
    for name, (h0, h1, v0, v1) in {"whole": (0, H, 0, KV), "r0": (0, H // 2, 0, KV // 2),
                                   "r1": (H // 2, H, KV // 2, KV)}.items():
        c = caches[name][0]
        cache_band_write(k1[:, :, v0:v1].contiguous(), v1_[:, :, v0:v1].contiguous(), c.k, c.v,
                         c.k_scale, c.v_scale, p, 0)
        dec[name] = decode_attention(q1[:, h0:h1].contiguous(), c.k, c.v, c.k_scale,
                                     c.v_scale, p, 0)
    out["decode_attention_differ"] = _differ(dec["whole"],
                                             torch.cat([dec["r0"], dec["r1"]], dim=1))
    # W8A8 sites
    K, N = 2048, 2048
    qt = quantize_pack(torch.randn(K, N, generator=g, device=dev) * 0.02, 8, K)
    for M in (8, 1024):
        x = rnd(M, K, scale=2.0)
        full = k6.w8a8_matmul(x, qt.data, qt.scales, qt.zeros, (8, K, K, N))
        cols = torch.cat([k6.w8a8_matmul(x, qt.data[:, a:a + N // 2].contiguous(),
                                         qt.scales[:, a:a + N // 2].contiguous(),
                                         qt.zeros[:, a:a + N // 2].contiguous(),
                                         (8, K, K, N // 2)) for a in (0, N // 2)], dim=-1)
        out[f"column_site_m{M}_differ"] = _differ(full, cols)
        amax = torch.maximum(*(k6.w8a8_absmax(x[:, a:a + K // 2].contiguous())
                               for a in (0, K // 2)))
        parts = [k6.w8a8_matmul(x[:, a:a + K // 2].contiguous(), qt.data[a:a + K // 2],
                                qt.scales, qt.zeros, (8, K // 2, K // 2, N), absmax=amax)
                 for a in (0, K // 2)]
        out[f"row_site_m{M}_differ"] = _differ(
            full, k6.w8a8_epilogue(parts[0] + parts[1], amax, qt.scales))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
