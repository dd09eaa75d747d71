"""Llama-family decoder (port of qtpu/models/llama.py: init_params,
forward and forward_with_cache).

Param layout as in qtpu, all layers stacked on a leading axis, linears
[in, out]:
  embed [V, D]; layers/attn_norm, layers/mlp_norm [L, D]
  layers/q_proj {"w": [L, D, H*hd]} ... or packed / fused sites
  (qkv_proj, gateup_proj; qtpu_torch.quant.apply)
  final_norm [D]; lm_head {"w": [D, V]}

Both forwards are a Python loop over layers on zero-copy W[l] views.
`forward` (the cacheless full sequence, for perplexity and calibration)
runs per layer K1 on every packed site (K6 on W8A8 sites) and K5 (flash
attention) for the attention; with `capture` it also returns per input
site the channel statistics calibration needs (qtpu's capture modes, taken
explicitly in the loop).
`forward_with_cache` updates the KV cache in place: a decode step (T = 1)
on an int8 cache runs per layer K1 (qkv), RoPE, K2 (cache write), K3
(attention), K1 (o_proj) plus the residual, and K4 (the MLP); on a bf16
cache K8 writes and attends in one launch (`_write_and_attend`, which the
MoE decoder shares and which runs K11 on its int8 cache). On the per-layer
int8 cache (qtpu's unrolled long-context layout) a decode step writes and
attends in `_write_and_attend` too: K12 when S % 2048 == 0, K11 on the
layer's [1, ...] view otherwise, as qtpu dispatches. POT/APOT codebook
sites run K7 in place of K1 (and of K4, which takes affine sites only).
Prefill runs the packed sites' kernels with plain attention and cache write
(in qtpu those are XLA code too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from qtpu_torch.kernels import fused_mlp as _k4
from qtpu_torch.kernels.kv_attention import (
    FLASH_SBLK,
    cache_band_write,
    cache_mask,
    cached_attention,
    decode_attention,
    decode_attention_flash,
    decode_attention_write,
    decode_attention_write_bf16,
)
from qtpu_torch.models.config import ModelConfig
from qtpu_torch.models.ops import apply_rope, causal_attention, linear, rms_norm, rope_tables
from qtpu_torch.serve.kvcache import KVCache, cache_layer_write

LAYER_SITES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
# calibration statistics are collected per input site; q/k/v share one
# input and gate/up another (qtpu/models/llama.py:55-62)
INPUT_SITES = ("attn_in", "o_in", "mlp_in", "down_in", "head_in")
SITE_OF_INPUT = {
    "attn_in": ("q_proj", "k_proj", "v_proj"),
    "o_in": ("o_proj",),
    "mlp_in": ("gate_proj", "up_proj"),
    "down_in": ("down_proj",),
    "head_in": ("lm_head",),
}
CAPTURE_MODES = ("none", "stats", "hessian")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random-normal params (std 0.02), drawn from a torch.Generator on
    `device`, so every layer of every site gets its own weights. On the
    "meta" device only the shapes are made (for size accounting)."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    Q, KV = cfg.q_dim, cfg.kv_dim

    def w(*shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        if meta:
            return t
        for i in range(shape[0]):  # one f32 slab at a time bounds the peak memory
            t[i] = (torch.randn(shape[1:], generator=gen, device=device) * 0.02).to(dtype)
        return t

    params = {
        "embed": w(V, D),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
            "q_proj": {"w": w(L, D, Q)},
            "k_proj": {"w": w(L, D, KV)},
            "v_proj": {"w": w(L, D, KV)},
            "o_proj": {"w": w(L, Q, D)},
            "gate_proj": {"w": w(L, D, F)},
            "up_proj": {"w": w(L, D, F)},
            "down_proj": {"w": w(L, F, D)},
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": {"w": w(D, V)},
    }
    if cfg.attention_bias:  # Qwen2: bias on q/k/v only
        for site, n in (("q_proj", Q), ("k_proj", KV), ("v_proj", KV)):
            params["layers"][site]["b"] = w(L, n)
    return params


def _qkv(h, layers, cfg: ModelConfig, qm, l):
    B, T = h.shape[:2]
    Q, KV = cfg.q_dim, cfg.kv_dim
    if "qkv_proj" in layers:
        qkv = linear(h, layers["qkv_proj"], qm("qkv_proj"), layer=l)
        q, k, v = torch.split(qkv, [Q, KV, KV], dim=-1)
    else:
        q = linear(h, layers["q_proj"], qm("q_proj"), layer=l)
        k = linear(h, layers["k_proj"], qm("k_proj"), layer=l)
        v = linear(h, layers["v_proj"], qm("v_proj"), layer=l)
    return (
        q.reshape(B, T, cfg.num_heads, cfg.head_dim),
        k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
        v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
    )


def _gate_up(h, layers, cfg: ModelConfig, qm, l):
    if "gateup_proj" in layers:
        gu = linear(h, layers["gateup_proj"], qm("gateup_proj"), layer=l)
        F = cfg.intermediate_size
        return gu[..., :F], gu[..., F:]
    return (
        linear(h, layers["gate_proj"], qm("gate_proj"), layer=l),
        linear(h, layers["up_proj"], qm("up_proj"), layer=l),
    )


def _mlp_block(x, layers, l, cfg: ModelConfig, qm, decode: bool, tap=None):
    """norm -> SwiGLU -> residual. A decode step with packed fused
    gateup/down sites that K4 takes runs K4; the rest composes the ops.
    tap(site, tensor), when given, sees the MLP's two linear inputs."""
    gu, dn = layers.get("gateup_proj"), layers.get("down_proj")
    mgu, md = qm("gateup_proj"), qm("down_proj")
    if decode and x.shape[0] * x.shape[1] <= _k4.MAX_M and _k4.supported(mgu, md, gu, dn):
        return _k4.fused_mlp(
            x, layers["mlp_norm"][l],
            gu["data"][l], gu["scales"][l], gu["zeros"][l],
            dn["data"][l], dn["scales"][l], dn["zeros"][l],
            mgu, md, eps=cfg.norm_eps,
        )
    h = rms_norm(x, layers["mlp_norm"][l], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    gate, up = _gate_up(h, layers, cfg, qm, l)
    act = Fn.silu(gate.float()).to(x.dtype) * up
    if tap is not None:
        tap("down_in", act)
    return x + linear(act, layers["down_proj"], qm("down_proj"), layer=l)


def _channel_stats(x: torch.Tensor, capture: str) -> dict:
    """mean|x| and max|x| per trailing channel in f32 (qtpu's
    `ops.channel_stats`), and with capture="hessian" also XᵀX over the
    flattened tokens (`ops.input_hessian`, a plain f32 product)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    a = xf.abs()
    out = {"mean_abs": a.mean(dim=0), "max_abs": a.amax(dim=0)}
    if capture == "hessian":
        out["hessian"] = xf.T @ xf
    return out


class _Capture:
    """Per-layer statistics of the input sites, stacked on a leading [L]
    axis as qtpu's scan stacks them (head_in has none)."""

    def __init__(self, capture: str, num_layers: int):
        self.capture, self.L, self.stats = capture, num_layers, {}

    def add(self, site: str, l: int, x: torch.Tensor):
        st = _channel_stats(x, self.capture)
        if site not in self.stats:
            self.stats[site] = {k: v.new_empty((self.L, *v.shape)) for k, v in st.items()}
        for k, v in st.items():
            self.stats[site][k][l] = v


def forward(params, input_ids, cfg: ModelConfig, qmeta=None, capture: str = "none"):
    """Full-sequence causal forward: input_ids [B, S] -> logits [B, S, V]
    f32 (qtpu's `forward` without an attention override). Sliding-window
    attention applies when the window binds at this S, as in qtpu.

    capture="stats" also returns {input site: {"mean_abs", "max_abs"}},
    [L, C] per layer site and [C] for head_in, taken where qtpu takes them
    (after attn_norm, the attention output, after mlp_norm, silu(gate)·up,
    the final norm); capture="hessian" adds "hessian" XᵀX in f32 ([L, C, C],
    head_in [C, C]). Returns (logits, stats) then."""
    if capture not in CAPTURE_MODES:
        raise ValueError(f"capture must be one of {CAPTURE_MODES}, got {capture!r}")
    qm = (dict(qmeta) if qmeta is not None else {}).get
    S = input_ids.shape[1]
    x = params["embed"][input_ids]
    cos, sin = rope_tables(torch.arange(S, device=input_ids.device), cfg.head_dim,
                           cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
    layers = params["layers"]
    L = layers["attn_norm"].shape[0]
    cap = _Capture(capture, L) if capture != "none" else None
    for l in range(L):
        tap = None if cap is None else (lambda site, t, l=l: cap.add(site, l, t))
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        if tap is not None:
            tap("attn_in", h)
        q, k, v = _qkv(h, layers, cfg, qm, l)
        attn = causal_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, window=win)
        if tap is not None:
            tap("o_in", attn)
        x = x + linear(attn, layers["o_proj"], qm("o_proj"), layer=l)
        x = _mlp_block(x, layers, l, cfg, qm, decode=False, tap=tap)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["lm_head"], qm("lm_head")).float()
    if cap is None:
        return logits
    stats = dict(cap.stats)
    stats["head_in"] = _channel_stats(x, capture)
    return logits, stats


def _write_and_attend(q, k, v, cache: KVCache, l: int, start, mask, window: int, slots=None):
    """KV-cache write and attention for layer l (qtpu's `_write_and_attend`,
    llama.py:299-356), q [B, T, H, hd], k/v [B, T, KV, hd] -> [B, T, H*hd].
    A decode step (T = 1, no slots) writes and attends in one call (`start`
    the position, mask unused): on the int8 cache K11, or K12 for the
    per-layer layout (qtpu's in-place cache) at S % 2048 == 0, which
    attends strictly before pos plus the unquantized new token; on the bf16
    cache K8. A per-layer buffer goes to K11/K8 as a [1, ...] view of layer
    0. Prefill, and any call with `slots`, writes with `cache_layer_write`
    and attends with the plain `cached_attention` under `mask`, as qtpu's
    XLA path does."""
    B, T, H, hd = q.shape
    if T == 1 and slots is None:
        q1 = q[:, 0].contiguous()
        k_c, v_c, ks_c, vs_c, li = cache.stacked(l)
        if cache.quantized and cache.per_layer and cache.max_len % FLASH_SBLK == 0:
            out = decode_attention_flash(q1, k, v, *cache.layer(l), start, window=window)
        elif cache.quantized:
            out = decode_attention_write(q1, k, v, k_c, v_c, ks_c, vs_c, start, li,
                                         window=window)
        else:
            out = decode_attention_write_bf16(q1, k, v, k_c, v_c, start, li, window=window)
        return out.reshape(B, 1, H * hd)
    cache_layer_write(cache, l, k, v, start, slots)
    return cached_attention(q, cache.layer(l, slots), mask)


def forward_with_cache(params, input_ids, positions, cache: KVCache, cfg: ModelConfig,
                       qmeta=None, slots=None):
    """Incremental forward for serving: prefill (T = prompt length) and
    decode (T = 1). input_ids/positions [B, T] (int); writes K/V into
    `cache` in place at positions[:, 0] and attends over the cache with a
    per-sequence causal mask. `slots` [B] (int64) names the cache row of
    each batch row, for a batch that covers only some of the cache's
    sequences (the batcher's admissions); such a call takes the prefill
    path at any T. Returns (logits [B, T, V] f32, cache)."""
    qmeta_d = dict(qmeta) if qmeta is not None else {}
    qm = qmeta_d.get
    B, T = input_ids.shape
    S = cache.max_len
    L = cache.num_layers
    H, hd = cfg.num_heads, cfg.head_dim
    decode = T == 1 and slots is None
    x = params["embed"][input_ids]
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
    start = positions[:, 0].to(torch.int32).contiguous()
    mask = None if decode else cache_mask(positions, S, win)
    layers = params["layers"]
    for l in range(L):
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(h, layers, cfg, qm, l)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin).contiguous()
        v = v.contiguous()
        if decode and cache.quantized and not cache.per_layer:
            # qtpu's cache-carry decode of the stacked cache: K2 then K3
            cache_band_write(k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, start, l)
            attn = decode_attention(
                q[:, 0].contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale,
                start, l, window=win,
            ).reshape(B, 1, H * hd)
        else:
            attn = _write_and_attend(q, k, v, cache, l, start, mask, win, slots)
        x = x + linear(attn, layers["o_proj"], qm("o_proj"), layer=l)
        x = _mlp_block(x, layers, l, cfg, qm, decode)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["lm_head"], qm("lm_head")).float()
    _advance_length(cache, positions, slots)
    return logits, cache


def _advance_length(cache: KVCache, positions, slots) -> None:
    """The cache's filled length of each sequence written at positions [B, T]
    (cache rows `slots` when given), in place."""
    ends = (positions[:, -1] + 1).to(torch.int32)
    if slots is None:
        cache.length = torch.maximum(cache.length, ends)
    else:
        cache.length[slots] = torch.maximum(cache.length[slots], ends)
