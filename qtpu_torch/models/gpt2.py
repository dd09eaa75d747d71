"""GPT-2 family decoder (port of qtpu/models/gpt2.py: init_params, forward
and forward_with_cache), and the body it shares with OPT (models/opt.py).

Param layout as in qtpu, layers stacked on a leading axis, linears
[in, out] with biases:
  embed [V, D]; pos_embed [P, D] (learned positions)
  layers/ln1_w, ln1_b, ln2_w, ln2_b [L, D] (LayerNorm with bias)
  layers/c_attn {"w": [L, D, 3D], "b": [L, 3D]} (fused q/k/v), attn_out,
  mlp_fc, mlp_proj; final_norm_w, final_norm_b [D]
  lm_head {"w": [D, V]} (tied to the embedding at init, quantized on its own)

`forward` runs K1 on every packed site and K5 for the attention (with
`capture`, the statistics calibration needs, at qtpu's capture points).
`forward_with_cache` updates the stacked KV cache in place: a decode step
on the int8 cache runs per layer K1 (c_attn), K2 (the cache write) and the
one-layer decode attention (`decode_attention_layer`, K3's kernel: qtpu's
`_cached_attention` reaches pallas_decode_attention there; its plain
version at a head dim the kernel does not take, counted by
`ops.plain_attention`), then K1 on attn_out, mlp_fc and mlp_proj; on the
bf16 cache K8 writes and attends.
Prefill writes with `cache_layer_write` and attends with the plain
`cached_attention`, as qtpu's XLA path does. The per-layer cache layout
raises: qtpu's layer scan over `cache.k` cannot take it either.
Tensor parallelism as in models/llama.py: both forwards take a `tp` group
with the rank's local shards and config; the attention output and the
MLP's second linear are row-parallel (`ops.row_linear`, the bias added on
the group's rank 0 only), the lm_head's logits all-gathered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from qtpu_torch.kernels.kv_attention import (
    cache_band_write,
    cache_mask,
    decode_attention_layer,
    decode_attention_plain,
    decode_supported,
)
from qtpu_torch.models.config import ModelConfig
from qtpu_torch.models.llama import (
    CAPTURE_MODES,
    _advance_length,
    _Capture,
    _channel_stats,
    _write_and_attend,
)
from qtpu_torch.models.ops import (
    causal_attention,
    gather_logits,
    gelu_tanh,
    layer_norm,
    linear,
    mlp_input,
    o_input,
    plain_attention,
    row_linear,
)
from qtpu_torch.serve.kvcache import KVCache
from qtpu_torch.sharding import collectives as coll

LAYER_SITES = ("c_attn", "attn_out", "mlp_fc", "mlp_proj")
INPUT_SITES = ("attn_in", "o_in", "mlp_in", "proj_in", "head_in")
# the sites whose input dim K splits under tensor parallelism
# (qtpu/models/gpt2.py:36)
ROW_PARALLEL_SITES = ("attn_out", "mlp_proj")
SITE_OF_INPUT = {
    "attn_in": ("c_attn",),
    "o_in": ("attn_out",),
    "mlp_in": ("mlp_fc",),
    "proj_in": ("mlp_proj",),
    "head_in": ("lm_head",),
}


@dataclass(frozen=True)
class Family:
    """What the GPT-2 and OPT decoders differ in around the shared body."""

    qkv: Callable  # (h, layers, cfg, qm, l) -> q, k, v [B, T, H, hd]
    act: Callable  # the MLP's activation
    o_site: str  # the attention output projection
    fc_site: str  # the MLP's two linears
    proj_site: str
    proj_input: str  # the capture name of proj_site's input
    pos_offset: int  # the learned position table's index of position 0


def _w(shape, gen, device, dtype, meta):
    """Random-normal std 0.02, one slab of the leading axis at a time."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if not meta:
        for i in range(shape[0]):
            t[i] = (torch.randn(shape[1:], generator=gen, device=device) * 0.02).to(dtype)
    return t


def _base_params(cfg: ModelConfig, sites: dict, positions: int, seed, device, dtype) -> dict:
    """The LayerNorm decoder's params: embeddings, norms, the tied lm_head,
    and `sites` {name: out width} of [L, in, out] linears with zero biases
    ({name: (in, out)} where in is not D)."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers

    def w(*shape):
        return _w(shape, gen, device, dtype, meta)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    embed = w(V, D)
    layers = {"ln1_w": const(1.0, L, D), "ln1_b": const(0.0, L, D),
              "ln2_w": const(1.0, L, D), "ln2_b": const(0.0, L, D)}
    for name, dims in sites.items():
        k, n = dims if isinstance(dims, tuple) else (D, dims)
        layers[name] = {"w": w(L, k, n), "b": const(0.0, L, n)}
    return {
        "embed": embed,
        "pos_embed": w(positions, D),
        "layers": layers,
        "final_norm_w": const(1.0, D),
        "final_norm_b": const(0.0, D),
        # the tie of the reference: a copy, so the site quantizes on its own
        "lm_head": {"w": embed.T.contiguous()},
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random-normal weights (std 0.02) drawn from a torch.Generator on
    `device`, LayerNorms at 1 and 0, zero biases (qtpu's init). On the
    "meta" device only the shapes are made."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    return _base_params(cfg, {"c_attn": 3 * D, "attn_out": D, "mlp_fc": F, "mlp_proj": (F, D)},
                        cfg.max_seq_len, seed, device, dtype)


def _qkv(h, layers, cfg: ModelConfig, qm, l):
    B, T = h.shape[:2]
    H, hd = cfg.num_heads, cfg.head_dim
    qkv = linear(h, layers["c_attn"], qm("c_attn"), layer=l)
    q, k, v = torch.split(qkv, H * hd, dim=-1)
    return q.reshape(B, T, H, hd), k.reshape(B, T, H, hd), v.reshape(B, T, H, hd)


def _act(y):
    """GELU (tanh approximation) in f32, as qtpu's jax.nn.gelu(approximate=True)."""
    return gelu_tanh(y.float()).to(y.dtype)


def _embed(params, input_ids, positions, offset):
    """Token plus learned position embedding; positions past the table are
    clamped to its last row, as JAX's gather clamps them (an inactive
    batcher slot decodes at the cache length)."""
    pe = params["pos_embed"]
    idx = (positions + offset).clamp(0, pe.shape[0] - 1)
    return params["embed"][input_ids] + pe[idx]


def _mlp(fam: Family, x, layers, l, cfg, qm, tap=None, tp=None):
    h = layer_norm(x, layers["ln2_w"][l], layers["ln2_b"][l], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    a = fam.act(linear(h, layers[fam.fc_site], qm(fam.fc_site), layer=l))
    if tap is not None:
        tap(fam.proj_input, a)
    return row_linear(mlp_input(a, cfg, tp), x, layers[fam.proj_site], qm(fam.proj_site),
                      layer=l, tp=tp)


def _logits(params, x, cfg, qm, tp=None):
    x = layer_norm(x, params["final_norm_w"], params["final_norm_b"], cfg.norm_eps)
    return x, gather_logits(linear(x, params["lm_head"], qm("lm_head")).float(), tp)


def decoder_forward(fam: Family, params, input_ids, cfg: ModelConfig, qmeta=None,
                    capture="none", tp=None):
    """The full-sequence forward of the LayerNorm decoders (GPT-2, OPT),
    qtpu's `forward`."""
    if capture not in CAPTURE_MODES:
        raise ValueError(f"capture must be one of {CAPTURE_MODES}, got {capture!r}")
    if capture != "none" and coll.size(tp) > 1:
        raise ValueError("capture takes the whole params: calibration shards rows over "
                         "`data` (qtpu_torch.calib.sharded), not the model")
    qm = (dict(qmeta) if qmeta is not None else {}).get
    S = input_ids.shape[1]
    positions = torch.arange(S, device=input_ids.device)
    x = _embed(params, input_ids, positions[None], fam.pos_offset)
    layers = params["layers"]
    L = layers["ln1_w"].shape[0]
    cap = _Capture(capture, L) if capture != "none" else None
    for l in range(L):
        tap = None if cap is None else (lambda site, t, l=l: cap.add(site, l, t))
        h = layer_norm(x, layers["ln1_w"][l], layers["ln1_b"][l], cfg.norm_eps)
        if tap is not None:
            tap("attn_in", h)
        q, k, v = fam.qkv(h, layers, cfg, qm, l)
        attn = causal_attention(q, k, v)
        if tap is not None:
            tap("o_in", attn)
        x = row_linear(o_input(attn, cfg, tp), x, layers[fam.o_site], qm(fam.o_site), layer=l,
                       tp=tp)
        x = _mlp(fam, x, layers, l, cfg, qm, tap, tp)
    x, logits = _logits(params, x, cfg, qm, tp)
    if cap is None:
        return logits
    stats = dict(cap.stats)
    stats["head_in"] = _channel_stats(x, capture)
    return logits, stats


def decoder_forward_with_cache(fam: Family, params, input_ids, positions, cache: KVCache,
                               cfg: ModelConfig, qmeta=None, slots=None, tp=None):
    """Incremental forward of the LayerNorm decoders, llama's contract:
    input_ids/positions [B, T]; K/V written in place at positions[:, 0]
    (cache rows `slots` when given). Returns (logits [B, T, V] f32, cache)."""
    if cache.per_layer:
        raise NotImplementedError(
            f"arch '{cfg.arch}' decodes on the stacked KV cache only (qtpu's layer scan "
            "over cache.k cannot take the per-layer layout)")
    qm = (dict(qmeta) if qmeta is not None else {}).get
    B, T = input_ids.shape
    H, hd = cfg.num_heads, cfg.head_dim
    decode = T == 1 and slots is None
    x = _embed(params, input_ids, positions, fam.pos_offset)
    start = positions[:, 0].to(torch.int32).contiguous()
    mask = None if decode else cache_mask(positions, cache.max_len)
    layers = params["layers"]
    for l in range(cache.num_layers):
        h = layer_norm(x, layers["ln1_w"][l], layers["ln1_b"][l], cfg.norm_eps)
        q, k, v = fam.qkv(h, layers, cfg, qm, l)
        k, v = k.contiguous(), v.contiguous()
        if decode and cache.quantized and H:
            # qtpu: cache_layer_write, then _cached_attention's
            # pallas_decode_attention on the written layer: K2, then K3's kernel
            cache_band_write(k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, start, l)
            q1, one = q[:, 0].contiguous(), cache.layer(l)
            if decode_supported(hd, H // k.shape[2]):
                attn = decode_attention_layer(q1, *one, start)
            else:  # the one-layer entry's plain version on a [1, ...] view
                attn = plain_attention(decode_attention_plain, q1,
                                       *(t.unsqueeze(0) for t in one), start, 0)
            attn = attn.reshape(B, 1, H * hd)
        else:
            attn = _write_and_attend(q, k, v, cache, l, start, mask, 0, slots)
        x = row_linear(o_input(attn, cfg, tp), x, layers[fam.o_site], qm(fam.o_site), layer=l,
                       tp=tp)
        x = _mlp(fam, x, layers, l, cfg, qm, tp=tp)
    _, logits = _logits(params, x, cfg, qm, tp)
    _advance_length(cache, positions, slots)
    return logits, cache


GPT2 = Family(qkv=_qkv, act=_act, o_site="attn_out", fc_site="mlp_fc", proj_site="mlp_proj",
              proj_input="proj_in", pos_offset=0)


def forward(params, input_ids, cfg: ModelConfig, qmeta=None, capture: str = "none", tp=None):
    """input_ids [B, S] -> logits [B, S, V] f32 (with capture: (logits,
    stats), the input sites of INPUT_SITES)."""
    return decoder_forward(GPT2, params, input_ids, cfg, qmeta, capture, tp)


def forward_with_cache(params, input_ids, positions, cache: KVCache, cfg: ModelConfig,
                       qmeta=None, slots=None, tp=None):
    return decoder_forward_with_cache(GPT2, params, input_ids, positions, cache, cfg, qmeta,
                                      slots, tp)
