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

Two layer-boundary branches of qtpu, off by default, are read from the
environment on every call under qtpu's names (set to "1"); they apply on
the stacked cache with bf16 activations and plain-packed fused sites
(qkv_proj, o_proj, gateup_proj, down_proj with 4-field metas), and
otherwise the layer composes as above:
  QTPU_BOUNDARY        qtpu's `_try_boundary_scan` (llama.py:597-680), on a
                       decode step (T = 1, no slots) of at most 32 rows:
                       layer 0's qkv is K1 with its norm_w option; then per
                       layer RoPE, `_write_and_attend` (K11 on the int8
                       cache, K8 on bf16) and K13 (o-proj, residual, MLP,
                       residual and the next layer's norm and qkv in one
                       launch; the last layer's qkv is computed and not
                       used). Tried first.
  QTPU_FUSE_NORM_RESID qtpu's `_fused_norm_qkv` / `_o_proj_resid`
                       (llama.py:526-595), on every call qtpu takes them on
                       (its stacked delivery, llama.py:186-230): prefill and
                       admissions at any row count and decode at any batch,
                       K1 with norm_w for qkv and with resid for o_proj
                       (the GEMVs at M <= 8, the Hopper route above), around
                       the attention and the MLP block. A site whose K1 call
                       takes no options (`options_supported`: the mma.sync
                       body's shapes) composes, as qtpu composes where its
                       kernel raises; the per-layer cache composes (qtpu
                       unrolls it with l = None, llama.py:708-725).
qtpu runs both only on a TPU; here they also run on the CPU, through the
kernels' plain versions, so that they can be tested there.

Tensor parallelism: both forwards take a `tp` process group with the rank's
local shards (qtpu_torch.sharding.specs.shard_params) and the rank's
ModelConfig (`local_config`: its heads, KV heads and MLP width, in parts
that need not be equal; a rank may hold no head, and then attends to
nothing). q/k/v and gate/up are column-parallel, o_proj and down_proj
row-parallel (ROW_PARALLEL_SITES): `ops.row_linear` all-reduces their
partial products in f32 and adds the residual once (`ops.reduce_add`);
o_proj's input is the rank's attention output, or where its rows are
whole groups its heads do not cover the group's gathered output
(`ops.o_input`); a W8A8 row-parallel site quantizes on the all-reduced
per-token absmax (`ops.linear`); K4
runs in its no-residual mode on every rank and K1 without its resid option
(the fuse branch), their partials summed the same way; a group of one rank
adds the residual in line, as the unsharded path does; the lm_head's
logits are all-gathered. The residual stream and the norms
are replicated. K13's boundary branch spans a row-parallel site, the
residual, the MLP and the next qkv, so no all-reduce fits inside it:
QTPU_BOUNDARY=1 with tp of more than one rank raises ValueError.
`forward`'s `attn_impl` (q, k, v, window) -> [B, S, H*hd] replaces the
attention and builds no mask (qtpu's override; ring attention uses it with
`pos_offset`, the global position of the rank's first token, and
`seq_len`, the whole sequence's length).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as Fn

from qtpu_torch.kernels import fused_mlp as _k4
from qtpu_torch.kernels import layer_boundary as _k13
from qtpu_torch.kernels.dequant_matmul import options_supported, quantized_matmul
from qtpu_torch.kernels.layer_boundary import layer_boundary
from qtpu_torch.kernels.kv_attention import (
    FLASH_SBLK,
    cache_band_write,
    cache_mask,
    cached_attention,
    decode_attention,
    decode_attention_flash,
    decode_attention_plain,
    decode_attention_write,
    decode_attention_write_bf16,
    decode_attention_write_bf16_plain,
    decode_attention_write_plain,
    decode_supported,
    flash_decode_plain,
    flash_supported,
)
from qtpu_torch.models.config import ModelConfig
from qtpu_torch.models.ops import (
    apply_rope,
    causal_attention,
    gather_logits,
    linear,
    mlp_input,
    o_input,
    plain_attention,
    reduce_add,
    rms_norm,
    row_linear,
    rope_tables,
    split_sum,
)
from qtpu_torch.sharding import collectives as coll
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
# the sites whose input dim K splits under tensor parallelism (the
# all-reduce side, qtpu/models/llama.py:66); the rest split their output N
ROW_PARALLEL_SITES = ("o_proj", "down_proj")


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


def _heads(q, k, v, cfg: ModelConfig):
    B, T = q.shape[:2]
    return (
        q.reshape(B, T, cfg.num_heads, cfg.head_dim),
        k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
        v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
    )


def _split_qkv(qkv, cfg: ModelConfig):
    return _heads(*torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1), cfg)


def _qkv(h, layers, cfg: ModelConfig, qm, l):
    if "qkv_proj" in layers:
        return _split_qkv(linear(h, layers["qkv_proj"], qm("qkv_proj"), layer=l), cfg)
    return _heads(
        linear(h, layers["q_proj"], qm("q_proj"), layer=l),
        linear(h, layers["k_proj"], qm("k_proj"), layer=l),
        linear(h, layers["v_proj"], qm("v_proj"), layer=l),
        cfg,
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


def _mlp_block(x, layers, l, cfg: ModelConfig, qm, decode: bool, tap=None, tp=None):
    """norm -> SwiGLU -> residual. A decode step with packed fused
    gateup/down sites that K4 takes runs K4; the rest composes the ops.
    tap(site, tensor), when given, sees the MLP's two linear inputs. Under
    tp the down projection's partial sums are all-reduced, the residual
    added once."""
    gu, dn = layers.get("gateup_proj"), layers.get("down_proj")
    mgu, md = qm("gateup_proj"), qm("down_proj")
    if (decode and x.shape[0] * x.shape[1] <= _k4.MAX_M and cfg.intermediate_size
            and _k4.supported(mgu, md, gu, dn)):
        split = split_sum(tp)
        y = _k4.fused_mlp(
            x, layers["mlp_norm"][l],
            gu["data"][l], gu["scales"][l], gu["zeros"][l],
            dn["data"][l], dn["scales"][l], dn["zeros"][l],
            mgu, md, eps=cfg.norm_eps, resid=not split,
        )
        if split:  # every rank's partial in the no-residual mode
            return reduce_add(x, y, tp)
        return y if tp is None else coll.all_reduce(y, tp)
    h = rms_norm(x, layers["mlp_norm"][l], cfg.norm_eps)
    if tap is not None:
        tap("mlp_in", h)
    gate, up = _gate_up(h, layers, cfg, qm, l)
    act = Fn.silu(gate.float()).to(x.dtype) * up
    if tap is not None:
        tap("down_in", act)
    return row_linear(mlp_input(act, cfg, tp), x, layers["down_proj"], qm("down_proj"), layer=l,
                      tp=tp)


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
        self.put(site, l, _channel_stats(x, self.capture))

    def put(self, site: str, l: int, st: dict):
        """Layer l's statistics of a site, computed by the caller."""
        if site not in self.stats:
            self.stats[site] = {k: v.new_empty((self.L, *v.shape)) for k, v in st.items()}
        for k, v in st.items():
            self.stats[site][k][l] = v


def forward(params, input_ids, cfg: ModelConfig, qmeta=None, capture: str = "none", tp=None,
            attn_impl=None, pos_offset: int = 0, seq_len: int | None = None):
    """Full-sequence causal forward: input_ids [B, S] -> logits [B, S, V]
    f32 (qtpu's `forward`). Sliding-window attention applies when the window
    binds at this S, as in qtpu. tp: the tensor-parallel group (module
    docstring); attn_impl(q, k, v, window): the attention override, with
    the tokens at global positions pos_offset + [0, S) of a sequence of
    seq_len (default S) tokens, whose length decides the window.

    capture="stats" also returns {input site: {"mean_abs", "max_abs"}},
    [L, C] per layer site and [C] for head_in, taken where qtpu takes them
    (after attn_norm, the attention output, after mlp_norm, silu(gate)·up,
    the final norm); capture="hessian" adds "hessian" XᵀX in f32 ([L, C, C],
    head_in [C, C]). Returns (logits, stats) then."""
    if capture not in CAPTURE_MODES:
        raise ValueError(f"capture must be one of {CAPTURE_MODES}, got {capture!r}")
    if capture != "none" and coll.size(tp) > 1:
        raise ValueError("capture takes the whole params: calibration shards rows over "
                         "`data` (qtpu_torch.calib.sharded), not the model")
    qm = (dict(qmeta) if qmeta is not None else {}).get
    S = input_ids.shape[1]
    x = params["embed"][input_ids]
    cos, sin = rope_tables(torch.arange(S, device=input_ids.device) + pos_offset, cfg.head_dim,
                           cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < (seq_len or S) else 0
    layers = params["layers"]
    L = layers["attn_norm"].shape[0]
    cap = _Capture(capture, L) if capture != "none" else None
    for l in range(L):
        x = layer_forward(x, layers, l, cfg, qm, (cos, sin), win, tp, attn_impl, cap)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_logits(linear(x, params["lm_head"], qm("lm_head")).float(), tp)
    if cap is None:
        return logits
    stats = dict(cap.stats)
    stats["head_in"] = _channel_stats(x, capture)
    return logits, stats


def layer_forward(x, layers, l, cfg: ModelConfig, qm, rope, win: int, tp=None, attn_impl=None,
                  cap=None):
    """Layer l of the full-sequence forward on x [B, S, D] (rope: the
    cos/sin tables of its positions); the pipeline's stages run it too."""
    cos, sin = rope
    tap = None if cap is None else (lambda site, t: cap.add(site, l, t))
    h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
    if tap is not None:
        tap("attn_in", h)
    q, k, v = _qkv(h, layers, cfg, qm, l)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = (causal_attention(q, k, v, window=win) if attn_impl is None
            else attn_impl(q, k, v, win))
    if tap is not None:
        tap("o_in", attn)
    x = row_linear(o_input(attn, cfg, tp), x, layers["o_proj"], qm("o_proj"), layer=l, tp=tp)
    return _mlp_block(x, layers, l, cfg, qm, decode=False, tap=tap, tp=tp)


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
    XLA path does. A head dim the decode kernel does not take
    (`flash_supported`, `decode_supported`) runs its plain version
    (`plain_attention`)."""
    B, T, H, hd = q.shape
    if H == 0:  # a tensor-parallel rank that holds no head writes and reads nothing
        return q.new_zeros(B, T, 0)
    if T == 1 and slots is None:
        q1 = q[:, 0].contiguous()
        k_c, v_c, ks_c, vs_c, li = cache.stacked(l)
        takes = decode_supported(hd, H // k.shape[2])
        if cache.quantized and cache.per_layer and cache.max_len % FLASH_SBLK == 0:
            args = (q1, k, v, *cache.layer(l), start)
            out = (decode_attention_flash(*args, window=window) if flash_supported(hd)
                   else plain_attention(flash_decode_plain, *args, window=window))
        elif cache.quantized:
            args = (q1, k, v, k_c, v_c, ks_c, vs_c, start, li)
            out = (decode_attention_write(*args, window=window) if takes
                   else plain_attention(decode_attention_write_plain, *args, window=window))
        else:
            args = (q1, k, v, k_c, v_c, start, li)
            out = (decode_attention_write_bf16(*args, window=window) if takes
                   else plain_attention(decode_attention_write_bf16_plain, *args, window=window))
        return out.reshape(B, 1, H * hd)
    cache_layer_write(cache, l, k, v, start, slots)
    return cached_attention(q, cache.layer(l, slots), mask)


BOUNDARY_SITES = ("o_proj", "gateup_proj", "down_proj", "qkv_proj")


def _plain_packed(site) -> bool:
    """qtpu's `_plain_packed` (llama.py:518): a packed site with nothing
    else (no bias, codebook, actorder perm or smoothing)."""
    return isinstance(site, dict) and set(site) == {"data", "scales", "zeros"}


def _fusable(layers, qm, site: str, M: int) -> bool:
    """A plain-packed site with a 4-field meta whose K1 launch takes the
    norm_w / resid options at M rows."""
    meta = qm(site)
    return (_plain_packed(layers.get(site)) and meta is not None
            and options_supported(meta, M))


def _at(site: dict, l: int) -> dict:
    """Layer l's views of a stacked site (an absent zeros stays None)."""
    return {k: None if v is None else v[l] for k, v in site.items()}


def _boundary_applies(layers, qm, cache: KVCache, B: int) -> bool:
    """QTPU_BOUNDARY=1 on a decode step of the stacked cache whose four
    sites K13 takes (pallas_layer_boundary_stacked's conditions)."""
    if os.environ.get("QTPU_BOUNDARY") != "1" or cache.per_layer or B > _k13.MAX_M:
        return False
    sites = [layers.get(s) for s in BOUNDARY_SITES]
    metas = [qm(s) for s in BOUNDARY_SITES]
    return _k13.supported(metas, sites)


def _boundary_layers(x, layers, qm, cache: KVCache, cfg: ModelConfig, cos, sin, start, win):
    """qtpu's `_try_boundary_scan` body: layer 0's qkv with the attention
    norm in K1's launch, then per layer RoPE, write + attend, and K13, which
    returns the residual stream and the next layer's qkv."""
    L = cache.num_layers
    eps = cfg.norm_eps
    sites = [layers[s] for s in BOUNDARY_SITES]
    metas = tuple(qm(s) for s in BOUNDARY_SITES)
    o, gu, dn, qp = sites
    q0 = _at(qp, 0)
    qkv = quantized_matmul(x, q0["data"], q0["scales"], q0["zeros"], metas[3],
                           norm_w=layers["attn_norm"][0], eps=eps)
    for l in range(L):
        ln = min(l + 1, L - 1)  # the last layer's next qkv is thrown away, as in qtpu
        q, k, v = _split_qkv(qkv, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin).contiguous()
        attn = _write_and_attend(q, k, v.contiguous(), cache, l, start, None, win)
        x, qkv = layer_boundary(attn, x, layers["mlp_norm"][l], layers["attn_norm"][ln],
                                _at(o, l), _at(gu, l), _at(dn, l), _at(qp, ln), metas, eps)
    return x


def _cached_layer(x, layers, qm, l, cache: KVCache, cfg: ModelConfig, cos, sin, start, mask,
                  win, slots, decode: bool, fuse, tp=None):
    """Layer l of forward_with_cache, composed: norm and qkv (K1 with norm_w
    when fuse[0]), RoPE, cache write and attention, o_proj and the residual
    (K1 with resid when fuse[1]), the MLP block."""
    B, H, hd = x.shape[0], cfg.num_heads, cfg.head_dim
    if fuse[0]:
        p = _at(layers["qkv_proj"], l)
        q, k, v = _split_qkv(quantized_matmul(
            x, p["data"], p["scales"], p["zeros"], qm("qkv_proj"),
            norm_w=layers["attn_norm"][l], eps=cfg.norm_eps), cfg)
    else:
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(h, layers, cfg, qm, l)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin).contiguous()
    v = v.contiguous()
    if decode and cache.quantized and not cache.per_layer and H:
        # qtpu's cache-carry decode of the stacked cache: K2 then K3
        cache_band_write(k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, start, l)
        args = (q[:, 0].contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale, start, l)
        attn = (decode_attention(*args, window=win) if decode_supported(hd, H // k.shape[2])
                else plain_attention(decode_attention_plain, *args, window=win))
        attn = attn.reshape(B, 1, H * hd)
    else:
        attn = _write_and_attend(q, k, v, cache, l, start, mask, win, slots)
    attn = o_input(attn, cfg, tp)
    if fuse[1]:
        p = _at(layers["o_proj"], l)
        split = split_sum(tp)
        y = quantized_matmul(attn, p["data"], p["scales"], p["zeros"], qm("o_proj"),
                             resid=None if split else x)
        x = reduce_add(x, y, tp) if split else (y if tp is None else coll.all_reduce(y, tp))
    else:
        x = row_linear(attn, x, layers["o_proj"], qm("o_proj"), layer=l, tp=tp)
    return _mlp_block(x, layers, l, cfg, qm, decode, tp=tp)


def forward_with_cache(params, input_ids, positions, cache: KVCache, cfg: ModelConfig,
                       qmeta=None, slots=None, tp=None):
    """Incremental forward for serving: prefill (T = prompt length) and
    decode (T = 1). input_ids/positions [B, T] (int); writes K/V into
    `cache` in place at positions[:, 0] and attends over the cache with a
    per-sequence causal mask. `slots` [B] (int64) names the cache row of
    each batch row, for a batch that covers only some of the cache's
    sequences (the batcher's admissions); such a call takes the prefill
    path at any T. QTPU_BOUNDARY / QTPU_FUSE_NORM_RESID pick qtpu's
    layer-boundary branches (module docstring). tp: the tensor-parallel
    group, with the rank's local params, config and cache (its KV heads).
    Returns (logits [B, T, V] f32, cache)."""
    qmeta_d = dict(qmeta) if qmeta is not None else {}
    qm = qmeta_d.get
    B, T = input_ids.shape
    S = cache.max_len
    decode = T == 1 and slots is None
    x = params["embed"][input_ids]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
    start = positions[:, 0].to(torch.int32).contiguous()
    mask = None if decode else cache_mask(positions, S, win)
    layers = params["layers"]
    # qtpu's layer-boundary branches: the stacked cache, bf16 activations
    branch = not cache.per_layer and x.dtype == torch.bfloat16
    if branch and decode and _boundary_applies(layers, qm, cache, B):
        if coll.size(tp) > 1:
            raise ValueError("QTPU_BOUNDARY=1 under tensor parallelism: K13 spans a "
                             "row-parallel site, the residual and the MLP, so no all-reduce "
                             "fits inside it (not ported for tensor parallelism)")
        x = _boundary_layers(x, layers, qm, cache, cfg, cos, sin, start, win)
    else:
        fuse = branch and os.environ.get("QTPU_FUSE_NORM_RESID") == "1"
        fuse = tuple(fuse and _fusable(layers, qm, s, B * T) for s in ("qkv_proj", "o_proj"))
        for l in range(cache.num_layers):
            x = _cached_layer(x, layers, qm, l, cache, cfg, cos, sin, start, mask, win, slots,
                              decode, fuse, tp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_logits(linear(x, params["lm_head"], qm("lm_head")).float(), tp)
    _advance_length(cache, positions, slots)
    return logits, cache


def _advance_length(cache: KVCache, positions, slots) -> None:
    """The cache's filled length of each sequence written at positions [B, T]
    (cache rows `slots` when given), in place."""
    ends = (positions[:, -1] + 1).to(torch.int32)
    if slots is None:  # the same tensor, so a CUDA graph of decode steps updates it
        torch.maximum(cache.length, ends, out=cache.length)
    else:
        cache.length[slots] = torch.maximum(cache.length[slots], ends)
