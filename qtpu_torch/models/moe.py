"""Mixtral-style sparse-MoE decoder (port of qtpu/models/moe.py: init_params,
forward and forward_with_cache): llama attention (shared with
qtpu_torch.models.llama) and a routed SwiGLU expert MLP.

Param layout as in qtpu, layers stacked on a leading [L] axis: llama's
attention sites and norms, the router {"w": [L, D, E]} (kept dense when
packed: PACK_DENSE_SITES), the expert sites exp_gate / exp_up {"w": [L, E,
D, F]} and exp_down [L, E, F, D] (packed: "data" [L, E, Kp, N], "scales" and
"zeros" [L, E, K/g, N]); Qwen2-MoE adds an always-on shared expert (sh_gate,
sh_up [L, D, Fs], sh_down [L, Fs, D]) and its sigmoid gate sh_router
[L, D, 1]. Absent optional sites are skipped.

The expert MLP takes one of two routes, chosen by shape (the CPU takes the
card's route, through the kernels' plain versions):
  * grouped (qtpu's soft dispatch): every expert runs on every token, one
    K9 launch per packed affine site for all E experts of the layer, and
    the top-k routing weights (zero elsewhere) combine the E outputs in f32;
  * gathered: one slot per routed (token, expert) pair, K10 streaming only
    the routed experts, the top-k rows combined in f32 -- a decode step
    (T = 1) with B * top_k < E, no shared expert and packed affine expert
    sites, smoothed ones included (qtpu/models/moe.py:234-302); qtpu's
    switch QTPU_MOE_GATHERED (default "1", read on every call) set to
    anything else sends such steps to the grouped route.
An expert site's input "smooth" vectors (AWQ, SmoothQuant) are per expert,
[L, E, K]: x is scaled per expert (K9 with a per-expert input; K10's rows by
their expert's vector). Codebook (POT/APOT, K7), actorder-perm (GPTQ, K1)
and W8A8 (K6) expert sites run one `linear` a expert, as qtpu's
`_expert_matmul` does (moe.py:129-200), and take the grouped route.
Both forwards are a Python loop over layers on zero-copy W[l] views, as in
qtpu_torch.models.llama; `forward_with_cache` writes and attends through
llama's `_write_and_attend` (K11 on the int8 cache at decode, K8 on the bf16
cache). `forward(capture=...)` returns qtpu's calibration statistics, the
down-projections' input counted per expert over the tokens routed to it
(`_routed_stats`).
Tensor and expert parallelism (qtpu/sharding/specs.py:51-62): under a `tp`
group the attention is llama's Megatron split, each rank holds E / tp of
the experts (qtpu_torch.sharding.specs.shard_params splits the expert axis)
and a Qwen2-MoE shared expert's columns / rows, the router stays whole. K9
and K10 run on the rank's experts (the routing weights of the others
dropped; a gathered slot routed elsewhere weighs 0), and the routed
combine with the shared expert's partial sum is all-reduced in f32, the
residual added after it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as Fn

from qtpu_torch.kernels.kv_attention import cache_mask
from qtpu_torch.kernels.moe_matmul import moe_gathered_matmul, moe_matmul
from qtpu_torch.models.config import ModelConfig
from qtpu_torch.models.llama import (
    CAPTURE_MODES,
    _advance_length,
    _Capture,
    _channel_stats,
    _qkv,
    _write_and_attend,
)
from qtpu_torch.models.ops import (
    apply_rope,
    causal_attention,
    gather_logits,
    is_a8,
    linear,
    mlp_input,
    o_input,
    rms_norm,
    row_linear,
    rope_tables,
    split_sum,
)
from qtpu_torch.serve.kvcache import KVCache
from qtpu_torch.sharding import collectives as coll

LAYER_SITES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "router", "exp_gate", "exp_up", "exp_down",
    # Qwen2-MoE only (absent on Mixtral): the shared expert and its sigmoid gate
    "sh_gate", "sh_up", "sh_down", "sh_router",
)
INPUT_SITES = ("attn_in", "o_in", "mlp_in", "exp_down_in", "sh_down_in", "head_in")
SITE_OF_INPUT = {
    "attn_in": ("q_proj", "k_proj", "v_proj"),
    "o_in": ("o_proj",),
    "mlp_in": ("router", "exp_gate", "exp_up", "sh_gate", "sh_up", "sh_router"),
    "exp_down_in": ("exp_down",),
    "sh_down_in": ("sh_down",),
    "head_in": ("lm_head",),
}
# the sites whose input dim K splits under tensor parallelism
# (qtpu/models/moe.py:69); the expert sites split their expert axis
ROW_PARALLEL_SITES = ("o_proj", "sh_down")
# sites with a [L, E, ...] expert axis: the quantizers see a flat L*E layer axis
EXPERT_SITES = ("exp_gate", "exp_up", "exp_down")
# input sites whose calibration stats carry a per-expert axis
EXPERT_INPUT_SITES = ("exp_down_in",)
# the router ([D, E]) and the shared-expert gate ([D, 1]) stay dense when packed
PACK_DENSE_SITES = ("router", "sh_router")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random-normal params (std 0.02) from a torch.Generator on `device`, one
    f32 matrix at a time (a [D, F] slab of one expert of one layer), so no f32
    copy of a whole [L, E, D, F] leaf is made. On the "meta" device only the
    shapes are made."""
    if cfg.num_experts <= 1:
        raise ValueError("arch='moe' needs num_experts > 1")
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    D, F, V, L, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers,
                     cfg.num_experts)
    Q, KV = cfg.q_dim, cfg.kv_dim

    def w(*shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        if meta:
            return t
        slabs = t.view(-1, *shape[-2:]) if len(shape) > 2 else t
        for i in range(slabs.shape[0]):
            slabs[i] = (torch.randn(slabs.shape[1:], generator=gen, device=device) * 0.02).to(dtype)
        return t

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        "q_proj": {"w": w(L, D, Q)},
        "k_proj": {"w": w(L, D, KV)},
        "v_proj": {"w": w(L, D, KV)},
        "o_proj": {"w": w(L, Q, D)},
        "router": {"w": w(L, D, E)},
        "exp_gate": {"w": w(L, E, D, F)},
        "exp_up": {"w": w(L, E, D, F)},
        "exp_down": {"w": w(L, E, F, D)},
    }
    Fs = cfg.shared_expert_intermediate_size
    if Fs > 0:  # Qwen2-MoE shared expert + sigmoid gate
        layers["sh_gate"] = {"w": w(L, D, Fs)}
        layers["sh_up"] = {"w": w(L, D, Fs)}
        layers["sh_down"] = {"w": w(L, Fs, D)}
        layers["sh_router"] = {"w": w(L, D, 1)}
    if cfg.attention_bias:  # Qwen2: bias on q/k/v only
        for site, n in (("q_proj", Q), ("k_proj", KV), ("v_proj", KV)):
            layers[site]["b"] = w(L, n)
    return {
        "embed": w(V, D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": {"w": w(D, V)},
    }


def _at(t, l):
    return None if t is None else t[l]


def _packed_affine(p: dict, meta) -> bool:
    """A site that K9 and K10 take: packed, 4-field qmeta, no codebook or
    actorder perm (an input smooth is applied to x before the kernel)."""
    return ("data" in p and meta is not None and len(meta) == 4
            and not any(key in p for key in ("codebook", "perm")))


def _expert_matmul(x, p: dict, meta, per_expert_input: bool, l: int):
    """x [M, K] (shared input) or [E, M, K] (per-expert input) against layer l
    of an expert site -> [E, M, N]. A smooth site [L, E, K] scales x per
    expert first (the input becomes per expert). A dense site runs one
    einsum over the experts, a packed affine site K9 (one launch for all E
    experts), a codebook, perm or W8A8 site one `linear` a expert (K7, K1,
    K6)."""
    if "smooth" in p:
        s = p["smooth"][l].to(x.dtype)  # [E, K]
        x = (x if per_expert_input else x[None]) * s[:, None, :]
        per_expert_input = True
        p = {k: v for k, v in p.items() if k != "smooth"}
    if "w" in p:
        w = p["w"][l].to(x.dtype)
        return torch.einsum("emk,ekn->emn" if per_expert_input else "mk,ekn->emn", x, w)
    if _packed_affine(p, meta):
        return moe_matmul(x, p["data"][l], p["scales"][l], _at(p.get("zeros"), l), meta,
                          per_expert_input)
    E = p["data"].shape[1]
    return torch.stack([linear(x[e] if per_expert_input else x,
                               {k: v[l, e] for k, v in p.items()}, meta) for e in range(E)])


def _route(h, layers, cfg: ModelConfig, qm, l):
    """The Mixtral router: softmax over E in f32, top-k, renormalized with
    norm_topk_prob. Returns (weights [..., k] f32, expert ids [..., k]).
    jax.lax.top_k breaks ties toward the lower expert, and so does a stable
    descending sort; torch.topk promises no order on ties."""
    logits = linear(h, layers["router"], qm("router"), layer=l).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    topv, topi = topv[..., :k], topi[..., :k]
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv, topi


def _routing_weights(h, layers, cfg: ModelConfig, qm, l):
    """Dense [..., E] f32 combine weights, zero outside each token's top-k."""
    topv, topi = _route(h, layers, cfg, qm, l)
    shape = (*h.shape[:-1], cfg.num_experts)
    return torch.zeros(shape, dtype=torch.float32, device=h.device).scatter(-1, topi, topv)


def _gathered_route(layers, cfg: ModelConfig, qm, B: int, T: int) -> bool:
    """qtpu's gathered decode (moe.py:293-305): T = 1, B * top_k < E, no
    shared expert, every expert site packed affine (smoothed or not), and
    QTPU_MOE_GATHERED unset or "1"."""
    return (T == 1 and B * cfg.num_experts_per_tok < cfg.num_experts
            and os.environ.get("QTPU_MOE_GATHERED", "1") == "1"
            and "sh_gate" not in layers
            and all(_packed_affine(layers[s], qm(s)) for s in EXPERT_SITES))


def _local_experts(layers, tp):
    """(first expert, count) of the rank's experts."""
    p = layers["exp_gate"]
    E_loc = next(v for v in p.values() if v is not None).shape[1]
    return coll.rank(tp) * E_loc, E_loc


def _moe_mlp_gathered(h, layers, cfg: ModelConfig, qm, l, tp=None):
    """Decode-time capacity-gathered expert MLP: one K10 slot per routed
    (token, expert) pair, h [B, 1, D] -> [B, 1, D]. The expert ids stay on
    the device. A smoothed site scales each slot's row by its expert's
    vector, s[eidx]. Under tp a slot routed to another rank's expert runs
    on the rank's first expert and weighs 0; the f32 combine is
    all-reduced."""
    B, T, D = h.shape
    k = cfg.num_experts_per_tok
    topv, topi = _route(h, layers, cfg, qm, l)  # [B, 1, k]
    eidx = topi.reshape(B * k).to(torch.int32)
    if tp is not None:
        e0, E_loc = _local_experts(layers, tp)
        eidx = eidx - e0
        mine = (eidx >= 0) & (eidx < E_loc)
        eidx = torch.where(mine, eidx, torch.zeros_like(eidx))
        topv = topv * mine.reshape(topv.shape)
    xrows = h.reshape(B, D).repeat_interleave(k, dim=0)  # [Gs, D]

    def gmm(x, site):
        p = layers[site]
        if "smooth" in p:
            x = x * p["smooth"][l][eidx.long()].to(x.dtype)
        return moe_gathered_matmul(x, eidx, p["data"][l], p["scales"][l],
                                   _at(p.get("zeros"), l), qm(site))

    act = Fn.silu(gmm(xrows, "exp_gate").float()).to(h.dtype) * gmm(xrows, "exp_up")
    d = gmm(act, "exp_down")  # [Gs, D]
    out = (topv.reshape(B, k, 1) * d.float().reshape(B, k, D)).sum(dim=1)
    if tp is not None:
        out = coll.all_reduce(out, tp)
    return out.to(h.dtype).reshape(B, T, D)


def _routed_stats(act, route_w, capture: str) -> dict:
    """qtpu's `_routed_stats` (moe.py:217-231): the down-projections' input
    statistics over the tokens routed to each expert only, what a hook on
    expert e's down-projection sees. act [E, M, F], route_w [M, E] ->
    mean_abs / max_abs [E, F] in f32 (hessian [E, F, F], sum of XᵀX of the
    routed rows)."""
    m = (route_w > 0).float().T[..., None]  # [E, M, 1]
    a = act.float().abs() * m
    cnt = m.sum(dim=1).clamp_min(1.0)  # [E, 1]
    out = {"mean_abs": a.sum(dim=1) / cnt, "max_abs": a.amax(dim=1)}
    if capture == "hessian":
        xm = act.float() * m
        out["hessian"] = xm.transpose(1, 2) @ xm
    return out


def _moe_mlp(h, layers, cfg: ModelConfig, qm, l, cap=None, tp=None):
    """Routed expert MLP of layer l: h [B, T, D] -> [B, T, D] (the residual
    is the caller's). cap (a calibration capture) takes the grouped route
    and records exp_down_in (routed) and sh_down_in. tp: the expert-parallel
    group (module docstring)."""
    B, T, D = h.shape
    if cap is None and _gathered_route(layers, cfg, qm, B, T):
        return _moe_mlp_gathered(h, layers, cfg, qm, l, tp)
    h2 = h.reshape(B * T, D)
    route_w = _routing_weights(h2, layers, cfg, qm, l)  # [M, E]
    if tp is not None:
        e0, E_loc = _local_experts(layers, tp)
        route_w = route_w[:, e0:e0 + E_loc]
    g = _expert_matmul(h2, layers["exp_gate"], qm("exp_gate"), False, l)  # [E, M, F]
    u = _expert_matmul(h2, layers["exp_up"], qm("exp_up"), False, l)
    act = Fn.silu(g.float()).to(h.dtype) * u
    if cap is not None:
        cap.put("exp_down_in", l, _routed_stats(act, route_w, cap.capture))
    d = _expert_matmul(act, layers["exp_down"], qm("exp_down"), True, l)  # [E, M, D]
    out = torch.einsum("me,emd->md", route_w, d.float())
    if tp is None:
        out = out.to(h.dtype)
    whole = None  # a shared expert's product every rank already holds whole
    if "sh_gate" in layers:  # Qwen2-MoE always-on shared expert, sigmoid-gated
        sg = linear(h2, layers["sh_gate"], qm("sh_gate"), layer=l)
        su = linear(h2, layers["sh_up"], qm("sh_up"), layer=l)
        sact = Fn.silu(sg.float()).to(h.dtype) * su
        if cap is not None:
            cap.add("sh_down_in", l, sact)
        # a W8A8 sh_down comes back whole from linear under tp (ops._a8_split)
        sd = linear(mlp_input(sact, cfg, tp), layers["sh_down"], qm("sh_down"), layer=l, tp=tp)
        gate = torch.sigmoid(linear(h2, layers["sh_router"], qm("sh_router"), layer=l).float())
        shared = gate * sd.float()
        if tp is None:
            out = out + shared.to(h.dtype)
        elif is_a8(qm("sh_down")) and split_sum(tp):
            whole = shared
        else:
            out = out + shared
    if tp is not None:  # the rank's experts' (and shared-expert slice's) partial sum
        out = coll.all_reduce(out, tp)
        out = (out if whole is None else out + whole).to(h.dtype)
    return out.reshape(B, T, D)


def layer_forward(x, layers, l, cfg: ModelConfig, qm, rope, win: int, tp=None, cap=None):
    """Layer l of the full-sequence forward on x [B, S, D] (rope: the
    cos/sin tables of its positions); the pipeline's stages run it too."""
    cos, sin = rope
    h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
    if cap is not None:
        cap.add("attn_in", l, h)
    q, k, v = _qkv(h, layers, cfg, qm, l)
    attn = causal_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, window=win)
    if cap is not None:
        cap.add("o_in", l, attn)
    x = row_linear(o_input(attn, cfg, tp), x, layers["o_proj"], qm("o_proj"), layer=l, tp=tp)
    h = rms_norm(x, layers["mlp_norm"][l], cfg.norm_eps)
    if cap is not None:
        cap.add("mlp_in", l, h)
    return x + _moe_mlp(h, layers, cfg, qm, l, cap, tp)


def forward(params, input_ids, cfg: ModelConfig, qmeta=None, capture: str = "none", tp=None):
    """Full-sequence causal forward: input_ids [B, S] -> logits [B, S, V] f32
    (qtpu's moe `forward`). capture "stats" / "hessian" also returns the
    calibration statistics as llama's forward does, with exp_down_in per
    expert over its routed tokens ([L, E, F]; hessian [L, E, F, F]) and,
    on Qwen2-MoE, sh_down_in; returns (logits, stats) then. tp: the
    tensor/expert-parallel group (module docstring)."""
    if capture not in CAPTURE_MODES:
        raise ValueError(f"capture must be one of {CAPTURE_MODES}, got {capture!r}")
    if capture != "none" and coll.size(tp) > 1:
        raise ValueError("capture takes the whole params: calibration shards rows over "
                         "`data` (qtpu_torch.calib.sharded), not the model")
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
        x = layer_forward(x, layers, l, cfg, qm, (cos, sin), win, tp, cap)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_logits(linear(x, params["lm_head"], qm("lm_head")).float(), tp)
    if cap is None:
        return logits
    stats = dict(cap.stats)
    stats["head_in"] = _channel_stats(x, capture)
    return logits, stats


def forward_with_cache(params, input_ids, positions, cache: KVCache, cfg: ModelConfig,
                       qmeta=None, slots=None, tp=None):
    """Incremental forward for serving, the contract of llama's
    `forward_with_cache`: input_ids/positions [B, T]; writes K/V into `cache`
    in place at positions[:, 0] (rows `slots` of the cache when given) and
    attends over it. A decode step runs per layer K1 on q, k, v and o_proj,
    K11 (int8 cache) or K8 (bf16 cache), and the expert MLP's K9 or K10.
    Returns (logits [B, T, V] f32, cache)."""
    qm = (dict(qmeta) if qmeta is not None else {}).get
    B, T = input_ids.shape
    S = cache.max_len
    x = params["embed"][input_ids]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
    start = positions[:, 0].to(torch.int32).contiguous()
    mask = None if T == 1 and slots is None else cache_mask(positions, S, win)
    layers = params["layers"]
    for l in range(cache.num_layers):
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(h, layers, cfg, qm, l)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin).contiguous()
        attn = _write_and_attend(q, k, v.contiguous(), cache, l, start, mask, win, slots)
        x = row_linear(o_input(attn, cfg, tp), x, layers["o_proj"], qm("o_proj"), layer=l,
                       tp=tp)
        x = x + _moe_mlp(rms_norm(x, layers["mlp_norm"][l], cfg.norm_eps), layers, cfg, qm, l,
                         tp=tp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_logits(linear(x, params["lm_head"], qm("lm_head")).float(), tp)
    _advance_length(cache, positions, slots)
    return logits, cache
