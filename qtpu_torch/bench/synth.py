"""Synthetic packed models for benchmarks and compile checks (port of
qtpu/bench/synth.py).

A packed model with ONE random weight per site, tiled over the layer stack:
throughput and launch checks do not care whether the layers differ, and a
full-width model then costs one layer's weights. The weights are drawn
from an explicit torch.Generator on the target device (the card unless
device="cpu"), quantized and packed by qtpu_torch.core.packing.quantize_pack,
and tiled as `expand` views: every [L, ...] site is one layer's bytes with a
layer stride of 0, whose W[l] views are contiguous (what the kernels take).
Fused sites (qkv_proj, gateup_proj) are fused on one layer before the
tiling, since torch.cat of the tiled sites would copy them L times; expert
sites hold their E experts (one layer's bytes) and are tiled over L alone.
qtpu draws its weights with jax.random, so the values differ from qtpu's;
the shapes, dtypes and qmeta are qtpu's.
"""

from __future__ import annotations

import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.quant.apply import fuse_packed_sites


def _llama_sites(cfg) -> dict:
    D, F, Q, KV = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    return {"q_proj": (D, Q), "k_proj": (D, KV), "v_proj": (D, KV), "o_proj": (Q, D),
            "gate_proj": (D, F), "up_proj": (D, F), "down_proj": (F, D)}


def _normal(shape, gen, device):
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)


def _packed(w, bits, group) -> dict:
    qt = quantize_pack(w, bits, group)
    return {"data": qt.data, "scales": qt.scales, "zeros": qt.zeros}


def _tile(tree, L: int):
    """Every tensor of a layer tree ([1, ...]) as an [L, ...] stride-0 view."""
    if isinstance(tree, dict):
        return {k: _tile(v, L) for k, v in tree.items()}
    return tree.expand(L, *tree.shape[1:])


def _one_layer(site: dict) -> dict:
    return {k: v[None] for k, v in site.items()}


def _model(layers: dict, metas: dict, cfg, head_meta: tuple, gen, device):
    """The packed model around one layer's sites: norms of ones, the
    lm_head packed by head_meta (bits, group, D, V[, "a8"]), the embedding."""
    D, V = cfg.hidden_size, cfg.vocab_size
    ones = torch.ones((1, D), dtype=torch.bfloat16, device=device)
    layers = {"attn_norm": ones, "mlp_norm": ones, **layers}
    head = _packed(_normal((D, V), gen, device), *head_meta[:2])
    metas["lm_head"] = head_meta
    packed = {"embed": _normal((V, D), gen, device), "layers": layers,
              "final_norm": torch.ones((D,), dtype=torch.bfloat16, device=device),
              "lm_head": head}
    return packed, tuple(sorted(metas.items()))


def tiled_packed_llama(cfg, w_bit: int = 4, group: int = 128, fuse: bool = True,
                       device="cuda", seed: int = 0):
    """(packed_params, qmeta) for a llama-family ModelConfig: RTN W{w_bit}
    g{group} asymmetric sites, fused (qkv, gateup) unless fuse=False."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layers, metas = {}, {}
    for site, sh in _llama_sites(cfg).items():
        layers[site] = _one_layer(_packed(_normal(sh, gen, device), w_bit, group))
        metas[site] = (w_bit, group, sh[0], sh[1])
    packed, qmeta = _model(layers, metas, cfg, (w_bit, group, cfg.hidden_size, cfg.vocab_size),
                           gen, device)
    if fuse:
        packed, qmeta = fuse_packed_sites(packed, qmeta)
    packed["layers"] = _tile(packed["layers"], cfg.num_layers)
    return packed, qmeta


def tiled_packed_moe(cfg, w_bit: int = 4, group: int = 128, device="cuda", seed: int = 0):
    """(packed_params, qmeta) for a Mixtral-style MoE ModelConfig: the
    attention sites as tiled_packed_llama's (unfused, as qtpu's), a bf16
    router, and one random weight per expert site copied to the E experts
    of a layer, the layer tiled over L."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    layers = {"router": {"w": _normal((D, E), gen, device)[None]}}
    metas = {}
    for site, sh in _llama_sites(cfg).items():
        if site in ("q_proj", "k_proj", "v_proj", "o_proj"):
            layers[site] = _one_layer(_packed(_normal(sh, gen, device), w_bit, group))
            metas[site] = (w_bit, group, sh[0], sh[1])
    for site, sh in {"exp_gate": (D, F), "exp_up": (D, F), "exp_down": (F, D)}.items():
        one = _packed(_normal(sh, gen, device), w_bit, group)
        layers[site] = {k: v.expand(E, *v.shape).contiguous()[None] for k, v in one.items()}
        metas[site] = (w_bit, group, sh[0], sh[1])
    packed, qmeta = _model(layers, metas, cfg, (w_bit, group, D, cfg.vocab_size), gen, device)
    packed["layers"] = _tile(packed["layers"], cfg.num_layers)
    return packed, qmeta


def tiled_w8a8_llama(cfg, device="cuda", seed: int = 0):
    """(packed_params, qmeta) with per-channel int8 weights (one group
    spanning K) and 5-tuple ("a8") metas: the W8A8 serving layout, which
    ops.linear sends to K6 with per-token activation quantization."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layers, metas = {}, {}
    for site, sh in _llama_sites(cfg).items():
        layers[site] = _one_layer(_packed(_normal(sh, gen, device), 8, sh[0]))
        metas[site] = (8, sh[0], sh[0], sh[1], "a8")
    D, V = cfg.hidden_size, cfg.vocab_size
    packed, qmeta = _model(layers, metas, cfg, (8, D, D, V, "a8"), gen, device)
    packed["layers"] = _tile(packed["layers"], cfg.num_layers)
    return packed, qmeta
