"""Model-level packing for serving (port of the RTN branch of
qtpu/quant/apply.py: `_map_sites`, `pack_model`, `fuse_packed_sites`).

`pack_model(params, "rtn", mcfg)` packs every linear site of the stacked
[L, K, N] params with asymmetric per-group RTN (quantize_pack, layer by
layer, so the bytes equal qtpu's vmapped pack) and returns (packed params,
qmeta), qmeta being qtpu's sorted tuple of (site, (bits, group, K, N)).
`fuse_packed_sites` concatenates q/k/v into "qkv_proj" and gate/up into
"gateup_proj". The other methods (awq, smoothquant, gptq, pot, apot),
`quantize_model` and `fold_smooth` come with the quantizers slice.
"""

from __future__ import annotations

import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.models import get_arch


def _map_sites(params: dict, fn, arch) -> dict:
    """Apply fn(site, w_kn, has_layer_axis) to every linear site's dense
    weight; extras the function does not produce (biases) carry over."""

    def rebuild(site, old, has_l):
        out = fn(site, old["w"], has_l)
        for k in old:
            if k not in out and k != "w":
                out[k] = old[k]
        return out

    new = dict(params)
    new_layers = dict(params["layers"])
    for site in arch.LAYER_SITES:
        if site in params["layers"]:
            new_layers[site] = rebuild(site, params["layers"][site], True)
    new["layers"] = new_layers
    new["lm_head"] = rebuild("lm_head", params["lm_head"], False)
    return new


def pack_model(params: dict, method: str, mcfg: dict, stats=None, arch: str = "llama"):
    """Really-pack a model's linear sites for serving. Returns (packed,
    qmeta). Only method="rtn" is ported."""
    if method != "rtn":
        raise NotImplementedError(
            f"pack_model method '{method}' is not ported yet (quantizers slice)"
        )
    arch_mod = get_arch(arch)
    w_bit = int(mcfg["w_bit"])
    g = int(mcfg.get("q_group_size", 128))
    if g <= 0:
        raise ValueError("packing requires a positive q_group_size")
    metas = {}

    def pack_one(w_kn):
        qt = quantize_pack(w_kn, w_bit, g, symmetric=False)
        return {"data": qt.data, "scales": qt.scales, "zeros": qt.zeros}

    def fn(site, w, has_l):
        if has_l:
            parts = [pack_one(w[l]) for l in range(w.shape[0])]
            p = {k: torch.stack([pt[k] for pt in parts]) for k in parts[0]}
        else:
            p = pack_one(w)
        metas[site] = (w_bit, g, w.shape[-2], w.shape[-1])
        return p

    packed = _map_sites(params, fn, arch_mod)
    return packed, tuple(sorted(metas.items()))


def fuse_packed_sites(packed: dict, qmeta, arch: str = "llama"):
    """Fuse packed sites that share an input into one wider matmul (llama:
    q/k/v -> qkv_proj, gate/up -> gateup_proj). Sites fuse only when every
    member is packed with the same keys and the same (bits, group, K).
    Returns (fused params, fused qmeta)."""
    layers = dict(packed["layers"])
    if not (arch == "llama" and "o_proj" in layers and "gate_proj" in layers):
        return packed, qmeta
    fuse_groups = [
        (("q_proj", "k_proj", "v_proj"), "qkv_proj"),
        (("gate_proj", "up_proj"), "gateup_proj"),
    ]
    meta = dict(qmeta)

    def fusable(names):
        parts = [layers.get(n) for n in names]
        if not all(isinstance(p, dict) and "data" in p for p in parts):
            return False
        if any(set(p.keys()) != set(parts[0].keys()) for p in parts[1:]):
            return False
        if any(len(meta[n]) != 4 for n in names):
            return False
        if any(meta[n][:3] != meta[names[0]][:3] for n in names[1:]):
            return False
        # input-side keys (later slices) fuse only when shared; none here
        return not any(k in parts[0] for k in ("smooth", "perm", "codebook"))

    for names, fused_name in fuse_groups:
        if not fusable(names):
            continue
        parts = [layers[n] for n in names]
        fused = {
            k: torch.cat([p[k] for p in parts], dim=-1)
            for k in parts[0]
            if parts[0][k] is not None
        }
        bits, g, K, _ = meta[names[0]]
        N = sum(meta[n][3] for n in names)
        for n in names:
            del layers[n], meta[n]
        layers[fused_name] = fused
        meta[fused_name] = (bits, g, K, N)
    out = dict(packed)
    out["layers"] = layers
    return out, tuple(sorted(meta.items()))
