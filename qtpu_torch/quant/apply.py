"""Model-level quantization (port of the RTN branch of qtpu/quant/apply.py:
`_map_sites`, `quantize_model`, `pack_model`, `fold_smooth`,
`fuse_packed_sites`).

`quantize_model(params, "rtn", mcfg)` fake-quantizes every linear site
with `pseudo_quantize` in reference orientation: a [K, N] weight is
quantized as w.T, so its groups run along K, the input dim.
`pack_model(params, "rtn", mcfg)` packs every linear site of the stacked
[L, K, N] params with asymmetric per-group RTN (quantize_pack, layer by
layer, so the bytes equal qtpu's vmapped pack) and returns (packed params,
qmeta), qmeta being qtpu's sorted tuple of (site, (bits, group, K, N)).
`fold_smooth` folds per-site input "smooth" vectors into the adjacent
norms and scales. `fuse_packed_sites` concatenates q/k/v into "qkv_proj"
and gate/up into "gateup_proj". The other methods (awq, smoothquant, gptq,
pot, apot) come with the quantizers slice.
"""

from __future__ import annotations

import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.models import get_arch
from qtpu_torch.quant.rtn import pseudo_quantize

UNPORTED_METHODS = ("awq", "gptq", "pot", "apot", "smoothquant")


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


def _not_ported(method: str):
    if method in UNPORTED_METHODS:
        raise NotImplementedError(f"method '{method}' is not ported yet (quantizers slice)")


def quantize_model(params: dict, method: str, mcfg: dict, stats=None, arch: str = "llama") -> dict:
    """Fake-quantize every linear site of a model with `method` (rtn only).
    Returns a new params tree; the input is not modified. Stacked sites are
    quantized one layer at a time into a preallocated output, which bounds
    the f32 temporaries to one layer's weight."""
    _not_ported(method)
    if method != "rtn":
        raise ValueError(f"unknown quantization method '{method}'")
    arch_mod = get_arch(arch)
    w_bit = int(mcfg["w_bit"])
    g = int(mcfg.get("q_group_size", -1))

    def one(w_kn):
        return pseudo_quantize(w_kn.T, n_bit=w_bit, q_group_size=g).T

    def fn(site, w, has_l):
        if not has_l:
            return {"w": one(w)}
        out = torch.empty_like(w)
        for l in range(w.shape[0]):
            out[l] = one(w[l])
        return {"w": out}

    return _map_sites(params, fn, arch_mod)


def pack_model(params: dict, method: str, mcfg: dict, stats=None, arch: str = "llama"):
    """Really-pack a model's linear sites for serving. Returns (packed,
    qmeta). Only method="rtn" is ported."""
    _not_ported(method)
    if method != "rtn":
        raise ValueError(f"pack_model does not support method '{method}'")
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


def fold_smooth(packed: dict, qmeta, arch: str = "llama"):
    """Fold per-site input "smooth" vectors into adjacent parameters, as
    qtpu does (all exact in f32, one bf16 rounding of the folded tensor):
      * q/k/v smooth (identical across the group) -> attn_norm weight
      * gate/up smooth -> mlp_norm weight
      * lm_head smooth -> final_norm weight
      * down_proj smooth s -> the up_proj output columns: silu(g) * (up s)
        == (silu(g) * up) s, so the packed up_proj scales absorb s
      * o_proj smooth stays: under GQA a per-q-head vector cannot move onto
        the shared KV head's V columns.
    Other arches keep their runtime smooth vectors. Returns (packed, qmeta);
    qmeta is unchanged."""
    if arch != "llama":
        return packed, qmeta
    layers = dict(packed["layers"])
    out = dict(packed)

    def identical(names):
        vs = [layers.get(n, {}).get("smooth") for n in names if n in layers]
        if not vs or any(v is None for v in vs):
            return None
        if any(v.shape != vs[0].shape for v in vs[1:]):
            return None
        if len(vs) == 1 or all(bool(torch.equal(v, vs[0])) for v in vs[1:]):
            return vs[0]
        return None

    def strip(names):
        for n in names:
            if n in layers and "smooth" in layers[n]:
                site = dict(layers[n])
                del site["smooth"]
                layers[n] = site

    def fold_norm(norm_key, s):
        w = layers[norm_key].float() * s.float()
        layers[norm_key] = w.to(packed["layers"][norm_key].dtype)

    for names, norm_key in ((("q_proj", "k_proj", "v_proj"), "attn_norm"),
                            (("gate_proj", "up_proj"), "mlp_norm")):
        s = identical(names)
        if s is not None and norm_key in layers:
            fold_norm(norm_key, s)
            strip(names)

    down, up = layers.get("down_proj"), layers.get("up_proj")
    if (isinstance(down, dict) and "smooth" in down and isinstance(up, dict)
            and "scales" in up and "codebook" not in up):
        s = down["smooth"].float()  # [L, F]
        up = dict(up)
        up["scales"] = (up["scales"].float() * s[:, None, :]).to(up["scales"].dtype)
        layers["up_proj"] = up
        strip(("down_proj",))

    head = packed.get("lm_head")
    if isinstance(head, dict) and "smooth" in head and "final_norm" in packed:
        fn_w = packed["final_norm"].float() * head["smooth"].float()
        out["final_norm"] = fn_w.to(packed["final_norm"].dtype)
        head = dict(head)
        del head["smooth"]
        out["lm_head"] = head

    out["layers"] = layers
    return out, qmeta


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
