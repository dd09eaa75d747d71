"""Model-level quantization (port of qtpu/quant/apply.py for the methods
rtn, awq, gptq, pot, apot and smoothquant: `_map_sites`, `quantize_model`,
`pack_model`, `fold_smooth`, `fuse_packed_sites`).

`quantize_model(params, method, mcfg, stats)` fake-quantizes every linear
site in reference orientation: a [K, N] weight is quantized as w.T, so its
groups run along K, the input dim. Stacked sites go one layer at a time
into a preallocated output (bounding the f32 temporaries to one layer),
except GPTQ's compensated sweep, which advances a chunk of layers in
lockstep (qtpu's lax.map batch, chunked by qtpu's formula).
`pack_model(params, method, mcfg, stats)` packs the sites for serving and
returns (packed params, qmeta), qmeta being qtpu's sorted tuple of
(site, (bits, group, K, N)), with SmoothQuant's W8A8 sites as
(8, K, K, N, "a8"). The per-site input vectors are qtpu's: AWQ's
protection and SmoothQuant's smoothing become an input "smooth" vector,
GPTQ's actorder a "perm". POT/APOT pack W4 codebook sites: int4 codes in
the W4 layout, bf16 scales and an f32 "codebook" of levels. `fold_smooth`
folds the smooth vectors into the adjacent norms and scales;
`fuse_packed_sites` concatenates q/k/v into "qkv_proj" and gate/up into
"gateup_proj" (OPT: q/k/v only). On MoE models (arch "moe") every method
quantizes and packs the expert sites as a flat L*E layer axis into [L, E,
...] leaves, with qtpu's statistics view of the same layer-major order
(`_expert_stats_view`); their smooth vectors stay per expert, [L, E, K].
The router and Qwen2-MoE's shared-expert gate stay dense when packed.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.calib.stats import CalibStats
from qtpu_torch.core.packing import pack_int4, quantize_pack
from qtpu_torch.models import get_arch
from qtpu_torch.quant.apot import apot_quantize_codes, apot_quantize_tensor
from qtpu_torch.quant.awq import _protection_scale_vec, awq_quantize, awq_search_scale_factor
from qtpu_torch.quant.gptq import (
    _parity_column_quantize,
    actorder_perm,
    build_proxy_hessian,
    check_packed_export,
    gptq_column_sweep,
    gptq_prepare_factor,
    gptq_prepare_factor_lowrank,
    gptq_quantize_layer,
    proxy_hessian_diag,
)
from qtpu_torch.quant.parity_grids import PARITY_GRIDS, PARITY_RANGE
from qtpu_torch.quant.pot import pot_codebook, pot_quantize_codes, pot_quantize_tensor
from qtpu_torch.quant.rtn import pseudo_quantize, symmetric_fake_quantize
from qtpu_torch.quant.smoothquant import (
    compute_smoothing_scales,
    search_alpha,
    smooth_weights,
    smoothing_from_max,
)

CALIBRATED_METHODS = ("awq", "gptq", "smoothquant")
# qtpu's layer-chunk budget for GPTQ's batched sweep (apply.py:288, :711)
GPTQ_CHUNK_BYTES = 1.5e9


def _input_site_of(linear_site: str, arch) -> str:
    for in_site, linears in arch.SITE_OF_INPUT.items():
        if linear_site in linears:
            return in_site
    raise KeyError(linear_site)


def _gptq_chunk(K: int, N: int) -> int:
    """Layers per batched GPTQ sweep, qtpu's formula."""
    return max(1, min(8, int(GPTQ_CHUNK_BYTES // (K * K * 16 + K * N * 16))))


def _expert_stats_view(stats, E: int, expert_inputs, keep=None):
    """qtpu's `_expert_stats_view` (apply.py:83-111): the CalibStats of an
    [L*E]-flattened expert site, in the weights' layer-major order (l0e0,
    l0e1, ...). Per-expert input sites ([.., L, E, C]) merge L and E;
    shared-input sites ([.., L, C], one vector for all E experts of a
    layer) repeat each layer's vector E times; head_in passes through.
    keep: the input sites to view (default all, as qtpu); the others are
    left out, so the repeated Hessians of sites no expert reads are not
    made."""
    if stats is None:
        return None

    def fix(d, lead):
        out = {}
        for site, a in d.items():
            if keep is not None and site not in keep:
                continue
            if site == "head_in":
                out[site] = a
            elif site in expert_inputs:
                out[site] = a.reshape(*a.shape[:lead], a.shape[lead] * a.shape[lead + 1],
                                      *a.shape[lead + 2:])
            else:
                out[site] = a.repeat_interleave(E, dim=lead)
        return out

    return CalibStats(mean_abs=fix(stats.mean_abs, 1), max_abs=fix(stats.max_abs, 0),
                      hessian=None if stats.hessian is None else fix(stats.hessian, 0),
                      n_batches=stats.n_batches)


def _map_sites(params: dict, fn, arch, stats=None) -> dict:
    """Apply fn(site, w_kn, has_layer_axis, stats) to every linear site's
    dense weight; extras the function does not produce (biases) carry over.
    Optional sites the model lacks are skipped. MoE expert sites ([L, E, K,
    N], arch.EXPERT_SITES) are flattened to an [L*E, K, N] layer axis around
    fn, with the matching statistics view (of their own input sites), and
    every leaf fn produces is reshaped back to [L, E, ...]."""
    expert_sites = set(getattr(arch, "EXPERT_SITES", ()))
    expert_inputs = set(getattr(arch, "EXPERT_INPUT_SITES", ()))
    views = {}

    def rebuild(site, old, has_l):
        if site in expert_sites:
            w = old["w"]
            L, E = w.shape[:2]
            if E not in views:
                keep = {_input_site_of(s, arch) for s in expert_sites}
                views[E] = _expert_stats_view(stats, E, expert_inputs, keep)
            out = fn(site, w.reshape(L * E, *w.shape[2:]), True, views[E])
            out = {k: v.reshape(L, E, *v.shape[1:]) for k, v in out.items()}
        else:
            out = fn(site, old["w"], has_l, stats)
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


def _parity_grid(mcfg: dict, default_step: float, n_elements: int | None = None) -> tuple:
    """The candidate multipliers of the POT/APOT scale search, qtpu's rule:
    the frozen reference grids (parity_grids) for the reference range and
    step, where the step defaults to 0.01 (POT) or, for APOT, 0.1 above
    500k elements of the site and 0.05 otherwise (unless reference_grid is
    false); np.arange's f32 values for a grid_step / grid_search_range
    override."""
    lo, hi = mcfg.get("grid_search_range", [0.01, 2.01])
    step = mcfg.get("grid_step")
    if step is None:
        step = default_step
        if n_elements is not None and bool(mcfg.get("reference_grid", True)):
            step = 0.1 if n_elements > 500_000 else 0.05
    if (float(lo), float(hi)) == PARITY_RANGE and float(step) in PARITY_GRIDS:
        return PARITY_GRIDS[float(step)]
    vals = np.arange(float(lo), float(hi), float(step)).astype(np.float32)
    return tuple(float(v) for v in vals)


def _per_layer(one, w, has_l, out_dtype=None):
    """one(w_kn [K, N]) for each layer of a stacked [L, K, N] weight, into a
    preallocated output (out_dtype: the output's, default w's)."""
    if not has_l:
        return one(w)
    out = torch.empty(w.shape, dtype=out_dtype or w.dtype, device=w.device)
    for l in range(w.shape[0]):
        out[l] = one(w[l])
    return out


def _need_stats(method: str, stats, what: str):
    if stats is None:
        raise ValueError(f"{method} {what}requires calibration stats")


def quantize_model(params: dict, method: str, mcfg: dict, stats=None, arch: str = "llama") -> dict:
    """Fake-quantize every linear site of a model with `method` (rtn, awq,
    gptq, pot, apot, smoothquant; awq/gptq/smoothquant need CalibStats).
    Returns a new params tree; the input is not modified. SmoothQuant's
    sites also carry the per-input-channel "smooth" vector that keeps the
    network equivalent."""
    arch_mod = get_arch(arch)
    w_bit = int(mcfg["w_bit"])
    g = int(mcfg.get("q_group_size", -1))

    if method == "rtn":

        def fn(site, w, has_l, st):
            return {"w": _per_layer(lambda wl: pseudo_quantize(wl.T, w_bit, g).T, w, has_l)}

    elif method == "pot":
        gv = _parity_grid(mcfg, 0.01)

        def fn(site, w, has_l, st):
            return {"w": _per_layer(
                lambda wl: pot_quantize_tensor(wl.T, w_bit, g, grid_values=gv).T, w, has_l)}

    elif method == "apot":
        k = int(mcfg.get("k", 2))

        def fn(site, w, has_l, st):
            # the reference grid coarsens per site by its element count
            gv = _parity_grid(mcfg, 0.05, w.shape[-2] * w.shape[-1])
            return {"w": _per_layer(
                lambda wl: apot_quantize_tensor(wl.T, w_bit, g, k, grid_values=gv).T, w, has_l)}

    elif method == "awq":
        _need_stats(method, stats, "")
        protect = float(mcfg.get("protect_ratio", 0.01))
        sf = float(mcfg.get("scale_factor", 1.0))
        do_search = bool(mcfg.get("search_scale", False))

        def fn(site, w, has_l, st):
            try:
                imp = st.importance(_input_site_of(site, arch_mod))
            except KeyError:
                return {"w": w}  # no calibration data: keep the weight

            def one(w_kn, imp_l):
                w_oi = w_kn.T
                sf_l = awq_search_scale_factor(w_oi, imp_l, w_bit, g, protect) if do_search else sf
                return awq_quantize(w_oi, imp_l, w_bit, g, protect, sf_l).T

            if not has_l:
                return {"w": one(w, imp)}
            out = torch.empty_like(w)
            for l in range(w.shape[0]):
                out[l] = one(w[l], imp[l])
            return {"w": out}

    elif method == "gptq":
        _need_stats(method, stats, "")
        comp = bool(mcfg.get("error_compensation", False))
        actorder = bool(mcfg.get("actorder", False))
        damp = float(mcfg.get("perp_damp", 0.01))
        blocksize = int(mcfg.get("blocksize", 128))
        nsamples = int(mcfg.get("nsamples", 128))

        def fn(site, w, has_l, st):
            try:
                in_site = _input_site_of(site, arch_mod)
                have = in_site in st.mean_abs or (st.hessian is not None and in_site in st.hessian)
            except KeyError:
                have = False
            if not have:  # no stats: symmetric per-group RTN (the reference's fallback)
                return {"w": _per_layer(lambda wl: symmetric_fake_quantize(wl.T, w_bit, g).T,
                                        w, has_l)}
            if not comp:  # parity mode, f32 as qtpu leaves it
                return {"w": _per_layer(lambda wl: _parity_column_quantize(wl.T, w_bit).T, w,
                                        has_l, torch.float32)}
            have_true_h = st.hessian is not None and in_site in st.hessian
            if have_true_h:
                hs = st.hessian[in_site]
            else:
                mv = st.mean_abs[in_site][:nsamples]  # [S, L, C] | [S, C]
                hs = mv.transpose(0, 1) if has_l else mv
            if has_l and not actorder:
                # prepare + sweep a chunk of layers at a time, the column
                # loop advancing the whole chunk in lockstep
                K, N = w.shape[-2:]
                chunk = _gptq_chunk(K, N)
                out = torch.empty_like(w)
                for l0 in range(0, w.shape[0], chunk):
                    h = hs[l0:l0 + chunk]
                    if have_true_h:
                        U = gptq_prepare_factor(h, damp)
                    elif h.shape[-2] < K:
                        U = gptq_prepare_factor_lowrank(h, damp)
                    else:
                        U = gptq_prepare_factor(build_proxy_hessian(h, damp), damp)
                    wq = w[l0:l0 + chunk].transpose(-1, -2).float()
                    out[l0:l0 + chunk] = gptq_column_sweep(wq, U, w_bit, g, blocksize,
                                                           orig_dtype=w.dtype).transpose(-1, -2)
                    del U, wq
                return {"w": out}

            def one(w_kn, h):
                return gptq_quantize_layer(
                    w_kn.T, h if have_true_h else None, w_bit, q_group_size=g,
                    perp_damp=damp, blocksize=blocksize, actorder=actorder,
                    error_compensation=True, stat_vectors=None if have_true_h else h,
                ).T

            if not has_l:
                return {"w": one(w, hs)}
            out = torch.empty_like(w)
            for l in range(w.shape[0]):
                out[l] = one(w[l], hs[l])
            return {"w": out}

    elif method == "smoothquant":
        _need_stats(method, stats, "")
        alpha = mcfg.get("alpha", 0.5)
        do_search = bool(mcfg.get("search_alpha", False))

        def fn(site, w, has_l, st):
            try:
                amax = st.max_abs[_input_site_of(site, arch_mod)]
            except KeyError:
                # no activation maxima: RTN without smoothing
                return {"w": _per_layer(lambda wl: pseudo_quantize(wl.T, w_bit, g).T, w, has_l)}

            def one(w_kn, amax_l):
                w_oi = w_kn.T
                a = search_alpha(w_oi, amax_l, w_bit, g) if do_search else alpha
                s = compute_smoothing_scales(amax_l, w_oi, a)
                return pseudo_quantize(smooth_weights(w_oi, s), w_bit, g).T, s

            if not has_l:
                q, s = one(w, amax)
                return {"w": q, "smooth": s}
            q = torch.empty_like(w)
            s = torch.empty(w.shape[:-1], dtype=torch.float32, device=w.device)
            for l in range(w.shape[0]):
                q[l], s[l] = one(w[l], amax[l])
            return {"w": q, "smooth": s}

    else:
        raise ValueError(f"unknown quantization method '{method}'")

    return _map_sites(params, fn, arch_mod, stats)


def _pack_affine(w_kn, w_bit: int, g: int) -> dict:
    qt = quantize_pack(w_kn, w_bit, g, symmetric=False)
    return {"data": qt.data, "scales": qt.scales, "zeros": qt.zeros}


def _stack(parts: list) -> dict:
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def pack_model(params: dict, method: str, mcfg: dict, stats=None, arch: str = "llama"):
    """Really-pack a model's linear sites for serving. Returns (packed,
    qmeta). rtn: asymmetric per-group RTN. awq: the protection vector v
    scales the weight (v ∘ W packed) and 1/v becomes the input smooth.
    smoothquant: the smoothed weight packed, its smoothing vector the
    input smooth; sites sharing an input (q/k/v, gate/up) share one vector
    from the group's weight-column max, so it folds into the norm and the
    sites fuse; with act_quant (w_bit 8) per-channel W8 sites served W8A8
    ("a8" metas, K6). gptq: error-compensated integer export, with
    actorder the column order stored as "perm" (the activations are
    gathered at serve time). pot/apot (W4 only): codebook sites {"data":
    int4 codes, "scales": bf16 [K/g, N], "codebook": f32 levels}, served by
    K7. MoE expert sites pack per expert, their smooth vectors [L, E, K]."""
    arch_mod = get_arch(arch)
    w_bit = int(mcfg["w_bit"])
    g = int(mcfg.get("q_group_size", 128))
    if g <= 0:
        raise ValueError("packing requires a positive q_group_size")
    if method not in ("rtn", "pot", "apot") + CALIBRATED_METHODS:
        raise ValueError(f"pack_model does not support method '{method}'")
    if method in CALIBRATED_METHODS:
        _need_stats(method, stats, "packing ")
    metas = {}

    # smoothquant: the shared weight-column max of each multi-linear input
    # group; expert sites keep per-site vectors (their statistics differ per
    # expert) and the dense sites stay out, as in qtpu
    group_colmax = {}
    if method == "smoothquant":
        skip = (set(getattr(arch_mod, "EXPERT_SITES", ()))
                | set(getattr(arch_mod, "PACK_DENSE_SITES", ())) | {"lm_head"})
        for _in, linears in arch_mod.SITE_OF_INPUT.items():
            members = [n for n in linears if n not in skip and n in params["layers"]]
            if len(members) < 2:
                continue
            cm = torch.stack([params["layers"][n]["w"].abs().amax(dim=-1) for n in members])
            cm = cm.amax(dim=0)  # [L, K]
            for n in members:
                group_colmax[n] = cm

    def fn(site, w, has_l, st):
        if site in getattr(arch_mod, "PACK_DENSE_SITES", ()):
            return {"w": w}  # the MoE router / shared-expert gate: narrow, kept dense
        K, N = w.shape[-2:]
        if method == "gptq":
            metas[site] = (w_bit, g, K, N)
            return _pack_gptq(site, w, has_l, st, mcfg, w_bit, g, arch_mod)
        if method in ("pot", "apot"):
            metas[site] = (w_bit, g, K, N)
            return _pack_codebook(method, w, has_l, mcfg, w_bit, g)
        smooth = None
        if method == "rtn":
            w_eff = w
        elif method == "awq":
            protect = float(mcfg.get("protect_ratio", 0.01))
            sf = float(mcfg.get("scale_factor", 1.0))
            v = _protection_scale_vec(st.importance(_input_site_of(site, arch_mod)), protect, sf)
            # y = (x · (1/v)) @ Q(v ∘ W): the protection folds into the input smooth
            w_eff = w * v[..., :, None]
            smooth = 1.0 / v
        else:  # smoothquant
            amax = st.max_abs[_input_site_of(site, arch_mod)]
            wmax = group_colmax.get(site)
            if wmax is None:
                wmax = w.abs().amax(dim=-1)
            smooth = smoothing_from_max(amax, wmax, mcfg.get("alpha", 0.5))
            # smooth_weights(w.T, s).T, elementwise the same, every layer at once
            w_eff = (w.float() / smooth[..., :, None]).to(w.dtype)
            if mcfg.get("act_quant", False):
                # W8A8: per-channel int8 weights (one group spanning K) and
                # dynamic per-token int8 activations at serve time
                if w_bit != 8:
                    raise ValueError("act_quant requires w_bit=8")
                p = (_stack([_pack_affine(w_eff[l], 8, K) for l in range(w.shape[0])])
                     if has_l else _pack_affine(w_eff, 8, K))
                p["smooth"] = smooth
                metas[site] = (8, K, K, N, "a8")
                return p
        p = (_stack([_pack_affine(w_eff[l], w_bit, g) for l in range(w.shape[0])])
             if has_l else _pack_affine(w_eff, w_bit, g))
        if smooth is not None:
            p["smooth"] = smooth
        metas[site] = (w_bit, g, K, N)
        return p

    packed = _map_sites(params, fn, arch_mod, stats)
    return packed, tuple(sorted(metas.items()))


def _pack_codebook(method, w, has_l, mcfg, w_bit, g) -> dict:
    """pack_model's pot/apot branch: W4 codes packed as group-halves, bf16
    scales, the f32 level table ([L, n_levels] stacked, [n_levels] for
    lm_head), one layer at a time."""
    if w_bit != 4:
        raise ValueError("codebook packing supports w_bit=4 only")
    pot = method == "pot"
    gv = _parity_grid(mcfg, 0.01 if pot else 0.05,
                      None if pot else w.shape[-2] * w.shape[-1])

    def one(w_kn):
        if pot:
            codes, sc = pot_quantize_codes(w_kn, w_bit, g, grid_values=gv)
            cb = pot_codebook(w_bit, device=w_kn.device)
        else:
            codes, sc, cb = apot_quantize_codes(w_kn, w_bit, g, int(mcfg.get("k", 2)),
                                                grid_values=gv)
        return {"data": pack_int4(codes, g), "scales": sc.to(torch.bfloat16), "codebook": cb}

    return _stack([one(w[l]) for l in range(w.shape[0])]) if has_l else one(w)


def _pack_gptq(site, w, has_l, st, mcfg, w_bit, g, arch_mod) -> dict:
    """pack_model's gptq branch: error-compensated GPTQ with integer export
    ([K, N] codes packed as W4 group-halves or biased W8, bf16 scales,
    uint8 zeros), a chunk of layers per batched sweep."""
    in_site = _input_site_of(site, arch_mod)
    damp = float(mcfg.get("perp_damp", 0.01))
    nsamples = int(mcfg.get("nsamples", 128))
    actorder = bool(mcfg.get("actorder", False))
    shards = int(mcfg.get("actorder_shards", 1))
    K, N = w.shape[-2:]
    bs = check_packed_export(w_bit, g, int(mcfg.get("blocksize", 128)), actorder, shards, K)
    have_true_h = st.hessian is not None and in_site in st.hessian
    if have_true_h:
        hs = st.hessian[in_site]
    else:  # stat vectors [S, C] per layer; the proxy Hessian forms per chunk
        mv = st.mean_abs[in_site][:nsamples]
        hs = mv.transpose(0, 1) if has_l else mv

    def order(h):
        d = torch.diagonal(h.float(), dim1=-2, dim2=-1) if have_true_h else proxy_hessian_diag(h, damp)
        return actorder_perm(d, shards)

    def chunk_pack(w_kn, h):
        """w_kn [Lc, K, N], h [Lc, C, C] or [Lc, S, C] -> packed leaves."""
        w_oi = w_kn.transpose(-1, -2).float()
        perm = None
        if actorder:
            perm = order(h)
            idx = perm.long()
            w_oi = torch.take_along_dim(w_oi, idx[:, None, :], dim=-1)
        if have_true_h or h.shape[-2] >= h.shape[-1]:
            hh = h.float() if have_true_h else build_proxy_hessian(h, damp)
            if perm is not None:
                hh = torch.take_along_dim(hh, idx[:, :, None], dim=-2)
                hh = torch.take_along_dim(hh, idx[:, None, :], dim=-1)
            U = gptq_prepare_factor(hh, damp)
        else:
            vv = h if perm is None else torch.take_along_dim(h, idx[:, None, :], dim=-1)
            U = gptq_prepare_factor_lowrank(vv, damp)
        _, q, s_all, z_all = gptq_column_sweep(w_oi, U, w_bit, g, bs, return_ints=True,
                                               orig_dtype=w.dtype)
        codes = q.transpose(-1, -2).to(torch.uint8).contiguous()  # [Lc, K, N]
        if w_bit == 4:
            data = torch.stack([pack_int4(c, g) for c in codes])
        else:
            data = (codes.to(torch.int32) - 128).to(torch.int8)
        out = {"data": data, "scales": s_all.transpose(-1, -2).to(torch.bfloat16).contiguous(),
               "zeros": z_all.transpose(-1, -2).to(torch.uint8).contiguous()}
        if perm is not None:
            out["perm"] = perm
        return out

    if not has_l:
        return {k: v[0] for k, v in chunk_pack(w[None], hs[None]).items()}
    chunk = _gptq_chunk(K, N)
    parts = [chunk_pack(w[l0:l0 + chunk], hs[l0:l0 + chunk])
             for l0 in range(0, w.shape[0], chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


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


SHARED_KEYS = ("smooth", "perm", "codebook")  # applied to the shared input


def fuse_packed_sites(packed: dict, qmeta, arch: str = "llama"):
    """Fuse packed sites that share an input into one wider matmul (llama:
    q/k/v -> qkv_proj, gate/up -> gateup_proj; OPT: q/k/v -> qkv_proj, biases
    concatenated; GPT-2's c_attn is one site already). Sites fuse only when
    every member is packed with the same keys and the same (bits, group, K),
    and the keys applied to the shared input (smooth, perm) are equal across
    the group: one copy is kept. W8A8 ("a8") sites never fuse. Returns
    (fused params, fused qmeta)."""
    layers = dict(packed["layers"])
    if arch == "llama" and "o_proj" in layers and "gate_proj" in layers:
        fuse_groups = [
            (("q_proj", "k_proj", "v_proj"), "qkv_proj"),
            (("gate_proj", "up_proj"), "gateup_proj"),
        ]
    elif arch == "opt" and "out_proj" in layers and "fc1" in layers:
        fuse_groups = [(("q_proj", "k_proj", "v_proj"), "qkv_proj")]
    else:
        return packed, qmeta
    meta = dict(qmeta)

    def shared_equal(parts, key):
        present = [key in p for p in parts]
        if not any(present):
            return True
        if not all(present):
            return False
        s0 = parts[0][key]
        return all(p[key].shape == s0.shape and bool(torch.equal(p[key], s0)) for p in parts[1:])

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
        return all(shared_equal(parts, key) for key in SHARED_KEYS)

    for names, fused_name in fuse_groups:
        if not fusable(names):
            continue
        parts = [layers[n] for n in names]
        fused = {
            k: torch.cat([p[k] for p in parts], dim=-1)
            for k in parts[0]
            if k not in SHARED_KEYS and parts[0][k] is not None
        }
        for shared in SHARED_KEYS:
            if shared in parts[0]:
                fused[shared] = parts[0][shared]  # equal across the group
        bits, g, K, _ = meta[names[0]]
        N = sum(meta[n][3] for n in names)
        for n in names:
            del layers[n], meta[n]
        layers[fused_name] = fused
        meta[fused_name] = (bits, g, K, N)
    out = dict(packed)
    out["layers"] = layers
    return out, tuple(sorted(meta.items()))
