"""Megatron tensor parallelism as per-rank local shards (port of
qtpu/sharding/specs.py).

`param_specs` is the one table: each model family declares its
ROW_PARALLEL_SITES (the input dim K splits, the all-reduce side); every
other linear site is column-parallel (the output dim N splits). data /
scales / zeros split on the same dim, a smooth vector follows K, a bias
follows N on a column-parallel site and is replicated on a row-parallel
one; a codebook is replicated; the expert sites of the MoE family split on
their expert axis E; PACK_DENSE_SITES (the MoE routers) are replicated. A
spec is a tuple with one entry per dim, the mesh axis name or None, as a
PartitionSpec. It is qtpu's table but for two leaves, because the port
holds plain local tensors where qtpu had GSPMD: the embedding stays whole
(qtpu splits its hidden dim; the port's residual stream is replicated),
and a row-parallel site's actorder perm splits with K (qtpu replicates it).

`shard_params` cuts a whole params tree (raw or packed, fused or not) into
one rank's local tree of plain tensors, slicing each leaf on the dim its
spec names "model". GSPMD hid four things from qtpu that the port does
itself:
  * fused sites are split per member: qkv_proj holds [q_r | k_r | v_r],
    gateup_proj [gate_r | up_r], GPT-2's c_attn and OPT's qkv_proj
    [q_r | k_r | v_r], never a plain slice of the fused N;
  * a packed row-parallel site splits K at group boundaries (W4's
    group-halves and W2's group-quarters keep a group's bytes in
    contiguous rows), so (K / tp) % group must be 0;
  * where tp exceeds the KV heads and is a multiple of their count, each
    rank holds the one KV head its q heads read (replicated over the
    tp / KV ranks that share it): k_proj / v_proj and the k and v members
    of a fused site are cut by KV head, not in tp slices of kv_dim (qtpu's
    GSPMD splits kv_dim and reshards); the rank's cache holds one KV head;
  * where tp does not divide a dim the port needs divided (heads, KV heads
    that tp is not a multiple of, the MLP width, a fused member, the
    vocabulary, the experts, K / tp by the group) it raises ValueError
    naming the dim: GSPMD would pad or replicate there (qtpu's device_put
    raises on the vocabulary too);
  * a GPTQ actorder perm of a row-parallel site must be shard-local
    (actorder_shards == tp): each rank permutes its own slice of x.

`local_config` is the rank's ModelConfig (heads, KV heads and MLP widths
divided by tp; one KV head where tp exceeds them), so the model code that
splits by cfg.q_dim and cfg.intermediate_size runs unchanged; `shard_qmeta`
the rank's qmeta.
"""

from __future__ import annotations

import dataclasses

import torch


def _arch(arch: str):
    from qtpu_torch.models import get_arch

    return get_arch(arch)


def _site_spec(extra: int, row_parallel: bool) -> dict:
    lead = (None,) * extra
    if row_parallel:
        w, smooth, bias = (*lead, "model", None), (*lead, "model"), (*lead, None)
    else:
        w, smooth, bias = (*lead, None, "model"), (*lead, None), (*lead, "model")
    return {"w": w, "data": w, "scales": w, "zeros": w, "smooth": smooth, "b": bias,
            "codebook": (*lead, None), "perm": smooth}


def param_specs(params: dict, arch: str = "llama") -> dict:
    """The spec of every leaf of a (possibly packed) params tree: the table
    shard_params applies."""
    mod = _arch(arch)
    row_sites = set(getattr(mod, "ROW_PARALLEL_SITES", ()))
    expert_sites = set(getattr(mod, "EXPERT_SITES", ()))
    dense_sites = set(getattr(mod, "PACK_DENSE_SITES", ()))

    def site(name, p, extra):
        if name in expert_sites:
            return {k: (None, "model", *((None,) * (v.ndim - 2))) for k, v in p.items()}
        if name in dense_sites:
            return {k: (None,) * v.ndim for k, v in p.items()}
        table = _site_spec(extra, name in row_sites)
        return {k: table[k] for k in p}

    specs = {}
    for name, val in params.items():
        if name == "layers":
            specs[name] = {s: site(s, p, 1) if isinstance(p, dict) else (None, None)
                           for s, p in val.items()}
        elif name == "lm_head":
            specs[name] = site("lm_head", val, 0)
        else:  # the embedding, pos_embed, final norms: whole on every rank
            specs[name] = (None,) * val.ndim
    return specs


def _need(n: int, tp: int, what: str) -> None:
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {what} ({n})")


def kv_parts(cfg, tp: int) -> int:
    """Into how many parts the KV heads split over tp ranks: tp where tp
    divides them, their count where tp is a multiple of it (each rank then
    holds one KV head, rank r the head r * KV // tp that its q heads
    read); else ValueError naming num_kv_heads."""
    KV = cfg.num_kv_heads
    if KV % tp == 0:
        return tp
    if tp % KV:
        raise ValueError(f"tp={tp} does not divide num_kv_heads ({KV}) and is not a "
                         "multiple of it")
    return KV


def local_config(cfg, tp: int):
    """The ModelConfig of one of tp ranks: heads, KV heads (one where tp
    exceeds them, kv_parts), the MLP width (and a shared expert's) divided
    by tp; the expert count stays (the router sees every expert; each rank
    holds E / tp of them)."""
    if tp == 1:
        return cfg
    _need(cfg.num_heads, tp, "num_heads")
    kvp = kv_parts(cfg, tp)
    _need(cfg.vocab_size, tp, "vocab_size")
    kw = {"num_heads": cfg.num_heads // tp, "num_kv_heads": cfg.num_kv_heads // kvp}
    if cfg.arch == "moe":
        _need(cfg.num_experts, tp, "num_experts")
        if cfg.shared_expert_intermediate_size:
            _need(cfg.shared_expert_intermediate_size, tp, "shared_expert_intermediate_size")
            kw["shared_expert_intermediate_size"] = cfg.shared_expert_intermediate_size // tp
    else:
        _need(cfg.intermediate_size, tp, "intermediate_size")
        kw["intermediate_size"] = cfg.intermediate_size // tp
    return dataclasses.replace(cfg, **kw)


KV_SITES = ("k_proj", "v_proj")  # column-parallel sites of kv_dim outputs


def _segments(name: str, cfg, n: int, tp: int) -> list:
    """The members of a column-parallel site along N, each as (width, parts):
    a member splits into `parts` equal slices, rank r taking slice
    r * parts // tp (parts < tp: KV heads replicated over tp / parts ranks)."""
    if name == "qkv_proj" or name == "c_attn":
        if cfg is None:
            raise ValueError(f"sharding the fused site {name} needs the model config")
        kvp = kv_parts(cfg, tp)
        return [(cfg.q_dim, tp), (cfg.kv_dim, kvp), (cfg.kv_dim, kvp)]
    if name in KV_SITES:
        if cfg is None:
            raise ValueError(f"sharding {name} needs the model config (its KV heads)")
        return [(n, kv_parts(cfg, tp))]
    if name == "gateup_proj":
        return [(n // 2, tp), (n // 2, tp)]
    return [(n, tp)]


def _take(t: torch.Tensor, dim: int, members: list, r: int, tp: int, what: str) -> torch.Tensor:
    """Rank r's slice of each (width, parts) member along dim, concatenated."""
    out, off = [], 0
    for w, parts in members:
        _need(w, parts, what)
        s = w // parts
        out.append(t.narrow(dim, off + (r * parts // tp) * s, s))
        off += w
    return (out[0] if len(out) == 1 else torch.cat(out, dim=dim)).contiguous()


def shard_params(params: dict, mesh, arch: str = "llama", rank: int | None = None, cfg=None,
                 qmeta=None) -> dict:
    """This rank's local params tree of a whole (raw or packed) tree, each
    leaf cut on the dim that param_specs names "model".

    mesh: a DeviceMesh with a "model" dim (its size is tp, this rank's
    coordinate there the default `rank`), or an int tp with `rank` given.
    cfg: the whole ModelConfig (needed for fused sites); qmeta: the packed
    metas (needed to refuse a row-parallel W8A8 site). Leaves that stay
    whole are the same tensors, not copies."""
    from qtpu_torch.sharding.mesh import axis_rank, axis_size

    if isinstance(mesh, int):
        tp, r = mesh, rank
        if r is None:
            raise ValueError("shard_params with an int tp needs the rank")
    else:
        tp, r = axis_size(mesh, "model"), (axis_rank(mesh, "model") if rank is None else rank)
    if tp == 1:
        return params
    if cfg is not None:
        local_config(cfg, tp)  # the head / width checks
    mod = _arch(arch)
    row_sites = set(getattr(mod, "ROW_PARALLEL_SITES", ()))
    expert_sites = set(getattr(mod, "EXPERT_SITES", ()))
    meta = dict(qmeta) if qmeta is not None else {}

    def leaf(name, k, v, spec, groups):
        if v is None or "model" not in spec:
            return v
        dim = spec.index("model") - len(spec)
        n = v.shape[dim]
        if name in expert_sites:
            return _take(v, dim, [(n, tp)], r, tp, f"{name} experts")
        if name not in row_sites:
            return _take(v, dim, _segments(name, cfg, n, tp), r, tp, f"{name} N")
        if k in ("data", "scales", "zeros") and groups % tp:
            raise ValueError(f"row-parallel site {name}: K/tp is off a group boundary "
                             f"({groups} groups over tp={tp})")
        if k != "perm":
            return _take(v, dim, [(n, tp)], r, tp, f"{name}.{k}")
        Kl = n // tp
        loc = v.narrow(-1, r * Kl, Kl) - r * Kl
        if bool(((loc < 0) | (loc >= Kl)).any()):
            raise ValueError(f"the actorder perm of row-parallel site {name} crosses "
                             f"shards: pack it with actorder_shards={tp}")
        return loc.contiguous()

    def site(name, p, spec):
        if name in row_sites and len(meta.get(name) or ()) == 5:
            raise ValueError(f"row-parallel W8A8 site {name}: its per-token activation scale "
                             "spans the whole K, which tp > 1 splits")
        groups = p["scales"].shape[-2] if p.get("scales") is not None else 0
        return {k: leaf(name, k, v, spec[k], groups) for k, v in p.items()}

    specs = param_specs(params, arch)
    out = {}
    for name, val in params.items():
        if name == "layers":
            out[name] = {s: site(s, p, specs[name][s]) if isinstance(p, dict) else p
                         for s, p in val.items()}
        elif name == "lm_head":
            out[name] = site("lm_head", val, specs[name])
        else:
            out[name] = val
    return out


def shard_qmeta(qmeta, tp: int, arch: str, cfg):
    """The rank's qmeta: K / tp on row-parallel sites, the rank's share of
    N on column-parallel ones (by member, _segments: one KV head a rank
    where tp exceeds them), expert and dense sites unchanged."""
    if qmeta is None or tp == 1:
        return qmeta
    mod = _arch(arch)
    row_sites = set(getattr(mod, "ROW_PARALLEL_SITES", ()))
    keep = set(getattr(mod, "EXPERT_SITES", ())) | set(getattr(mod, "PACK_DENSE_SITES", ()))
    out = {}
    for name, m in dict(qmeta).items():
        if name in keep:
            out[name] = m
            continue
        m = list(m)
        if name in row_sites:
            m[2] //= tp
        else:
            m[3] = sum(w // parts for w, parts in _segments(name, cfg, m[3], tp))
        out[name] = tuple(m)
    return tuple(sorted(out.items()))


def shard_model(params: dict, qmeta, cfg, mesh, rank: int | None = None):
    """(local params, local qmeta, local cfg) of this rank's "model"
    coordinate (or of `rank` of an int tp): what a sharded path runs with."""
    from qtpu_torch.sharding.mesh import axis_size

    arch = cfg.arch
    tp = axis_size(mesh, "model") if not isinstance(mesh, int) else mesh
    local = shard_params(params, mesh, arch, rank=rank, cfg=cfg, qmeta=qmeta)
    return local, shard_qmeta(qmeta, tp, arch, cfg), local_config(cfg, tp)
