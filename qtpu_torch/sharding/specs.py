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

Which configurations run: every one whose dense params tree qtpu's
`shard_params` accepts, that is where tp divides each dim qtpu's table
shards (the hidden size, q_dim, kv_dim, the MLP width, the vocabulary,
the experts, a shared expert's width). Elsewhere `local_config` raises
ValueError naming the dim (qtpu's device_put raises there too). Raw,
fake-quant and packed trees of every method run, W8A8 included.

The port picks its own cuts, since a row-parallel sum does not need equal
parts (`plan`, one `RankCut` a rank):
  * heads: rank r holds a contiguous block of q heads, as even as the rule
    allows: the block is whole KV groups, or part of one group, so that
    every local q head reads local KV head i // G through one uniform
    mapping, and the rank holds exactly the KV heads its q heads read (a
    copy where ranks share one). tp <= KV splits the KV groups (H 6, KV 3
    at tp 2: KV 2 + 1, q 4 + 2); tp > KV splits the ranks over the groups
    and each group's heads over its ranks (Qwen2-7B's 7 q heads a group at
    tp 8: 4 + 3, one KV head a rank). Where tp divides the heads this is
    the even split. A rank may hold no head (H 4 at tp 8): its attention
    adds nothing to the o-projection's sum.
  * the attention's row-parallel site takes the K rows of the rank's
    heads. A packed one whose groups those rows cut (hd 64 at g128, H 6
    and KV 2 at tp 2) takes whole groups instead, split as evenly as
    possible, and every rank all-gathers the attention output and takes
    its rows (`LocalConfig.o_gather`, `ops.o_input`): GSPMD's reshard, one
    collective more a layer, only there.
  * the MLP (a Qwen2-MoE shared expert alike): a packed down-projection
    splits K at whole groups, as evenly as possible (TinyLlama g128 at tp
    8: 6 or 5 of its 44 groups), the gate / up columns (both members of a
    fused gateup_proj) cut to match; dense ones split I / tp.
  * a per-channel site (one group spanning K: W8A8's (8, K, K, N, "a8"))
    splits data and the smooth vector on K and keeps its scales and zeros
    whole; `ops.linear` takes the per-token activation scale over the
    group (an all-reduce MAX of each token's |x| between K6's two modes).
  * the vocabulary and the experts split evenly, as qtpu requires.

`shard_params` cuts a whole params tree (raw or packed, fused or not) into
one rank's local tree of plain tensors, slicing each leaf on the dim its
spec names "model": fused sites per member (qkv_proj [q_r | k_r | v_r],
gateup_proj [gate_r | up_r], GPT-2's c_attn, OPT's qkv_proj), packed K at
the rank's rows (W4's group-halves and W2's group-quarters keep a group's
bytes in contiguous rows). A GPTQ actorder perm of a row-parallel site is
cut with the rows: made local where each rank's rows read only its own
slice of x (actorder_shards cutting K as the ranks do), else kept global,
and that site gathers its whole input (`LocalConfig.o_gather` /
`mlp_gather`, `ops.o_input` / `mlp_input`). `local_config` is the rank's
ModelConfig (`LocalConfig`: its heads, KV heads and MLP width, and the
gathers), so the model code that splits by cfg.q_dim and
cfg.intermediate_size runs unchanged; `shard_qmeta` the rank's qmeta.
"""

from __future__ import annotations

import dataclasses

import torch

from qtpu_torch.models.config import ModelConfig


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


def _check(cfg, tp: int) -> None:
    """qtpu's rule: every dim its table shards on the dense tree divides by
    tp (jax.device_put raises otherwise)."""
    dims = [(cfg.hidden_size, "hidden_size (the embedding's dim)"),
            (cfg.q_dim, "q_dim (num_heads x head_dim)"),
            (cfg.kv_dim, "kv_dim (num_kv_heads x head_dim)"), (cfg.vocab_size, "vocab_size")]
    if cfg.arch == "moe":
        dims.append((cfg.num_experts, "num_experts"))
        if cfg.shared_expert_intermediate_size:
            dims.append((cfg.shared_expert_intermediate_size, "shared_expert_intermediate_size"))
    else:
        dims.append((cfg.intermediate_size, "intermediate_size"))
    for n, what in dims:
        _need(n, tp, what)


def _parts(n: int, k: int) -> list:
    """n split into k parts as evenly as possible, the larger first."""
    return [n // k + (i < n % k) for i in range(k)]


def _cuts(sizes) -> list:
    """[(start, stop)] of consecutive parts of these sizes."""
    out, s = [], 0
    for z in sizes:
        out.append((s, s + z))
        s += z
    return out


def head_split(cfg, tp: int) -> list:
    """Each rank's ((first q head, end), (first KV head, end)): whole KV
    groups split over the ranks where tp <= KV, else the ranks split over
    the groups and each group's G q heads over its ranks (module
    docstring)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    if tp <= KV:
        return [((a * G, b * G), (a, b)) for a, b in _cuts(_parts(KV, tp))]
    out = []
    for g, n in enumerate(_parts(tp, KV)):
        for a, b in _cuts(_parts(G, n)):
            out.append(((g * G + a, g * G + b), (g, g + (b > a))))
    return out


@dataclasses.dataclass(frozen=True)
class RankCut:
    """One rank's share: q heads, KV heads, the attention's row-parallel
    site's K rows and the MLP's columns (a shared expert's on the MoE
    family), and for each of the two row-parallel sites the input it takes
    where that is not the rank's own slice (else ()): (every rank's width
    of the gathered input, first element taken, end)."""

    heads: tuple
    kv: tuple
    o_rows: tuple
    o_in: tuple
    mlp: tuple
    mlp_in: tuple


def _mlp_width(cfg) -> int:
    return cfg.shared_expert_intermediate_size if cfg.arch == "moe" else cfg.intermediate_size


def _group_count(meta) -> int | None:
    """A row-parallel site's groups along K from its meta; None where one
    group spans K (per-channel, W8A8)."""
    if meta is None:
        return None
    group, K = meta[1], meta[2]
    return K // group if group < K else None


def row_groups(arch: str, params=None, qmeta=None) -> dict:
    """{row-parallel site: its quantization groups along K, or None}, from
    the qmeta or, without one, from the packed params' scales."""
    sites = _arch(arch).ROW_PARALLEL_SITES
    if qmeta is not None:
        qm = dict(qmeta)
        return {s: _group_count(qm.get(s)) for s in sites}
    layers = (params or {}).get("layers", {})
    out = {}
    for s in sites:
        sc = (layers.get(s) or {}).get("scales")
        out[s] = sc.shape[-2] if sc is not None and sc.shape[-2] > 1 else None
    return out


def row_perms(arch: str, params=None) -> dict:
    """{row-parallel site: its GPTQ actorder perm [..., K]} of a whole
    params tree (none without params)."""
    layers = (params or {}).get("layers", {})
    return {s: layers[s]["perm"] for s in _arch(arch).ROW_PARALLEL_SITES
            if isinstance(layers.get(s), dict) and "perm" in layers[s]}


def _crosses(perm, rows) -> bool:
    """Whether some rank's rows [k0, k1) of a permuted weight read x
    outside [k0, k1) (its own slice of x would not do)."""
    return any(bool(((perm[..., a:b] < a) | (perm[..., a:b] >= b)).any()) for a, b in rows)


def plan(cfg, tp: int, groups: dict | None = None, perms: dict | None = None) -> list:
    """Every rank's RankCut (module docstring); groups: row_groups; perms:
    row_perms. A row-parallel site whose perm crosses a rank's rows takes
    the whole gathered input (the perm indexes it; qtpu replicates perms
    and gathers too). Raises ValueError where qtpu's rule fails."""
    _check(cfg, tp)
    groups, perms = groups or {}, perms or {}
    o_site, m_site = _arch(cfg.arch).ROW_PARALLEL_SITES
    hd = cfg.head_dim
    heads = head_split(cfg, tp)
    rows = [(a * hd, b * hd) for (a, b), _ in heads]
    widths = tuple(b - a for a, b in rows)
    o_in = [()] * tp
    go = groups.get(o_site)
    if go and any(a % (cfg.q_dim // go) for a, _ in rows):
        g = cfg.q_dim // go
        rows = [(a * g, b * g) for a, b in _cuts(_parts(go, tp))]
        o_in = [(widths, *r) for r in rows]
    if o_site in perms and _crosses(perms[o_site], rows):
        o_in = [(widths, 0, cfg.q_dim)] * tp
    W, gm = _mlp_width(cfg), groups.get(m_site)
    mlp = ([(a * (W // gm), b * (W // gm)) for a, b in _cuts(_parts(gm, tp))] if gm
           else _cuts(_parts(W, tp)))
    mlp_in = [()] * tp
    if m_site in perms and _crosses(perms[m_site], mlp):
        mlp_in = [(tuple(b - a for a, b in mlp), 0, W)] * tp
    return [RankCut(h, v, o, oi, m, mi)
            for (h, v), o, oi, m, mi in zip(heads, rows, o_in, mlp, mlp_in)]


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """One rank's ModelConfig: its heads, KV heads and MLP width (a shared
    expert's on the MoE family; the expert count stays, the router sees
    every expert), and the inputs of its row-parallel sites where they are
    not its own slice (else ()): `o_gather` for the attention's,
    `mlp_gather` for the MLP's, each (every rank's width of the gathered
    input, first element taken, end): whole groups the heads do not cover,
    or all of it for a perm that crosses the ranks' rows."""

    o_gather: tuple = ()
    mlp_gather: tuple = ()


def _local(cfg, cut: RankCut) -> LocalConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    kw.update(num_heads=cut.heads[1] - cut.heads[0], num_kv_heads=cut.kv[1] - cut.kv[0],
              o_gather=cut.o_in, mlp_gather=cut.mlp_in)
    width = cut.mlp[1] - cut.mlp[0]
    kw["shared_expert_intermediate_size" if cfg.arch == "moe" else "intermediate_size"] = width
    return LocalConfig(**kw)


def local_config(cfg, tp: int, rank: int | None = None, qmeta=None, params=None):
    """The ModelConfig of rank `rank` of tp (a LocalConfig; cfg itself at
    tp 1). qmeta: the packed metas, whose row-parallel groups decide the
    MLP's columns and the o-projection's rows; params: the whole tree, whose
    actorder perms decide whether a row-parallel site gathers its input.
    rank None: the config every rank shares, or ValueError where the ranks'
    differ."""
    if tp == 1:
        return cfg
    cuts = plan(cfg, tp, row_groups(cfg.arch, qmeta=qmeta), row_perms(cfg.arch, params))
    if rank is not None:
        return _local(cfg, cuts[rank])
    locs = {_local(cfg, c) for c in cuts}
    if len(locs) > 1:
        raise ValueError(f"the ranks' configs differ at tp={tp} (uneven heads or groups): "
                         "name the rank")
    return locs.pop()


KV_SITES = ("k_proj", "v_proj")  # column-parallel sites of kv_dim outputs
QKV_SITES = ("qkv_proj", "c_attn")  # fused [q | k | v] sites


def _columns(name: str, cfg, n: int, cut: RankCut, tp: int, r: int) -> list:
    """The rank's (member offset, start, stop) along a column-parallel
    site's N, members of a fused site in order."""
    hd = cfg.head_dim
    q = (cut.heads[0] * hd, cut.heads[1] * hd)
    kv = (cut.kv[0] * hd, cut.kv[1] * hd)
    f0, f1 = cut.mlp
    if name in QKV_SITES:
        return [(0, *q), (cfg.q_dim, *kv), (cfg.q_dim + cfg.kv_dim, *kv)]
    if name == "q_proj":
        return [(0, *q)]
    if name in KV_SITES:
        return [(0, *kv)]
    if name == "gateup_proj":
        return [(0, f0, f1), (n // 2, f0, f1)]
    if name in ("gate_proj", "up_proj", "mlp_fc", "fc1", "sh_gate", "sh_up"):
        return [(0, f0, f1)]
    _need(n, tp, f"{name} N")  # the lm_head's vocabulary
    return [(0, r * n // tp, (r + 1) * n // tp)]


def _take(t: torch.Tensor, dim: int, members: list, width: int) -> torch.Tensor:
    """The members' slices of t along dim, concatenated; members in units
    of which t's dim holds `width` (a packed leaf's rows are a fixed
    fraction of K: W4 K / 2, scales K / group)."""
    n = t.shape[dim]
    out = []
    for off, a, b in members:
        lo, hi = (off + a) * n, (off + b) * n
        if lo % width or hi % width:
            raise ValueError(f"rows [{off + a}, {off + b}) of {width} fall inside a packed "
                             f"row of this leaf ({n} rows)")
        out.append(t.narrow(dim, lo // width, (hi - lo) // width))
    return (out[0] if len(out) == 1 else torch.cat(out, dim=dim)).contiguous()


def _tp_rank(mesh, rank):
    from qtpu_torch.sharding.mesh import axis_rank, axis_size

    if isinstance(mesh, int):
        if rank is None:
            raise ValueError("an int tp needs the rank")
        return mesh, rank
    return axis_size(mesh, "model"), axis_rank(mesh, "model") if rank is None else rank


def shard_params(params: dict, mesh, arch: str = "llama", rank: int | None = None, cfg=None,
                 qmeta=None) -> dict:
    """This rank's local params tree of a whole (raw or packed) tree, each
    leaf cut on the dim that param_specs names "model".

    mesh: a DeviceMesh with a "model" dim (its size is tp, this rank's
    coordinate there the default `rank`), or an int tp with `rank` given.
    cfg: the whole ModelConfig (its heads decide the cuts); qmeta: the
    packed metas (without one the packed params' scales give the groups).
    Leaves that stay whole are the same tensors, not copies."""
    tp, r = _tp_rank(mesh, rank)
    if tp == 1:
        return params
    if cfg is None:
        raise ValueError("shard_params at tp > 1 needs the model config (its heads)")
    cut = plan(cfg, tp, row_groups(arch, params, qmeta), row_perms(arch, params))[r]
    mod = _arch(arch)
    o_site, m_site = mod.ROW_PARALLEL_SITES
    expert_sites = set(getattr(mod, "EXPERT_SITES", ()))
    row_cut = {o_site: (cfg.q_dim, cut.o_rows, cut.o_in),
               m_site: (_mlp_width(cfg), cut.mlp, cut.mlp_in)}

    def leaf(name, k, v, spec):
        if v is None or "model" not in spec:
            return v
        dim = spec.index("model") - len(spec)
        n = v.shape[dim]
        if name in expert_sites:
            _need(n, tp, f"{name} experts")
            return v.narrow(dim, r * n // tp, n // tp).contiguous()
        if name not in row_cut:
            return _take(v, dim, _columns(name, cfg, n, cut, tp, r), n)
        K, (k0, k1), taken = row_cut[name]
        if k in ("scales", "zeros") and n == 1:  # one group spanning K: whole on every rank
            return v
        if k != "perm":
            return _take(v, dim, [(0, k0, k1)], K)
        # the rank's rows' perm: into the whole gathered input where it
        # crosses the ranks' rows (taken), else into the rank's own slice
        return (v.narrow(-1, k0, k1 - k0) - (0 if taken else k0)).contiguous()

    specs = param_specs(params, arch)
    out = {}
    for name, val in params.items():
        if name == "layers":
            out[name] = {s: {k: leaf(s, k, v, specs[name][s][k]) for k, v in p.items()}
                         if isinstance(p, dict) else p for s, p in val.items()}
        elif name == "lm_head":
            out[name] = {k: leaf("lm_head", k, v, specs[name][k]) for k, v in val.items()}
        else:
            out[name] = val
    return out


def shard_qmeta(qmeta, tp: int, arch: str, cfg, rank: int | None = None):
    """The rank's qmeta: its rows' K on row-parallel sites (the group too
    where one spans K), its columns' N on column-parallel ones, expert and
    dense sites unchanged. rank None: as local_config."""
    if qmeta is None or tp == 1:
        return qmeta
    if rank is None:
        metas = {shard_qmeta(qmeta, tp, arch, cfg, r) for r in range(tp)}
        if len(metas) > 1:
            raise ValueError(f"the ranks' qmetas differ at tp={tp}: name the rank")
        return metas.pop()
    cut = plan(cfg, tp, row_groups(arch, qmeta=qmeta))[rank]  # perms move no meta
    mod = _arch(arch)
    o_site, m_site = mod.ROW_PARALLEL_SITES
    rows = {o_site: cut.o_rows, m_site: cut.mlp}
    keep = set(getattr(mod, "EXPERT_SITES", ())) | set(getattr(mod, "PACK_DENSE_SITES", ()))
    out = {}
    for name, m in dict(qmeta).items():
        if name in keep:
            out[name] = m
            continue
        m = list(m)
        if name in rows:
            k0, k1 = rows[name]
            if m[1] >= m[2]:
                m[1] = k1 - k0
            m[2] = k1 - k0
        else:
            m[3] = sum(b - a for _, a, b in _columns(name, cfg, m[3], cut, tp, rank))
        out[name] = tuple(m)
    return tuple(sorted(out.items()))


def shard_model(params: dict, qmeta, cfg, mesh, rank: int | None = None):
    """(local params, local qmeta, local cfg) of this rank's "model"
    coordinate (or of `rank` of an int tp): what a sharded path runs with."""
    tp, r = _tp_rank(mesh, rank)
    local = shard_params(params, tp, cfg.arch, rank=r, cfg=cfg, qmeta=qmeta)
    return (local, shard_qmeta(qmeta, tp, cfg.arch, cfg, r),
            local_config(cfg, tp, r, qmeta, params))
