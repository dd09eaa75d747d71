"""Pipeline parallelism: qtpu's GPipe microbatch schedule over a `pipe`
mesh dim (port of qtpu/sharding/pipeline.py).

  * Stage s holds layers [s·L/P, (s+1)·L/P) of the stacked [L, ...] leaves
    (zero-copy views), on a 3-axis ('data', 'pipe', 'model') mesh also its
    Megatron shard of them (qtpu_torch.sharding.specs); the embedding,
    the final norm and the lm_head stay whole on every stage.
  * The tick schedule is qtpu's: at tick t in [0, M + P - 1) stage s runs
    microbatch t - s when there is one. Stage 0 embeds it, every other
    stage receives its [b, S, D] activations from stage s - 1
    (point-to-point over the `pipe` group: qtpu's ppermute), applies its
    layers and sends them on; the last stage takes the loss.
  * The loss is qtpu's perplexity math: fp32 shifted cross-entropy, its
    mean times S per microbatch. The last stage broadcasts the [M] losses
    over `pipe`, so every stage returns them.

The llama and moe archs only (RMSNorm head), as in qtpu. The `data` dim is
not split: every data coordinate runs every microbatch, as qtpu's
replicated batches do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from qtpu_torch.sharding import collectives as coll
from qtpu_torch.sharding.mesh import axis_rank, axis_size, build_mesh, local_group


def make_pipe_mesh(pipe: int, data: int = 1, model: int = 1, device_type: str | None = None):
    """('data', 'pipe'[, 'model']) mesh: replica streams x stages x (optional)
    Megatron shards within each stage; `model` is the innermost dim."""
    if model > 1:
        return build_mesh((data, pipe, model), ("data", "pipe", "model"), device_type)
    return build_mesh((data, pipe), ("data", "pipe"), device_type)


def _check_arch(arch: str) -> None:
    if arch not in ("llama", "moe"):
        raise NotImplementedError(
            "pipeline_nll supports the llama family and moe (RMSNorm head)")


def shard_params_pipeline(params: dict, mesh, arch: str = "llama", cfg=None, qmeta=None) -> dict:
    """This rank's stage of a whole params tree: its layers (views), and
    on a mesh with a `model` dim its Megatron shard of them."""
    _check_arch(arch)
    P, s = axis_size(mesh, "pipe"), axis_rank(mesh, "pipe")
    layers = params["layers"]
    L = next(v for v in layers.values() if not isinstance(v, dict)).shape[0]
    if L % P:
        raise ValueError(f"{L} layers do not split evenly over pipe={P}")
    n = L // P

    def cut(v):
        if isinstance(v, dict):
            return {k: None if t is None else t[s * n:(s + 1) * n] for k, t in v.items()}
        return v[s * n:(s + 1) * n]

    out = dict(params)
    out["layers"] = {k: cut(v) for k, v in layers.items()}
    tp = axis_size(mesh, "model")
    if tp > 1:
        from qtpu_torch.sharding import specs

        groups = specs.row_groups(arch, out, qmeta)
        if specs.plan(cfg, tp, groups, specs.row_perms(arch, out)) != specs.plan(cfg, tp, groups):
            raise ValueError("a pipeline's stages take GPTQ actorder perms that stay inside "
                             "each tensor-parallel rank's rows (pipeline_nll's local configs "
                             "see no perms)")
        out = specs.shard_params(out, mesh, arch, cfg=cfg, qmeta=qmeta)
    return out


def pipeline_nll(params, batches, cfg, mesh, n_stages: int | None = None, qmeta=None,
                 arch: str = "llama") -> torch.Tensor:
    """Pipelined teacher-forced NLL per microbatch.

    params: this rank's stage (shard_params_pipeline); cfg and qmeta: the
    whole model's. batches: [M, b, S] token ids. Returns nll [M] f32 on
    every stage (mean shifted CE x S per microbatch; exp(sum / positions)
    is the reference perplexity)."""
    from qtpu_torch.models import get_arch
    from qtpu_torch.models.ops import gather_logits, linear, rms_norm, rope_tables
    from qtpu_torch.sharding.specs import local_config, shard_qmeta

    _check_arch(arch)
    P, s = axis_size(mesh, "pipe"), axis_rank(mesh, "pipe")
    if n_stages is not None and n_stages != P:
        raise ValueError(f"n_stages={n_stages} but the mesh has pipe={P}")
    pipe, tp = local_group(mesh, "pipe"), local_group(mesh, "model")
    n_tp, r_tp = axis_size(mesh, "model"), axis_rank(mesh, "model")
    lc = local_config(cfg, n_tp, r_tp, qmeta)
    lq = shard_qmeta(qmeta, n_tp, arch, cfg, r_tp)
    tp = tp if n_tp > 1 else None
    mod = get_arch(arch)
    qm = (dict(lq) if lq is not None else {}).get
    layers = params["layers"]
    n_local = layers["attn_norm"].shape[0]
    M, b, S = batches.shape
    device = params["embed"].device
    cos, sin = rope_tables(torch.arange(S, device=device), cfg.head_dim, cfg.rope_theta)
    win = cfg.sliding_window if 0 < cfg.sliding_window < S else 0
    nll = torch.zeros((M,), dtype=torch.float32, device=device)
    buf = torch.empty((b, S, cfg.hidden_size), dtype=params["embed"].dtype, device=device)
    with torch.no_grad():
        for t in range(M + P - 1):
            mb = t - s
            if not 0 <= mb < M:
                continue
            ids = batches[mb].to(device=device, dtype=torch.int64)
            x = params["embed"][ids] if s == 0 else coll.recv(buf, s - 1, pipe).clone()
            for l in range(n_local):
                x = mod.layer_forward(x, layers, l, lc, qm, (cos, sin), win, tp)
            if s < P - 1:
                coll.send(x, s + 1, pipe)
                continue
            h = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = gather_logits(linear(h, params["lm_head"], qm("lm_head")).float(), tp)
            ce = Fn.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                  ids[:, 1:].reshape(-1))
            nll[mb] = ce * S
    return coll.broadcast(nll, P - 1, pipe)
