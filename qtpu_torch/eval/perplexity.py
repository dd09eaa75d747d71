"""Perplexity evaluation with the reference math (port of
qtpu/eval/perplexity.py:23-75; quantization_utils.py:269-322):

  - the [1, N] token stream is cut into non-overlapping `block_size` blocks
  - logits are f32 before the shifted cross-entropy
  - per-block nll = mean token loss (over block_size - 1 positions) times
    block_size
  - ppl = exp(sum of nll / (n_samples * block_size))

The block nlls are summed on the device and read back once; a block's
logits ([1, block_size, V] f32) live only until its loss is taken.

Under a mesh (qtpu_torch.sharding.mesh) the blocks are independent:
`_evaluate_sharded` pads the blocks to a multiple of the `data` size (the
padding blocks masked out, as qtpu's), gives each data rank a contiguous
run of them, runs them with the rank's tensor-parallel shards when the
mesh has a `model` dim, and all-reduces the nll sums over `data`; a mesh
with a `pipe` dim runs qtpu's GPipe schedule
(qtpu_torch.sharding.pipeline.pipeline_nll), each block a microbatch.
Either takes the WHOLE params (as qtpu's global arrays) and cuts this
rank's shards itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn


def block_nll(forward, params, batch, cfg, qmeta=None) -> torch.Tensor:
    """Mean shifted cross-entropy of one [1, S] block, an f32 scalar on the
    device."""
    logits = forward(params, batch, cfg, qmeta=qmeta)
    V = logits.shape[-1]
    return Fn.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                            batch[:, 1:].reshape(-1).long())


@torch.inference_mode()
def evaluate_perplexity(params, test_ids, cfg, n_samples: int = 40, block_size: int = 2048,
                        qmeta=None, arch: str = "llama", mesh=None,
                        verbose: bool = False) -> float:
    """test_ids: [1, N] token stream (numpy or tensor). Runs on the device
    of params["embed"]. Returns the perplexity. mesh: a DeviceMesh with a
    `data` dim (and `model`) or a `pipe` dim (module docstring)."""
    from qtpu_torch.models import get_arch

    forward = get_arch(arch).forward
    device = params["embed"].device
    ids = test_ids if isinstance(test_ids, torch.Tensor) else torch.from_numpy(np.asarray(test_ids))
    ids = ids.to(device)
    n = min(n_samples, ids.shape[1] // block_size)
    if n <= 0:
        raise ValueError(f"the test stream of {ids.shape[1]} tokens holds no block of {block_size}")
    if mesh is not None and "pipe" in (mesh.mesh_dim_names or ()):
        return _evaluate_pipelined(params, ids, cfg, n, block_size, qmeta, arch, mesh)
    if mesh is not None:
        return _evaluate_sharded(forward, params, ids, cfg, n, block_size, qmeta, mesh)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n):
        batch = ids[:, i * block_size:(i + 1) * block_size]
        total += block_nll(forward, params, batch, cfg, qmeta) * block_size
        if verbose and (i + 1) % 8 == 0:
            print(f"  eval block {i + 1}/{n}")
    return float(torch.exp(total / (n * block_size)))


def _evaluate_sharded(forward, params, ids, cfg, n, block_size, qmeta, mesh) -> float:
    """Blocks over `data` (padding blocks masked), params over `model`;
    the nll sums all-reduced over `data`."""
    from qtpu_torch.sharding import collectives as coll
    from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group
    from qtpu_torch.sharding.specs import shard_model

    dp, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    tp = local_group(mesh, "model") if axis_size(mesh, "model") > 1 else None
    lp, lq, lc = shard_model(params, qmeta, cfg, mesh) if tp is not None else (params, qmeta, cfg)
    padded = n + (-n) % dp
    per = padded // dp
    total = torch.zeros((), dtype=torch.float32, device=ids.device)
    fwd = functools.partial(forward, tp=tp) if tp is not None else forward
    for i in range(d * per, min((d + 1) * per, n)):  # a padding block contributes zero
        batch = ids[:, i * block_size:(i + 1) * block_size]
        total += block_nll(fwd, lp, batch, lc, lq) * block_size
    coll.all_reduce(total, local_group(mesh, "data"))
    return float(torch.exp(total / (n * block_size)))


def _evaluate_pipelined(params, ids, cfg, n, block_size, qmeta, arch, mesh) -> float:
    """Each block one microbatch of the GPipe schedule, the layers over
    `pipe` (and `model` on a 3-axis mesh)."""
    from qtpu_torch.sharding.pipeline import pipeline_nll, shard_params_pipeline

    stage = shard_params_pipeline(params, mesh, arch=arch, cfg=cfg, qmeta=qmeta)
    batches = ids[0, :n * block_size].reshape(n, 1, block_size)
    nll = pipeline_nll(stage, batches, cfg, mesh, qmeta=qmeta, arch=arch)
    return float(torch.exp(nll.sum() / (n * block_size)))
