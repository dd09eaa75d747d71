"""Move parameters between the JAX package and the port through numpy.

`params_to_torch` turns qtpu's params (a nested dict of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, params)`) into the port's tensors with
the same stacked [L, ...] layout, on the card unless the caller passes
device="cpu"; bf16 arrives from JAX as
`ml_dtypes.bfloat16` and goes through an int16 view. qmeta needs no
conversion: both packages use the same tuple of (site, (bits, group, K, N)).
`params_to_numpy` goes the other way, for feeding the port's tensors to qtpu.
`stats_to_torch` turns calibration statistics (qtpu's CalibStats, or any
object with its four fields, arrays as numpy) into the port's CalibStats.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def map_tree(tree, fn):
    """Apply fn to every tensor/array leaf of a nested dict (None stays)."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def params_to_torch(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on `device`."""
    return map_tree(tree, lambda a: to_torch(a, device))


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return map_tree(tree, to_numpy)


def stats_to_torch(stats, device="cuda"):
    """An object with mean_abs / max_abs / hessian dicts of arrays and
    n_batches (e.g. qtpu's CalibStats) -> qtpu_torch.calib.CalibStats."""
    from qtpu_torch.calib.stats import CalibStats

    return CalibStats(
        mean_abs=params_to_torch(dict(stats.mean_abs), device),
        max_abs=params_to_torch(dict(stats.max_abs), device),
        hessian=None if stats.hessian is None else params_to_torch(dict(stats.hessian), device),
        n_batches=int(stats.n_batches),
    )
