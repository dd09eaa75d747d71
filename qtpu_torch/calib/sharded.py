"""Data-parallel calibration with explicit collectives (port of
qtpu/calib/sharded.py).

The calibration rows (the [1, block] batches, concatenated) are padded to a
multiple of the mesh's `data` size with copies of the last row and split
over `data` in contiguous runs, as qtpu's P("data") splits them; each rank
runs the capture forward one row at a time on the whole params, so every
row stays one statistics sample (AWQ sums the per-row mean-abs vectors,
GPTQ's proxy Hessian takes them one by one). The ranks then combine:
mean_abs by an all-gather in row order (the padding rows dropped), max_abs
by an all-reduce MAX, the Hessians by an all-reduce SUM, from which qtpu's
correction takes the padding rows' share (pad x the last real row's
Hessian, subtracted on the rank that ran that row). Ranks on the same
`data` coordinate (the `model` dim) compute the same rows.

Contract: collect_calibration_stats's statistics, mean_abs and max_abs
bit for bit (each row is the same forward), the Hessians up to the order of
their sum.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.calib.stats import CalibStats
from qtpu_torch.sharding import collectives as coll
from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group


def psum_hessian(local_xtx: torch.Tensor, group) -> torch.Tensor:
    """qtpu's `psum_hessian_shardmap`: a rank's partial XᵀX rows [rows, C, C]
    summed over the rank's rows, then over the group (all-reduce SUM)."""
    return coll.all_reduce(local_xtx.sum(dim=0), group)


def collect_calibration_stats_sharded(forward_fn, params, calib_batches, cfg, mesh,
                                      collect_hessian: bool = False) -> CalibStats:
    """Sharded equivalent of collect_calibration_stats (whole params on
    every rank, rows over the mesh's `data` dim). Every rank returns the
    combined statistics."""
    dp, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    group = local_group(mesh, "data")
    ids = np.concatenate([np.asarray(b) for b in calib_batches], axis=0)
    n = ids.shape[0]
    pad = (-n) % dp
    if pad:
        ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)], axis=0)
    per = ids.shape[0] // dp
    lo = d * per
    capture = "hessian" if collect_hessian else "stats"
    device = params["embed"].device
    mean_parts, max_run, hess_run, last_h = {}, {}, {}, {}
    with torch.no_grad():
        for i in range(lo, lo + per):
            row = torch.as_tensor(ids[i:i + 1]).to(device=device, dtype=torch.int64)
            _, stats = forward_fn(params, row, cfg, capture=capture)
            for site, st in stats.items():
                mean_parts.setdefault(site, []).append(st["mean_abs"])
                max_run[site] = (st["max_abs"] if site not in max_run
                                 else torch.maximum(max_run[site], st["max_abs"]))
                if collect_hessian:
                    if site not in hess_run:
                        hess_run[site] = st["hessian"].clone()
                    else:
                        hess_run[site].add_(st["hessian"])
                    if i == n - 1:
                        last_h[site] = st["hessian"]
            del stats
    mean_abs = {s: coll.all_gather(torch.stack(v), group, dim=0)[:n]
                for s, v in mean_parts.items()}
    max_abs = {s: coll.all_reduce(v, group, op="max") for s, v in max_run.items()}
    hessian = None
    if collect_hessian:
        if pad and last_h:  # the padding rows repeat the last real row
            for site, h in last_h.items():
                hess_run[site].sub_(pad * h)
        hessian = {s: coll.all_reduce(v, group) for s, v in hess_run.items()}
    return CalibStats(mean_abs=mean_abs, max_abs=max_abs, hessian=hessian, n_batches=n)
