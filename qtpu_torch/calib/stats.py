"""Calibration statistics (port of qtpu/calib/stats.py).

The model's forward returns per-input-site statistics (`capture` of
qtpu_torch.models.llama.forward) and `collect_calibration_stats` drives
the loop over calibration batches, accumulating on the device:

  mean_abs[site]: [n_batches, L, C]  one vector per batch (AWQ sums them;
                  GPTQ's proxy Hessian takes them one by one)
  max_abs[site]:  [L, C]             running max over batches (SmoothQuant)
  hessian[site]:  [L, C, C]          sum of XᵀX in f32 (true-Hessian GPTQ);
                  only with collect_hessian=True, added in place

head_in (the lm_head's input) has no layer axis. On MoE models the
down-projections' input exp_down_in carries the expert axis, each expert's
statistics over the tokens routed to it (qtpu's `_routed_stats`):
mean_abs [n_batches, L, E, F], max_abs [L, E, F], hessian [L, E, F, F].
At TinyLlama-1.1B width the true Hessians take 3.9 GB of f32 (down_in alone
22 x 5632² x 4 B); at Mixtral-8x7B width exp_down_in's alone take 6.58 GB
a layer (8 x 14336² x 4 B).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from qtpu_torch.models.llama import SITE_OF_INPUT


@dataclass
class CalibStats:
    """Aggregated calibration statistics keyed by input site."""

    mean_abs: dict  # site -> [n_batches, L, C] (head_in: [n_batches, C])
    max_abs: dict  # site -> [L, C] (head_in: [C])
    hessian: dict | None  # site -> [L, C, C] or None
    n_batches: int

    def importance(self, input_site: str) -> torch.Tensor:
        """AWQ importance: the sum of the per-batch mean-abs vectors."""
        return self.mean_abs[input_site].float().sum(dim=0)

    def for_linear_site(self, linear_site: str) -> str:
        """The input site feeding a linear site."""
        for in_site, linears in SITE_OF_INPUT.items():
            if linear_site in linears:
                return in_site
        raise KeyError(linear_site)


def collect_calibration_stats(forward_fn, params, calib_batches, cfg,
                              collect_hessian: bool = False, verbose: bool = False) -> CalibStats:
    """Run the capture forward over calibration batches and aggregate.

    calib_batches: [1, block] (or [B, block]) int token ids, numpy or
    torch; they go to the device of the params. forward_fn: a
    models.llama.forward-compatible callable."""
    capture = "hessian" if collect_hessian else "stats"
    device = params["embed"].device
    mean_list, max_run, hess_run = {}, {}, ({} if collect_hessian else None)
    with torch.no_grad():
        for i, ids in enumerate(calib_batches):
            ids = torch.as_tensor(ids).to(device=device, dtype=torch.int64)
            _, stats = forward_fn(params, ids, cfg, capture=capture)
            for site, st in stats.items():
                mean_list.setdefault(site, []).append(st["mean_abs"])
                if site not in max_run:
                    max_run[site] = st["max_abs"]
                else:
                    max_run[site] = torch.maximum(max_run[site], st["max_abs"])
                if collect_hessian:
                    if site not in hess_run:
                        hess_run[site] = st["hessian"]
                    else:
                        hess_run[site].add_(st["hessian"])
            del stats
            if verbose and (i + 1) % 8 == 0:
                print(f"  calibration batch {i + 1}/{len(calib_batches)}")
    return CalibStats(
        mean_abs={s: torch.stack(v) for s, v in mean_list.items() if v},
        max_abs=max_run,
        hessian=hess_run,
        n_batches=len(calib_batches),
    )
