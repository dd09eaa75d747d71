"""AWQ, activation-aware weight quantization (port of qtpu/quant/awq.py).

Channel importance is the sum over calibration batches of the mean |input
activation|; the top max(1, int(C * protect_ratio)) input channels are
scaled up by `scale_factor` before RTN and back down after, which shrinks
their relative quantization error. `awq_search_scale_factor` is qtpu's
importance-weighted reconstruction-error grid search (the first minimum of
the grid wins, as qtpu's strict `<` scan keeps it).

Weights are in reference orientation [out, in]; the model-level apply
layer transposes qtpu's [K, N] sites.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.quant.rtn import pseudo_quantize


def _protection_scale_vec(importance: torch.Tensor, protect_ratio: float,
                          scale_factor) -> torch.Tensor:
    """Per-input-channel multiplier [..., C] (f32): scale_factor on the
    top-k important channels, 1 elsewhere; k = max(1, int(C *
    protect_ratio)). A leading axis of importance (layers) is batched."""
    C = importance.shape[-1]
    n_protect = max(1, int(C * protect_ratio))
    idx = torch.topk(importance.float(), n_protect, dim=-1).indices
    vec = torch.ones(importance.shape, dtype=torch.float32, device=importance.device)
    src = torch.as_tensor(scale_factor, dtype=torch.float32, device=importance.device)
    return vec.scatter_(-1, idx, src.expand(idx.shape))


def awq_quantize(w_oi: torch.Tensor, importance: torch.Tensor, n_bit: int, q_group_size: int,
                 protect_ratio: float = 0.01, scale_factor=2.0) -> torch.Tensor:
    """AWQ fake-quantize one [out, in] weight given per-in-channel importance."""
    vec = _protection_scale_vec(importance, protect_ratio, scale_factor)
    w = w_oi.float() * vec[None, :]
    w = pseudo_quantize(w, n_bit=n_bit, q_group_size=q_group_size)
    return (w / vec[None, :]).to(w_oi.dtype)


def awq_search_scale_factor(w_oi: torch.Tensor, importance: torch.Tensor, n_bit: int,
                            q_group_size: int, protect_ratio: float = 0.01,
                            scale_range: tuple = (1.0, 2.0), n_grid: int = 20) -> torch.Tensor:
    """The scale factor of the grid minimizing Σ_c imp_c · Σ_o (ŵ_oc − w_oc)²,
    as a 0-d f32 tensor on the weight's device (no host readback)."""
    lo, hi = scale_range
    cands = torch.from_numpy(np.linspace(lo, hi, n_grid, dtype=np.float32)).to(w_oi.device)
    wf = w_oi.float()
    imp = importance.float()
    errs = torch.stack([
        (((awq_quantize(wf, imp, n_bit, q_group_size, protect_ratio, sf).float() - wf) ** 2)
         .sum(dim=0) * imp).sum()
        for sf in cands
    ])
    return cands[torch.argmin(errs)]  # argmin: the first minimum
