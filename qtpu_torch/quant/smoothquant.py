"""SmoothQuant, activation-to-weight difficulty migration (port of
qtpu/quant/smoothquant.py).

Per linear layer s = clamp(act_max, 1e-5)^α / clamp(max_o |W|, 1e-5)^(1−α)
over input channels; W <- W / s and the activation is multiplied by s (a
per-site "smooth" vector of the linear op, or folded into the preceding
norm at serving time), then RTN. `search_alpha` is qtpu's activation-
weighted reconstruction-error grid search over α (first minimum wins).

`torch.pow` and XLA's pow may differ by an ulp or two (torch computes
x^0.5 as sqrt); tests/test_torch_quant.py reports the gap.

Weights are in reference orientation [out, in].
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.quant.rtn import pseudo_quantize


def smoothing_from_max(act_max: torch.Tensor, w_max: torch.Tensor, alpha) -> torch.Tensor:
    """clamp(clamp(a, 1e-5)^α / clamp(wmax, 1e-5)^(1−α), 1e-5) in f32."""
    a = torch.clamp(act_max.float(), min=1e-5)
    wm = torch.clamp(w_max.float(), min=1e-5)
    return torch.clamp(torch.pow(a, alpha) / torch.pow(wm, 1.0 - alpha), min=1e-5)


def compute_smoothing_scales(act_max: torch.Tensor, w_oi: torch.Tensor, alpha) -> torch.Tensor:
    """s per input channel from the activation max and the weight's
    per-input-channel max |W| (smooth_quant_quantizer.py:156-166)."""
    return smoothing_from_max(act_max, w_oi.float().abs().amax(dim=0), alpha)


def smooth_weights(w_oi: torch.Tensor, smoothing_scale: torch.Tensor) -> torch.Tensor:
    """W' = W · diag(s⁻¹) over input channels."""
    return (w_oi.float() / smoothing_scale[None, :]).to(w_oi.dtype)


def reverse_smoothing(w_oi: torch.Tensor, smoothing_scale: torch.Tensor) -> torch.Tensor:
    """The inverse of smooth_weights."""
    return (w_oi.float() * smoothing_scale[None, :]).to(w_oi.dtype)


def smoothquant_quantize(w_oi: torch.Tensor, act_max: torch.Tensor, n_bit: int,
                         q_group_size: int, alpha=0.5):
    """Smooth then RTN one layer: (fake-quantized smoothed weight, s). The
    caller multiplies the activations by s."""
    s = compute_smoothing_scales(act_max, w_oi, alpha)
    w_q = pseudo_quantize(smooth_weights(w_oi, s), n_bit=n_bit, q_group_size=q_group_size)
    return w_q, s


def search_alpha(w_oi: torch.Tensor, act_max: torch.Tensor, n_bit: int = 8,
                 q_group_size: int = -1, alpha_range: tuple = (0.0, 1.0),
                 n_grid: int = 20) -> torch.Tensor:
    """The α of the grid minimizing Σ_c act_max_c · Σ_o (ŵ_oc·s_c − w_oc)²,
    as a 0-d f32 tensor on the weight's device."""
    lo, hi = alpha_range
    alphas = torch.from_numpy(np.linspace(lo, hi, n_grid, dtype=np.float32)).to(w_oi.device)
    wf = w_oi.float()
    amax = torch.clamp(act_max.float(), min=1e-5)
    wmax = torch.clamp(wf.abs().amax(dim=0), min=1e-5)
    errs = []
    for alpha in alphas:
        s = torch.clamp(torch.pow(amax, alpha) / torch.pow(wmax, 1.0 - alpha), min=1e-5)
        w_q = pseudo_quantize(wf / s[None, :], n_bit=n_bit, q_group_size=q_group_size)
        errs.append((((w_q.float() * s[None, :] - wf) ** 2).sum(dim=0) * amax).sum())
    return alphas[torch.argmin(torch.stack(errs))]
