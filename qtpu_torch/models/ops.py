"""Shared NN ops: RMSNorm, RoPE and the quantization-aware linear (port of
qtpu/models/ops.py).

A linear site's params are {"w": dense [K, N]} or packed {"data", "scales",
"zeros"} (qtpu_torch.core.packing), optionally with a bias "b"; packed sites
go to the K1 dequant-matmul. The other packed variants of qtpu (input
"smooth" vectors, GPTQ actorder "perm", POT/APOT "codebook", W8A8 metas)
belong to later slices of the port and raise here.
"""

from __future__ import annotations

import torch

from qtpu_torch.kernels.dequant_matmul import quantized_matmul


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables of rotate-half RoPE. positions [..., S] -> [..., S, hd]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd] broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (x.float() * c + rotated.float() * s).to(x.dtype)


_LATER = {
    "smooth": "SmoothQuant/AWQ input smoothing (quantizers slice)",
    "perm": "GPTQ actorder packing (quantizers slice)",
    "codebook": "POT/APOT codebook packing, pallas_codebook_matmul (quantizers slice)",
}


def linear(x: torch.Tensor, p: dict, site_meta=None, layer=None) -> torch.Tensor:
    """y = x @ W (+ b). layer selects one layer of stacked [L, ...] params as
    zero-copy views."""
    if layer is not None:
        p = {k: v[layer] for k, v in p.items()}
    for key, what in _LATER.items():
        if key in p:
            raise NotImplementedError(f"linear site with '{key}': {what} is not ported yet")
    if site_meta is not None and len(site_meta) == 5:
        raise NotImplementedError(
            "W8A8 sites (pallas_w8a8_matmul) are not ported yet (quantizers slice)"
        )
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
    else:
        y = quantized_matmul(x, p["data"], p["scales"], p.get("zeros"), site_meta)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
