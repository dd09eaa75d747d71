"""Round-to-nearest uniform fake quantization (port of qtpu/quant/rtn.py).

Both functions take a weight in reference orientation [out, in] and group
its last axis (`q_group_size` > 0) or quantize each row whole
(`q_group_size` <= 0, 2-D only), in f32, returning the original shape and
dtype:

- `pseudo_quantize`: asymmetric per-group quantize -> dequantize
  (quantization_utils.py:362-413): scale = clamp(max - min, 1e-5) /
  (2^b - 1), zero = clamp(round(-min / scale), 0, 2^b - 1).
- `symmetric_fake_quantize`: the GPTQ fallback (gptq_quantizer.py:94-99):
  scale = clamp(absmax / (2^b - 1), 1e-5), clamp(round(w / scale),
  -max_int - 1, max_int), the reference's asymmetric clamp floor kept.

torch.round and jnp.round both round half to even. XLA folds a division
by the constant 2^b - 1 into a multiply by its f32 reciprocal, which moves
about a third of the scales by one ulp; the port multiplies by the same
reciprocal, so the results equal qtpu's bit for bit
(tests/test_torch_eval.py).
"""

from __future__ import annotations

import torch


def _grouped(w: torch.Tensor, q_group_size: int, need_2d: bool) -> torch.Tensor:
    if q_group_size > 0:
        if w.shape[-1] % q_group_size != 0:
            raise ValueError(f"last dim {w.shape[-1]} % group {q_group_size} != 0")
        w = w.reshape(-1, q_group_size)
    if need_2d and w.dim() != 2:
        raise ValueError("expected 2-D tensor when q_group_size <= 0")
    return w.to(torch.float32)


def pseudo_quantize(w: torch.Tensor, n_bit: int = 4, q_group_size: int = -1) -> torch.Tensor:
    """Asymmetric per-group fake quantization, reference parity."""
    wf = _grouped(w, q_group_size, need_2d=True)
    max_val = wf.amax(dim=1, keepdim=True)
    min_val = wf.amin(dim=1, keepdim=True)
    max_int = 2**n_bit - 1
    scales = torch.clamp(max_val - min_val, min=1e-5) * (1.0 / max_int)
    zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)
    w_q = torch.clamp(torch.round(wf / scales) + zeros, 0, max_int)
    return ((w_q - zeros) * scales).reshape(w.shape).to(w.dtype)


def symmetric_fake_quantize(w: torch.Tensor, n_bit: int = 4,
                            q_group_size: int = -1) -> torch.Tensor:
    """Symmetric per-group fake quantization (GPTQ-fallback parity)."""
    wf = _grouped(w, q_group_size, need_2d=False)
    max_int = 2**n_bit - 1
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scales = torch.clamp(absmax * (1.0 / max_int), min=1e-5)
    w_q = torch.clamp(torch.round(wf / scales), -max_int - 1, max_int)
    return (w_q * scales).reshape(w.shape).to(w.dtype)
