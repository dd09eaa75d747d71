"""Group reshape helpers shared by the quantizers (port of qtpu/core/groups.py).

A weight in reference orientation [out, in] is reshaped to
[n_groups, group_size] along its last axis (quantization_utils.py:383-387);
group_size <= 0 means one group per row (per output channel).
"""

from __future__ import annotations

import torch


def to_groups(w: torch.Tensor, group_size: int) -> tuple[torch.Tensor, tuple]:
    """[..., C] -> ([n_groups, group_size], original shape)."""
    orig_shape = tuple(w.shape)
    if group_size > 0:
        if orig_shape[-1] % group_size != 0:
            raise ValueError(
                f"last dim {orig_shape[-1]} not divisible by group_size {group_size}"
            )
        w = w.reshape(-1, group_size)
    elif w.dim() != 2:
        w = w.reshape(orig_shape[0], -1)
    return w, orig_shape


def from_groups(w: torch.Tensor, orig_shape: tuple) -> torch.Tensor:
    """Inverse of to_groups."""
    return w.reshape(orig_shape)


def num_groups(shape: tuple, group_size: int) -> int:
    if group_size > 0:
        total = 1
        for d in shape:
            total *= d
        return total // group_size
    return shape[0]
