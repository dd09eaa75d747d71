"""Model size accounting (port of qtpu/core/sizing.py).

`get_model_size` is the reference's arithmetic model
(quantization_utils.py:329-355): every element of every parameter,
embeddings and norms included, costs w_bit + 16/group (scale) + 4/group
(zero point, if used) bits. `get_packed_size` counts the stored bits of a
params tree that mixes dense tensors and QuantizedTensor leaves. Params are
nested dicts (lists and tuples also walk); None leaves count nothing.
"""

from __future__ import annotations

from qtpu_torch.core.dtypes import MiB
from qtpu_torch.core.packing import QuantizedTensor


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def count_params(params) -> int:
    """Total element count of a params tree (a QuantizedTensor counts the
    elements of the weight it stands for). Works on meta tensors."""
    total = 0
    for leaf in _leaves(params):
        total += _numel(leaf.shape) if isinstance(leaf, QuantizedTensor) else leaf.numel()
    return total


def get_model_size(params, data_width: int = 16, group_size: int = -1,
                   use_zero_point: bool = True) -> float:
    """Size in bits under the reference's accounting model."""
    width = float(data_width)
    if group_size != -1:
        width += 16 / group_size
        if use_zero_point:
            width += 4 / group_size
    return count_params(params) * width


def get_packed_size(params) -> int:
    """Exact stored bits of a params tree."""
    bits = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedTensor):
            bits += leaf.storage_bits()
        else:
            bits += leaf.numel() * leaf.element_size() * 8
    return bits


def bits_to_mb(bits: float) -> float:
    return bits / MiB
