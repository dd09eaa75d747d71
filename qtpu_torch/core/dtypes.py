"""Size units and dtype policy (port of qtpu/core/dtypes.py): bf16
params/activations, f32 accumulation, int8 containers for packed W2/W4/W8
weights, bf16 per-group scales."""

import torch

# Bits per unit (reference quantization_utils.py:38-41).
Byte = 8
KiB = 1024 * Byte
MiB = 1024 * KiB
GiB = 1024 * MiB

# String -> dtype map of the config's "dtype" key (quantization_utils.py:66-71).
DTYPE_MAP = {
    "float16": torch.float16,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    None: None,
}

SCALE_DTYPE = torch.bfloat16  # per-group scales


def resolve_dtype(name):
    """A config dtype string (or a torch dtype) -> torch dtype; None passes."""
    if isinstance(name, torch.dtype):
        return name
    if name in DTYPE_MAP:
        return DTYPE_MAP[name]
    d = getattr(torch, str(name), None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return d


def bits_of(dtype) -> int:
    """Bits per element of a torch dtype."""
    return resolve_dtype(dtype).itemsize * 8
