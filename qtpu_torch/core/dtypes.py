"""Size units and dtype policy (port of qtpu/core/dtypes.py): bf16
params/activations, f32 accumulation, int8 containers for packed W2/W4/W8
weights, bf16 per-group scales."""

import torch

# Bits per unit (reference quantization_utils.py:38-41).
Byte = 8
KiB = 1024 * Byte
MiB = 1024 * KiB
GiB = 1024 * MiB

SCALE_DTYPE = torch.bfloat16  # per-group scales
