"""Packed integer weight storage (port of qtpu/core/packing.py).

Byte-identical to qtpu: W8 as int8 biased by -128, W4 as two nibbles per
byte in the GROUP-HALVES layout with an excess-8 high nibble, W2 as four
values per byte in the GROUP-QUARTERS layout, all packed along the
contraction axis K of a [K, N] weight. Scales are bf16 [K/g, N];
asymmetric zero-points are uint8 [K/g, N] in the quantized domain.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from qtpu_torch.core.dtypes import SCALE_DTYPE

# Persisted packed-byte format version (2: excess-8 hi nibble), the same
# number qtpu writes into checkpoint metadata.
PACK_FORMAT = 2


def pack_int4(q: torch.Tensor, group_size: int | None = None) -> torch.Tensor:
    """Pack values in [0, 15] along axis 0 into int8 bytes: within each
    group of `group_size` rows, byte j holds row j in the low nibble and
    row j + group/2 in the high nibble, stored as (hi ^ 8)."""
    K = q.shape[0]
    g = group_size if group_size else K
    if K % g != 0 or g % 2 != 0:
        raise ValueError(f"K={K} must be divisible by even group_size={g}")
    qg = q.to(torch.uint8).reshape(K // g, g, *q.shape[1:])
    lo = qg[:, : g // 2]
    hi = qg[:, g // 2 :]
    b = lo | ((hi ^ 8) << 4)
    return b.reshape(K // 2, *q.shape[1:]).view(torch.int8)


def pack_int2(q: torch.Tensor, group_size: int) -> torch.Tensor:
    """Pack values in [0, 3] along axis 0: within each group of g rows,
    byte j holds rows (j, j+g/4, j+g/2, j+3g/4) in bit pairs 0-1 .. 6-7."""
    K = q.shape[0]
    g = group_size
    if K % g != 0 or g % 4 != 0:
        raise ValueError(f"K={K} must be divisible by group_size={g} % 4 == 0")
    qg = q.to(torch.uint8).reshape(K // g, 4, g // 4, *q.shape[1:])
    b = qg[:, 0] | (qg[:, 1] << 2) | (qg[:, 2] << 4) | (qg[:, 3] << 6)
    return b.reshape(K // 4, *q.shape[1:]).view(torch.int8)


def unpack_int2(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Inverse of pack_int2 -> uint8 values in [0, 3], axis 0 x4."""
    K4 = packed.shape[0]
    g = group_size
    p = packed.view(torch.uint8).reshape(4 * K4 // g, g // 4, *packed.shape[1:])
    out = torch.cat([(p >> (2 * i)) & 3 for i in range(4)], dim=1)
    return out.reshape(4 * K4, *packed.shape[1:])


def unpack_int4(packed: torch.Tensor, group_size: int | None = None) -> torch.Tensor:
    """Inverse of pack_int4 -> uint8 values in [0, 15], axis 0 doubled."""
    K2 = packed.shape[0]
    g = group_size if group_size else 2 * K2
    p = packed.view(torch.uint8).reshape(2 * K2 // g, g // 2, *packed.shape[1:])
    lo = p & 0xF
    hi = (p >> 4) ^ 8  # undo the excess-8 storage
    return torch.cat([lo, hi], dim=1).reshape(2 * K2, *packed.shape[1:])


@dataclass
class QuantizedTensor:
    """Packed quantized weight + per-group metadata.

    data:   int8 [K, N] (w8), [K/2, N] (w4) or [K/4, N] (w2)
    scales: [K/group, N] bf16
    zeros:  [K/group, N] uint8 zero-points, or None for symmetric
    """

    data: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor | None
    bits: int
    group_size: int
    shape: tuple

    @property
    def symmetric(self) -> bool:
        return self.zeros is None

    def storage_bits(self) -> int:
        """Stored bits (packed ints + scales + zeros)."""
        n = 1
        for d in self.shape:
            n *= d
        bits = n * self.bits
        n_groups = self.scales.numel()
        bits += n_groups * 16
        if self.zeros is not None:
            bits += n_groups * self.bits
        return bits


def quantize_pack(
    w: torch.Tensor, bits: int, group_size: int, symmetric: bool = False
) -> QuantizedTensor:
    """Quantize a [K, N] weight to a packed QuantizedTensor (the same f32
    arithmetic as qtpu.core.packing.quantize_pack, so the same bytes)."""
    K, N = w.shape
    g = group_size if group_size > 0 else K
    if K % g != 0:
        raise ValueError(f"K={K} not divisible by group_size={g}")
    wf = w.to(torch.float32).reshape(K // g, g, N)
    max_int = 2**bits - 1
    if symmetric:
        pos_max = 2 ** (bits - 1) - 1
        absmax = wf.abs().amax(dim=1, keepdim=True)
        scales = torch.clamp(absmax / pos_max, min=1e-5)
        q = torch.clamp(torch.round(wf / scales), -pos_max - 1, pos_max)
        store = q + 2 ** (bits - 1)
        zeros = None
    else:
        max_val = wf.amax(dim=1, keepdim=True)
        min_val = wf.amin(dim=1, keepdim=True)
        scales = torch.clamp(max_val - min_val, min=1e-5) / max_int
        zp = torch.clamp(torch.round(-min_val / scales), 0, max_int)
        store = torch.clamp(torch.round(wf / scales) + zp, 0, max_int)
        zeros = zp.reshape(K // g, N).to(torch.uint8)
    store = store.reshape(K, N)
    scales2 = scales.reshape(K // g, N).to(SCALE_DTYPE)
    if bits == 2:
        data = pack_int2(store.to(torch.uint8), g)
    elif bits == 4:
        data = pack_int4(store.to(torch.uint8), g)
    elif bits == 8:
        data = (store.to(torch.int32) - 128).to(torch.int8)
    else:
        raise ValueError(f"packed storage supports bits in (2, 4, 8), got {bits}")
    return QuantizedTensor(
        data=data, scales=scales2, zeros=zeros, bits=bits, group_size=g, shape=(K, N)
    )


def dequantize(qt: QuantizedTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain dequantization of a QuantizedTensor -> [K, N]."""
    return dequantize_parts(
        qt.data, qt.scales, qt.zeros, qt.bits, qt.group_size, out_dtype
    )


def dequantize_parts(data, scales, zeros, bits, group_size, out_dtype=torch.bfloat16):
    """(q - z) * s in f32 per group, cast once to out_dtype (qtpu's
    `dequantize` and `_dequant_ref`)."""
    if bits == 2:
        qu = unpack_int2(data, group_size).to(torch.int32)
    elif bits == 4:
        qu = unpack_int4(data, group_size).to(torch.int32)
    else:
        qu = data.to(torch.int32) + 128  # back to [0, 255]
    K, N = qu.shape
    g = group_size
    qu = qu.reshape(K // g, g, N)
    s = scales.to(torch.float32).reshape(K // g, 1, N)
    if zeros is not None:
        z = zeros.to(torch.int32).reshape(K // g, 1, N)
    else:
        z = 2 ** (bits - 1)
    w = (qu - z).to(torch.float32) * s
    return w.reshape(K, N).to(out_dtype)
