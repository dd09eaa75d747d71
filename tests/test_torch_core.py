"""qtpu_torch.core against qtpu.core: packed bytes, scales and zeros must be
identical, and dequantization identical, for W2/W4/W8 x sym/asym."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.core import packing as jp
from qtpu_torch.convert import params_to_numpy, params_to_torch, to_numpy, to_torch
from qtpu_torch.core import packing as tp


def cpu(a):
    """numpy -> a tensor on the CPU (the port's entry points default to cuda)."""
    return to_torch(a, device="cpu")


K, N = 256, 96


def _w(seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("group", [32, 128])
def test_quantize_pack_bytes_equal(bits, sym, group):
    w = _w(bits * 10 + group, ml_dtypes.bfloat16)
    qj = jp.quantize_pack(jnp.asarray(w), bits, group, symmetric=sym)
    qt = tp.quantize_pack(cpu(w), bits, group, symmetric=sym)
    np.testing.assert_array_equal(to_numpy(qt.data), np.asarray(qj.data))
    np.testing.assert_array_equal(
        to_numpy(qt.scales).view(np.uint16), np.asarray(qj.scales).view(np.uint16)
    )
    if sym:
        assert qt.zeros is None and qj.zeros is None
    else:
        np.testing.assert_array_equal(to_numpy(qt.zeros), np.asarray(qj.zeros))
    assert qt.storage_bits() == qj.storage_bits()
    # dequantize: identical bf16 bits
    dj = np.asarray(jp.dequantize(qj)).view(np.uint16)
    dt = to_numpy(tp.dequantize(qt)).view(np.uint16)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("bits", [2, 4])
def test_unpack_inverts_pack(bits):
    g = 16
    q = np.random.default_rng(bits).integers(0, 2**bits, (64, 8), dtype=np.uint8)
    pack, unpack = (tp.pack_int4, tp.unpack_int4) if bits == 4 else (tp.pack_int2, tp.unpack_int2)
    packed = pack(torch.from_numpy(q), g)
    np.testing.assert_array_equal(unpack(packed, g).numpy(), q)
    jpack = jp.pack_int4 if bits == 4 else jp.pack_int2
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack(jnp.asarray(q), g)))


def test_pack_format_and_convert_roundtrip():
    assert tp.PACK_FORMAT == jp.PACK_FORMAT
    tree = {"a": _w(1, ml_dtypes.bfloat16), "b": {"c": np.arange(6, dtype=np.int8)}}
    t = params_to_torch(tree, device="cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"]["c"].dtype == torch.int8
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["a"].view(np.uint16), tree["a"].view(np.uint16))
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
