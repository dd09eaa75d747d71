"""ctypes bindings of the native C++ host runtime (port of qtpu/native).

The source is `qtpu_torch/csrc/qtpu_native.cpp` (qtpu_native.cpp of qtpu,
unchanged in its code). It is built at first use with the host C++
compiler and qtpu's flags (`kernels/_build.py`, `build_host`; without
-fopenmp where the compiler has no OpenMP runtime) into the kernels' build
directory. Every entry point has a numpy fallback (the port's own packers)
for a machine without a host compiler, as in qtpu; a build that fails on a
machine with one raises. `available()` says which path is live,
`build_info()` what was built. The arrays are numpy, on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_tried = False
_built = None  # (library path, compiler flags) once loaded
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _load():
    global _lib, _tried, _built
    if _tried:
        return _lib
    _tried = True
    from qtpu_torch.kernels import _build

    try:
        _build.host_compiler()
    except RuntimeError:  # no toolchain: the numpy path, as in qtpu
        return None
    path, flags = _build.build_host("qtpu_native")  # a failed build raises
    lib = ctypes.CDLL(str(path))
    lib.qtpu_version.argtypes, lib.qtpu_version.restype = [], ctypes.c_int
    lib.qtpu_pack_int4.argtypes = [_P, _I64, _I64, _I64, _P]
    lib.qtpu_unpack_int4.argtypes = [_P, _I64, _I64, _I64, _P]
    lib.qtpu_quantize_pack.argtypes = [_P, _I64, _I64, _I64, ctypes.c_int, _P, _P, _P]
    lib.qtpu_block_pack.argtypes = [_P, _P, _I64, _I64, _P, _I64]
    for fn in ("qtpu_pack_int4", "qtpu_unpack_int4", "qtpu_quantize_pack"):
        getattr(lib, fn).restype = None
    lib.qtpu_block_pack.restype = ctypes.c_int64
    if lib.qtpu_version() != 1:
        raise RuntimeError(f"qtpu_native version {lib.qtpu_version()}, expected 1")
    _lib, _built = lib, (str(path), flags)
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def build_info():
    """(library path, compiler flags) of the loaded library, or None."""
    _load()
    return _built


def _groups(K: int, g: int, step: int) -> None:
    if g <= 0 or K % g or g % step:
        raise ValueError(f"K={K} must be a multiple of group_size={g}, itself a multiple of {step}")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_int4(q: np.ndarray, group_size: int) -> np.ndarray:
    """Group-halves int4 pack of a [K, N] uint8 array (values in [0, 15])
    -> [K/2, N] int8, the bytes of qtpu_torch.core.packing.pack_int4."""
    q = np.ascontiguousarray(q, np.uint8)
    K, N = q.shape
    _groups(K, group_size, 2)
    lib = _load()
    if lib is None:
        import torch

        from qtpu_torch.core.packing import pack_int4 as tpack

        return tpack(torch.from_numpy(q), group_size).numpy()
    out = np.empty((K // 2, N), np.int8)
    lib.qtpu_pack_int4(_ptr(q), K, N, group_size, _ptr(out))
    return out


def unpack_int4(packed: np.ndarray, group_size: int) -> np.ndarray:
    """Inverse of pack_int4: [K/2, N] int8 -> [K, N] uint8."""
    packed = np.ascontiguousarray(packed, np.int8)
    K2, N = packed.shape
    K = 2 * K2
    _groups(K, group_size, 2)
    lib = _load()
    if lib is None:
        import torch

        from qtpu_torch.core.packing import unpack_int4 as tunpack

        return tunpack(torch.from_numpy(packed), group_size).numpy()
    out = np.empty((K, N), np.uint8)
    lib.qtpu_unpack_int4(_ptr(packed), K, N, group_size, _ptr(out))
    return out


def quantize_pack(w: np.ndarray, bits: int, group_size: int):
    """Fused asymmetric RTN quantize + pack of a [K, N] f32 weight on the
    host. Returns (data int8, scales f32 [K/g, N], zeros uint8 [K/g, N]):
    the data and zeros of qtpu_torch.core.packing.quantize_pack, and its
    scales before their bf16 rounding."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w = np.ascontiguousarray(w, np.float32)
    K, N = w.shape
    g = group_size
    _groups(K, g, 2 if bits == 4 else 1)
    lib = _load()
    if lib is None:
        import torch

        from qtpu_torch.core.packing import quantize_pack as tqp

        qt = tqp(torch.from_numpy(w), bits, g, symmetric=False)
        return qt.data.numpy(), qt.scales.float().numpy(), qt.zeros.numpy()
    data = np.empty(((K // 2) if bits == 4 else K, N), np.int8)
    scales = np.empty((K // g, N), np.float32)
    zeros = np.empty((K // g, N), np.uint8)
    lib.qtpu_quantize_pack(_ptr(w), K, N, g, bits, _ptr(data), _ptr(scales), _ptr(zeros))
    return data, scales, zeros


def block_pack(samples: list[np.ndarray], block_size: int) -> list[np.ndarray]:
    """Concatenate ragged token samples and floor-split them into [1,
    block_size] int32 blocks (the blocks of qtpu_torch.data.pipeline.block_pack)."""
    flat = np.concatenate([np.asarray(s, np.int32).reshape(-1) for s in samples])
    lengths = np.asarray([np.asarray(s).size for s in samples], np.int64)
    n_blocks = flat.size // block_size
    lib = _load()
    if lib is None:
        from qtpu_torch.data.pipeline import block_pack as np_block_pack

        return np_block_pack(samples, block_size)
    out = np.empty((n_blocks, block_size), np.int32)
    got = lib.qtpu_block_pack(_ptr(flat), _ptr(lengths), len(samples), block_size, _ptr(out),
                              n_blocks)
    return [out[i][None, :] for i in range(int(got))]
