"""A reader of the safetensors format straight into torch tensors.

The format: an 8-byte little-endian header length n, n bytes of a JSON
header {name: {"dtype", "shape", "data_offsets": [begin, end]}} (plus an
optional "__metadata__" entry), then the raw little-endian bytes, the
offsets counted from the end of the header. A sharded checkpoint is
several such files, named by `model.safetensors.index.json`'s weight_map.

The port reads the format itself: the card's machine has no `safetensors`
package, and without `ml_dtypes` numpy has no bf16, which most published
checkpoints are stored in. Each file is read once into one buffer and every
tensor is a view of it (torch.frombuffer), so nothing is converted here.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
INDEX = "model.safetensors.index.json"


def load_file(path) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of one .safetensors file, views of one buffer
    holding the whole file."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)  # one copy, straight into the buffer the tensors view
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes runs past the file's {len(buf)}")
    header = json.loads(buf[8:8 + n].decode("utf-8"))
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor '{name}' has dtype {info['dtype']}, which the "
                             f"reader does not take (it takes {sorted(DTYPES)})")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * dtype.itemsize or start + end > len(buf):
            raise ValueError(f"{path}: tensor '{name}' of {info['dtype']} {shape} has "
                             f"offsets {begin}..{end}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=start + begin).reshape(shape)
    return out


def shard_files(ckpt_dir) -> list[Path]:
    """The .safetensors files of a checkpoint directory: those its index
    names, in the index's order of first use, or else every
    *.safetensors file in sorted order."""
    d = Path(ckpt_dir)
    index = d / INDEX
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        return [d / f for f in dict.fromkeys(weight_map.values())]
    return sorted(d.glob("*.safetensors"))


def load_dir(ckpt_dir) -> dict[str, torch.Tensor]:
    """Every tensor of a (possibly sharded) safetensors checkpoint."""
    tensors = {}
    for f in shard_files(ckpt_dir):
        tensors.update(load_file(f))
    return tensors
