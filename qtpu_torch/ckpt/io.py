"""Save and load quantized artifacts (port of qtpu/ckpt/io.py).

A (possibly packed) params tree plus its quantization metadata, so that
calibration and quantization decouple from serving:
  save_quantized(dir, params, qmeta, extra_meta)
  params, qmeta, meta = load_quantized(dir, device="cuda")

The format is qtpu's, byte for byte, so an artifact written by either
package loads in the other: one params.npz whose keys are the tree's key
paths joined by "::", and meta.json with pack_format, qmeta as lists,
each array's numpy dtype name and the user's meta. Packed int4 bytes stay
packed; bf16 tensors are stored as a uint16 view (npz has no bf16), made
and read through int16 views on the torch side, never through ml_dtypes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from qtpu_torch.core.packing import PACK_FORMAT

_SEP = "::"


def _flatten(params) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + [k], v)
        elif node is not None:
            flat[_SEP.join(prefix)] = node

    rec([], params)
    return flat


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array as stored, numpy dtype name) of one leaf."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_quantized(out_dir, params, qmeta=None, meta: dict | None = None):
    """Write params (+ qmeta, + user meta) under out_dir."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(params).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(out / "params.npz", **arrays)
    with open(out / "meta.json", "w") as f:
        json.dump(
            {
                "pack_format": PACK_FORMAT,
                "qmeta": [[s, list(m)] for s, m in (qmeta or ())],
                "dtypes": dtypes,
                "meta": meta or {},
            },
            f,
            indent=2,
        )


def load_quantized(in_dir, device="cuda"):
    """(params, qmeta, meta), the tensors on `device`. qmeta is the tuple
    form the model forward takes (None if the artifact had none)."""
    ind = Path(in_dir)
    with open(ind / "meta.json") as f:
        info = json.load(f)
    fmt = int(info.get("pack_format", 1))
    if fmt not in (1, PACK_FORMAT):
        raise ValueError(
            f"checkpoint pack_format={fmt} is newer than this qtpu_torch "
            f"(supports <= {PACK_FORMAT}); upgrade qtpu_torch to load it"
        )
    qmeta = tuple((s, tuple(m)) for s, m in info.get("qmeta", [])) or None
    # sites whose packed int4 bytes need the v1 -> v2 hi-nibble migration
    w4_sites = {s for s, m in (qmeta or ()) if int(m[0]) == 4}
    flat = {}
    with np.load(ind / "params.npz") as data:
        for k in data.files:
            a = data[k]
            if info["dtypes"].get(k) == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                if fmt < 2 and a.dtype == np.int8:
                    parts = k.split(_SEP)
                    if len(parts) >= 2 and parts[-1] == "data" and parts[-2] in w4_sites:
                        # v1 stored (lo | hi << 4); v2 stores (lo | (hi^8) << 4),
                        # equivalently byte ^ 0x80
                        a = (a.view(np.uint8) ^ np.uint8(0x80)).view(np.int8)
                t = torch.from_numpy(a)
            flat[k] = t.to(device)
    return _unflatten(flat), qmeta, info.get("meta", {})
