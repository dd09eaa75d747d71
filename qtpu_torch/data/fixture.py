"""Frozen dataset fixtures: pre-tokenized calibration and test shards on
disk (port of qtpu/data/fixture.py; the same files, read and written with
numpy).

Layout of a fixture directory (e.g. `fixtures/public_bytes`):
  meta.json          {"n_calib_blocks", "block_size_calib", "n_test_tokens", ...}
  calib_blocks.npy   [n_blocks, block_size] int32
  test_tokens.npy    [1, N] int32
A benchmark config names one as "fixture:<dir>".
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_fixture(out_dir: str, calib_blocks, test_tokens, meta: dict | None = None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    blocks = np.stack([np.asarray(b).reshape(-1) for b in calib_blocks])
    test = np.asarray(test_tokens, np.int32).reshape(1, -1)
    np.save(os.path.join(out_dir, "calib_blocks.npy"), blocks.astype(np.int32))
    np.save(os.path.join(out_dir, "test_tokens.npy"), test)
    info = {
        "n_calib_blocks": int(blocks.shape[0]),
        "block_size_calib": int(blocks.shape[1]),
        "n_test_tokens": int(test.shape[1]),
    }
    info.update(meta or {})
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(info, f, indent=1)


def load_fixture_calibration(fixture_dir: str, n_samples: int, block_size: int) -> list[np.ndarray]:
    """First n_samples [1, block_size] calibration blocks. The fixture must
    have been built at this block size (rows were filtered against it
    before blocking, so re-splitting would change the sample set)."""
    blocks = np.load(os.path.join(fixture_dir, "calib_blocks.npy"))
    if blocks.shape[1] != block_size:
        raise ValueError(
            f"fixture calibration block size {blocks.shape[1]} != requested "
            f"{block_size}; rebuild the fixture (tools/make_fixture.py)"
        )
    if n_samples > blocks.shape[0]:
        raise ValueError(
            f"fixture has {blocks.shape[0]} calibration blocks, requested {n_samples}"
        )
    return [blocks[i:i + 1].astype(np.int32) for i in range(n_samples)]


def load_fixture_test(fixture_dir: str) -> np.ndarray:
    return np.load(os.path.join(fixture_dir, "test_tokens.npy")).astype(np.int32)


def fixture_meta(fixture_dir: str) -> dict:
    with open(os.path.join(fixture_dir, "meta.json")) as f:
        return json.load(f)
