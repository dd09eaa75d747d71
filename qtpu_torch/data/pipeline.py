"""Calibration and test dataset pipelines (port of qtpu/data/pipeline.py).

Two sources, with qtpu's semantics: "fixture:<dir>" loads frozen tokens,
and "synthetic" (or any dataset when there is no tokenizer, qtpu's rule)
draws the deterministic synthetic stream. The Hugging Face `datasets` path
(a named dataset with a tokenizer) comes with the hf_import slice and
raises here.
"""

from __future__ import annotations

import numpy as np

from qtpu_torch.data.fixture import load_fixture_calibration, load_fixture_test
from qtpu_torch.data.synthetic import synthetic_blocks, synthetic_token_stream

FIXTURE = "fixture:"


def _hf_not_ported(dataset_name: str):
    raise NotImplementedError(
        f"dataset '{dataset_name}' with a tokenizer needs the Hugging Face datasets "
        "path, which is not ported yet (hf_import slice)"
    )


def get_calibration_dataset(tokenizer, dataset_name: str, dataset_config, split: str,
                            n_samples: int = 256, block_size: int = 512,
                            vocab_size: int | None = None, seed: int = 42) -> list[np.ndarray]:
    """A list of [1, block_size] int32 arrays."""
    if dataset_name.startswith(FIXTURE):
        return load_fixture_calibration(dataset_name[len(FIXTURE):], n_samples, block_size)
    if dataset_name == "synthetic" or tokenizer is None:
        if vocab_size is None:
            raise ValueError("synthetic calibration needs vocab_size")
        return synthetic_blocks(vocab_size, n_samples, block_size, seed)
    _hf_not_ported(dataset_name)


def get_test_dataset(tokenizer, dataset_name: str, dataset_config, split: str,
                     n_samples: int = 40, block_size: int = 2048,
                     vocab_size: int | None = None, seed: int = 1234) -> np.ndarray:
    """A single [1, N] int32 token stream."""
    if dataset_name.startswith(FIXTURE):
        return load_fixture_test(dataset_name[len(FIXTURE):])
    if dataset_name == "synthetic" or tokenizer is None:
        if vocab_size is None:
            raise ValueError("synthetic test set needs vocab_size")
        return synthetic_token_stream(vocab_size, n_samples * block_size, seed)
    _hf_not_ported(dataset_name)
