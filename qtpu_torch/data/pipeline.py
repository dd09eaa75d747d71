"""Calibration and test dataset pipelines (port of qtpu/data/pipeline.py).

Three sources, with qtpu's semantics: "fixture:<dir>" loads frozen tokens;
"synthetic" (or any dataset when there is no tokenizer, qtpu's rule) draws
the deterministic synthetic stream; any other name is a Hugging Face
dataset, loaded with `datasets.load_dataset` (imported on that branch
only) and tokenized with the given tokenizer: for calibration the
reference's preprocessing (seed shuffle, strip, drop blank and over-long
rows, stop at n_samples, concatenate, floor-split into blocks), for the
test set the rows joined by blank lines and tokenized once.
"""

from __future__ import annotations

import numpy as np

from qtpu_torch.data.fixture import load_fixture_calibration, load_fixture_test
from qtpu_torch.data.synthetic import synthetic_blocks, synthetic_token_stream

FIXTURE = "fixture:"


def _load_hf(dataset_name: str, dataset_config, split: str):
    from datasets import load_dataset

    if dataset_config is None:
        return load_dataset(dataset_name, split=split)
    return load_dataset(dataset_name, dataset_config, split=split)


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
    dataset = _load_hf(dataset_name, dataset_config, split)
    return prepare_calibration_samples(dataset, tokenizer, n_samples, block_size, seed)


def block_pack(samples: list[np.ndarray], block_size: int) -> list[np.ndarray]:
    """Concatenate ragged token samples and floor-split them into
    [1, block_size] int32 blocks (the tail shorter than a block is
    dropped); the blocks qtpu's native packer gives."""
    flat = np.concatenate([np.asarray(s, np.int32).reshape(-1) for s in samples])
    n_blocks = flat.size // block_size
    return [flat[i * block_size:(i + 1) * block_size][None, :] for i in range(n_blocks)]


def prepare_calibration_samples(dataset, tokenizer, n_samples: int, block_size: int,
                                seed: int = 42) -> list[np.ndarray]:
    """The reference's calibration preprocessing on an in-memory dataset:
    seed shuffle, strip, drop blanks and rows tokenizing longer than
    block_size, stop at n_samples, concatenate, floor-split into blocks."""
    dataset = dataset.shuffle(seed=seed)
    samples = []
    for data in dataset:
        line = data["text"].strip()
        if not line:
            continue
        encoded = tokenizer.encode(line)
        if len(encoded) > block_size or len(encoded) == 0:
            continue
        samples.append(np.asarray(encoded, np.int32))
        if len(samples) == n_samples:
            break
    if not samples:
        raise ValueError("No valid samples found in dataset")
    return block_pack(samples, block_size)


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
    dataset = _load_hf(dataset_name, dataset_config, split)
    text_data = "\n\n".join(dataset["text"])
    ids = tokenizer(text_data, return_tensors="np").input_ids
    return ids.astype(np.int32)
