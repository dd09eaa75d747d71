"""Deterministic synthetic token corpus for offline runs (port of
qtpu/data/synthetic.py; the same numpy code, so the same bytes).

A Zipf-distributed stream with short-range repetition gives non-uniform
unigram statistics, fully determined by (seed, vocab, length).
"""

from __future__ import annotations

import numpy as np


def synthetic_token_stream(vocab_size: int, n_tokens: int, seed: int = 42) -> np.ndarray:
    """[1, n_tokens] int32 ids: Zipf unigram draws mixed with short-range
    repetition."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    ids = rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)
    # bigram structure: with p=0.3 copy the token from 2 back
    mask = rng.random(n_tokens) < 0.3
    mask[:2] = False
    idx = np.nonzero(mask)[0]
    ids[idx] = ids[idx - 2]
    return ids[None, :]


def synthetic_blocks(vocab_size: int, n_samples: int, block_size: int,
                     seed: int = 42) -> list[np.ndarray]:
    """n_samples blocks of [1, block_size] for calibration."""
    stream = synthetic_token_stream(vocab_size, n_samples * block_size, seed)
    return [stream[:, i * block_size:(i + 1) * block_size] for i in range(n_samples)]
