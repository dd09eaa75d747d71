"""Perplexity evaluation with the reference math (port of
qtpu/eval/perplexity.py:23-75; quantization_utils.py:269-322):

  - the [1, N] token stream is cut into non-overlapping `block_size` blocks
  - logits are f32 before the shifted cross-entropy
  - per-block nll = mean token loss (over block_size - 1 positions) times
    block_size
  - ppl = exp(sum of nll / (n_samples * block_size))

The block nlls are summed on the device and read back once; a block's
logits ([1, block_size, V] f32) live only until its loss is taken.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn


def block_nll(forward, params, batch, cfg, qmeta=None) -> torch.Tensor:
    """Mean shifted cross-entropy of one [1, S] block, an f32 scalar on the
    device."""
    logits = forward(params, batch, cfg, qmeta=qmeta)
    V = logits.shape[-1]
    return Fn.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                            batch[:, 1:].reshape(-1).long())


@torch.inference_mode()
def evaluate_perplexity(params, test_ids, cfg, n_samples: int = 40, block_size: int = 2048,
                        qmeta=None, arch: str = "llama", mesh=None,
                        verbose: bool = False) -> float:
    """test_ids: [1, N] token stream (numpy or tensor). Runs on the device
    of params["embed"]. Returns the perplexity."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded and pipelined perplexity are not ported yet (sharding slice)"
        )
    from qtpu_torch.models import get_arch

    forward = get_arch(arch).forward
    device = params["embed"].device
    ids = test_ids if isinstance(test_ids, torch.Tensor) else torch.from_numpy(np.asarray(test_ids))
    ids = ids.to(device)
    n = min(n_samples, ids.shape[1] // block_size)
    if n <= 0:
        raise ValueError(f"the test stream of {ids.shape[1]} tokens holds no block of {block_size}")
    total = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n):
        batch = ids[:, i * block_size:(i + 1) * block_size]
        total += block_nll(forward, params, batch, cfg, qmeta) * block_size
        if verbose and (i + 1) % 8 == 0:
            print(f"  eval block {i + 1}/{n}")
    return float(torch.exp(total / (n * block_size)))
