"""K5's plain version and the port's CPU attention against qtpu.

`flash_attention_plain` is held to `pallas_flash_attention` run in
interpret mode at the shapes tests/test_pallas_kernels.py uses, with its
tolerance (rtol = atol = 2e-2, f32 inputs), at head_dim 64 and at the other
head dims the kernel takes (48, 80, 96, 112). The port's CPU
`causal_attention` is held to qtpu's XLA attention at a ragged S (no
multiple of 128), where qtpu itself leaves the Pallas kernel. The kernel
against its plain version on the card is in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.kernels.pallas_flash_attention import pallas_flash_attention
from qtpu.models.ops import causal_attention as jax_causal_attention
from qtpu_torch.kernels import flash_attention as k5
from qtpu_torch.models.ops import causal_attention

BF16 = ml_dtypes.bfloat16


def _qkv(B, H, KV, S, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, hd)) * 0.5).astype(np.float32).astype(dtype)
    k = (rng.standard_normal((B, KV, S, hd)) * 0.5).astype(np.float32).astype(dtype)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32).astype(dtype)
    return q, k, v


def _plain_vs_pallas(KV, window, hd):
    q, k, v = _qkv(2, 8, KV, 256, hd, seed=3)
    want = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, interpret=True)
    got = k5.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("KV", [2, 8])
@pytest.mark.parametrize("window", [0, 200])
def test_plain_matches_pallas_interpret(KV, window):
    _plain_vs_pallas(KV, window, 64)


@pytest.mark.parametrize("hd", [48, 80, 96, 112])
@pytest.mark.parametrize("KV", [2, 8])
@pytest.mark.parametrize("window", [0, 200])
def test_plain_matches_pallas_interpret_at_head_dims(KV, window, hd):
    """The head dims K5 takes besides 64 and 128 (OPT-2.7B's 80 among
    them), at the same shapes and tolerance."""
    _plain_vs_pallas(KV, window, hd)


def test_wrapper_on_cpu_takes_the_plain_version_on_strided_views():
    """A CPU tensor takes the plain version (no launch is counted), also on
    the [B, S, H, hd] -> [B, H, S, hd] transpose views causal_attention
    passes on the card."""
    q, k, v = _qkv(1, 4, 2, 40, 64, seed=5, dtype=BF16)
    views = [torch.from_numpy(np.ascontiguousarray(a.view(np.uint16).transpose(0, 2, 1, 3)))
             .view(torch.bfloat16).transpose(1, 2) for a in (q, k, v)]
    contig = [torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) for a in (q, k, v)]
    n0 = k5.flash_attention.launches
    got = k5.flash_attention(*views, 16)
    assert k5.flash_attention.launches == n0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 4, 40, 64)
    torch.testing.assert_close(got, k5.flash_attention_plain(*contig, 16), rtol=0, atol=0)


@pytest.mark.parametrize("S,window", [(50, 0), (50, 12), (77, 0)])
def test_cpu_causal_attention_matches_qtpu(S, window):
    """Ragged S, GQA (H 8, KV 2): the port's CPU path is qtpu's einsum math.
    Tolerance 2e-2 relative: both round the probabilities to bf16, qtpu also
    rounds the PV product's output through a bf16 einsum."""
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
               for a in _qkv(2, 8, 2, S, 64, seed=7, dtype=BF16))
    i = np.arange(S)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    want = jax_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask)[None, None], window=window)
    tq, tk, tv = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) for a in (q, k, v))
    got = causal_attention(tq, tk, tv, window=window)
    assert tuple(got.shape) == (2, S, 8 * 64) and got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2
