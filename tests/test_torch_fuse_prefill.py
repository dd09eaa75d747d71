"""qtpu's QTPU_FUSE_NORM_RESID branch at every row count, against qtpu on
the CPU, on the same numpy-made weights and packed bytes:

  K1's norm_w / resid plain version at prefill row counts vs qtpu's
  pallas_quantized_matmul_stacked with the same options (interpret mode;
  qtpu's kernel pads M and takes any row count), within that kernel's test's
  `_assert_close` (relative Frobenius 2e-2, absolute 5% of the largest output)

and the fuse branch end to end on the tiny Llama (RTN W4 g64, fused sites):
a prefill of 4 x 24 rows and decode steps at batch 40 (over the 32 rows the
options took before they reached the Hopper route), on the stacked int8 and
bf16 caches, against qtpu's forward_with_cache, which composes on the CPU
(qtpu takes the branch on a TPU only; its math is the same function):
logits within the model tests' 2e-2, each decode step fed qtpu's token and
qtpu's cache as it stood; one K1 call with norm_w and one with resid a
layer, prefill included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from qtpu.kernels.pallas_dequant_matmul import pallas_quantized_matmul_stacked
from qtpu.models import llama as jllama
from qtpu.serve.kvcache import init_cache as jax_init_cache
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.models import llama as tllama
from qtpu_torch.models.config import TINY_TEST as T_TINY
from qtpu_torch.serve.kvcache import KVCache
from test_torch_boundary import BF16, SWITCHES, _assert_close, _Spy, cpu, one_torch_thread  # noqa: F401
from test_torch_model import CFG, LOGIT_TOL, _both, _rel


@pytest.fixture(scope="module")
def both():
    return _both(packed=True)


def test_options_supported_names_the_route():
    """At M <= 8 the GEMVs (N % 4 == 0); above, the Hopper route (group 64 or
    128, N % 16 == 0) at any row count; the row cap is gone."""
    assert not hasattr(k1, "OPTION_MAX_M")
    for M in (1, 8, 9, 32, 33, 1024, 2048):
        assert k1.options_supported((4, 128, 2048, 2560), M)
        assert k1.options_supported((8, 64, 2048, 2048), M)
    assert k1.options_supported((4, 32, 256, 384), 8)
    assert not k1.options_supported((4, 32, 256, 384), 9)  # the mma.sync body: no options
    assert not k1.options_supported((4, 64, 256, 392), 33)  # N % 16 != 0 above 8 rows
    assert not k1.options_supported((4, 64, 256, 386), 1)  # N % 4 != 0
    assert not k1.options_supported((8, 256, 256, 256, "a8"), 4)  # W8A8
    assert not k1.options_supported((4, 64, 256, 256), 0)


@pytest.mark.parametrize("option", ["norm_w", "resid", "both"])
@pytest.mark.parametrize("M", [48, 200])
def test_k1_options_plain_match_pallas_at_prefill_rows(option, M):
    """qtpu's kernel at M 48 and 200 (padded to its row tile) with the
    option(s) on layer 1 of a 3-layer stack, against K1 on the layer view."""
    L, K, N, g, l = 3, 256, 256, 64, 1
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, K)).astype(np.float32).astype(BF16)
    data = rng.integers(-128, 128, (L, K // 2, N), dtype=np.int8)
    scales = (rng.random((L, K // g, N)) * 0.01 + 1e-3).astype(np.float32).astype(BF16)
    zeros = rng.integers(0, 16, (L, K // g, N), dtype=np.uint8)
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32).astype(BF16)
    resid = rng.standard_normal((M, N)).astype(np.float32).astype(BF16)
    meta = (4, g, K, N)
    use_n, use_r = option in ("norm_w", "both"), option in ("resid", "both")
    want = pallas_quantized_matmul_stacked(
        jnp.asarray(x), jnp.asarray(data), jnp.asarray(scales), jnp.asarray(zeros), meta,
        jnp.int32(l), norm_w=jnp.asarray(nw) if use_n else None,
        resid=jnp.asarray(resid) if use_r else None, eps=1e-5, interpret=True)
    got = k1.quantized_matmul(cpu(x), cpu(data[l]), cpu(scales[l]), cpu(zeros[l]), meta,
                              norm_w=cpu(nw[l]) if use_n else None,
                              resid=cpu(resid) if use_r else None, eps=1e-5)
    assert got.shape == (M, N)
    _assert_close(to_numpy(got), want)


def _port_cache(cj):
    return KVCache(*(None if a is None else to_torch(np.asarray(a), device="cpu")
                     for a in (cj.k, cj.v, cj.k_scale, cj.v_scale, cj.length)))


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("B,T,steps", [(4, 24, 1), (40, 5, 2)])
def test_fuse_branch_matches_qtpu(B, T, steps, kv, both, monkeypatch):
    """Under QTPU_FUSE_NORM_RESID=1: a prefill of B x T and `steps` decode
    steps, each within 2e-2 of qtpu's logits and each making one K1 call
    with norm_w and one with resid a layer (B 40: decode above 32 rows)."""
    pj, qj, pt, qt = both
    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)
    monkeypatch.setenv("QTPU_FUSE_NORM_RESID", "1")
    spy = _Spy(monkeypatch)
    L, S = CFG.num_layers, 32
    ids = np.random.default_rng(B).integers(0, CFG.vocab_size, (B, T), dtype=np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    cj = jax_init_cache(CFG, B, S, quantized=kv == "int8")
    for step in range(steps + 1):
        before = spy.counts()
        lt, _ = tllama.forward_with_cache(pt, cpu(ids), cpu(pos), _port_cache(cj), T_TINY, qt)
        lj, cj = jllama.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(pos), cj, CFG, qj)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL, step
        after = spy.counts()
        assert {k: after[k] - before[k] for k in after} == {"boundary": 0, "norm_w": L,
                                                             "resid": L}, step
        ids = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
