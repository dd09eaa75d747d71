"""The port's long-context decode path against qtpu on the CPU, on the same
numpy-made inputs:

  K12 flash_decode_plain  vs qtpu pallas_decode_attention_flash,
                          pallas_decode_attention_write_banded and
                          pallas_decode_attention_write_banded_stacked
                          (interpret mode)
  decode_attention_layer  vs qtpu pallas_decode_attention (interpret mode)
  K3 decode_attention     vs qtpu pallas_decode_attention_stacked
                          (interpret mode)

each at qtpu's test shapes and at the head dims the port's kernels take
besides 32, 64 and 128 (48, 80, 96, 112: OPT-2.7B's 80 among them),

and the per-layer KV layout: the cache itself, per-layer against stacked
decoding, the continuous batcher with kv_layout="per_layer", and a prefill
plus teacher-forced decode on the per-layer cache against qtpu's. Codes
written must equal the TPU kernels' and scales qtpu's XLA cache write bit
for bit (the Pallas kernels' scales within 1e-6); outputs are held to
the 3e-2 relative error that tests/test_pallas_kernels.py holds the Pallas
kernels to (the plain version reaches 3e-3 to 5e-3 of the largest output:
it keeps f32 where the TPU kernels round p * v_scale to bf16).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.kernels.pallas_kv_attention import (
    pallas_decode_attention,
    pallas_decode_attention_flash,
    pallas_decode_attention_stacked,
    pallas_decode_attention_write_banded,
    pallas_decode_attention_write_banded_stacked,
)
from qtpu.models import llama as jllama
from qtpu.models.config import TINY_TEST as J_TINY
from qtpu.serve import kvcache as jkv
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.kernels import kv_attention as k12
from qtpu_torch.models import llama as tllama
from qtpu_torch.models.config import TINY_TEST
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.batching import ContinuousBatcher
from qtpu_torch.serve.decode import decode_step, prefill
from test_torch_model import _both

BF16 = ml_dtypes.bfloat16
OUT_TOL = 3e-2  # max |diff| / max |out|, the Pallas kernels' own test tolerance
LOGIT_TOL = 2e-2  # relative Frobenius error of the f32 logits (tests/test_serve.py:366)


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


def _rel_max(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def _inputs(seed, B, KV, G, hd, S, L=None):
    """qtpu's test inputs: q, k_new, v_new normal in bf16; int8 codes in
    [-127, 127); scales |N| * 0.01 + 1e-3 (with a leading [L] when L)."""
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32).astype(BF16)
    kn, vn = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32).astype(BF16)
              for _ in range(2))
    kc, vc = (rng.integers(-127, 127, (*lead, B, KV, S, hd), dtype=np.int8) for _ in range(2))
    ksc, vsc = ((np.abs(rng.standard_normal((*lead, B, KV, S))) * 0.01 + 1e-3).astype(np.float32)
                for _ in range(2))
    return q, kn, vn, [kc, vc, ksc, vsc]


@pytest.fixture(scope="module")
def both():
    """TINY_TEST's numpy weights RTN W4-packed and fused by both packages."""
    return _both(packed=True)


def _check_cache(got, pallas, cache, kn, vn, pos):
    """The codes equal the Pallas kernel's, and codes and scales equal
    qtpu's XLA cache write (`cache_layer_write`) bit for bit; the Pallas
    kernels' scales are held to 1e-6 (the banded stacked kernel rounds an
    ulp off its own XLA write now and then, as pallas_decode_attention_write
    does in tests/test_torch_moe.py)."""
    xla = jkv.cache_layer_write(tuple(map(jnp.asarray, cache)), jnp.asarray(kn),
                                jnp.asarray(vn), jnp.asarray(pos), True)
    for i, (g, p, x) in enumerate(zip(got, pallas, xla)):
        g = to_numpy(g)
        np.testing.assert_array_equal(g, np.asarray(x))
        if i < 2:
            np.testing.assert_array_equal(g, np.asarray(p))
        else:
            np.testing.assert_allclose(g, np.asarray(p), rtol=1e-6)


NEW_HEAD_DIMS = [48, 80, 96, 112]


@pytest.mark.parametrize("window", [0, 700])
def test_k12_plain_matches_pallas_flash(window):
    """qtpu's own flash test shape (tests/test_pallas_kernels.py:685-723):
    B 2, KV 2, G 4, hd 32, S 4096, one sequence at pos 1234 and one
    inactive at pos S + 3; and a window that starts inside the first
    2048-row block."""
    _k12_flash_case(window, 32)


@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
@pytest.mark.parametrize("window", [0, 700])
def test_k12_plain_matches_pallas_flash_at_head_dims(window, hd):
    _k12_flash_case(window, hd)


def _k12_flash_case(window, hd):
    B, KV, G, S = 2, 2, 4, 4096
    q, kn, vn, cache = _inputs(1, B, KV, G, hd, S)
    pos = np.array([1234, S + 3], np.int32)
    o_j, *c_j = pallas_decode_attention_flash(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *map(jnp.asarray, cache),
        jnp.asarray(pos), window=window, interpret=True)
    c_t = [cpu(a) for a in cache]
    out = k12.decode_attention_flash(cpu(q), cpu(kn), cpu(vn), *c_t, cpu(pos), window=window)
    _check_cache(c_t, c_j, cache, kn, vn, pos)
    assert _rel_max(to_numpy(out), o_j) < OUT_TOL
    assert k12.decode_attention_flash.launches == 0


def test_k12_flash_entry_refuses_ragged_s():
    B, KV, G, hd, S = 1, 1, 1, 32, 2056
    q, kn, vn, cache = _inputs(2, B, KV, G, hd, S)
    with pytest.raises(NotImplementedError):
        k12.decode_attention_flash(cpu(q), cpu(kn), cpu(vn), *[cpu(a) for a in cache],
                                   cpu(np.array([5], np.int32)))


@pytest.mark.parametrize("window", [0, 16])
def test_k12_plain_matches_pallas_banded(window):
    """pallas_decode_attention_write_banded at qtpu's test shape (S 256,
    positions 7, 100, 255 and an inactive S + 5)."""
    _k12_banded_case(window, 32)


@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
@pytest.mark.parametrize("window", [0, 16])
def test_k12_plain_matches_pallas_banded_at_head_dims(window, hd):
    _k12_banded_case(window, hd)


def _k12_banded_case(window, hd):
    B, KV, G, S = 4, 2, 4, 256
    q, kn, vn, cache = _inputs(0, B, KV, G, hd, S)
    pos = np.array([7, 100, 255, S + 5], np.int32)
    o_j, *c_j = pallas_decode_attention_write_banded(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *map(jnp.asarray, cache),
        jnp.asarray(pos), window=window, interpret=True)
    c_t = [cpu(a) for a in cache]
    out = k12.decode_attention_write_banded(cpu(q), cpu(kn), cpu(vn), *c_t, cpu(pos),
                                            window=window)
    _check_cache(c_t, c_j, cache, kn, vn, pos)
    assert _rel_max(to_numpy(out), o_j) < OUT_TOL


@pytest.mark.parametrize("layer", [0, 2])
def test_k12_plain_matches_pallas_banded_stacked(layer):
    """The stacked entry writes layer `layer` only; the others keep their
    bytes."""
    _k12_banded_stacked_case(layer, 32)


@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
def test_k12_plain_matches_pallas_banded_stacked_at_head_dims(hd):
    _k12_banded_stacked_case(2, hd)


def _k12_banded_stacked_case(layer, hd):
    Lc, B, KV, G, S = 3, 2, 2, 4, 256
    q, kn, vn, cache = _inputs(7, B, KV, G, hd, S, L=Lc)
    pos = np.array([40, S + 5], np.int32)
    o_j, *c_j = pallas_decode_attention_write_banded_stacked(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *map(jnp.asarray, cache),
        jnp.asarray(pos), layer, interpret=True)
    c_t = [cpu(a) for a in cache]
    out = k12.decode_attention_write_banded_stacked(cpu(q), cpu(kn), cpu(vn), *c_t, cpu(pos),
                                                    layer)
    _check_cache([c[layer] for c in c_t], [c[layer] for c in c_j], [c[layer] for c in cache],
                 kn, vn, pos)
    for got, orig in zip(c_t, cache):
        for m in range(Lc):
            if m != layer:
                np.testing.assert_array_equal(to_numpy(got[m]), orig[m])
    assert _rel_max(to_numpy(out), o_j) < OUT_TOL


@pytest.mark.parametrize("window", [0, 48])
def test_row9_plain_matches_pallas_decode_attention(window):
    """decode_attention_layer (pallas_decode_attention's function: s <= pos,
    the window, read-only) at GPT-2's MHA head width and at GQA."""
    for B, KV, G, hd, S in ((3, 4, 1, 64, 176), (2, 2, 4, 32, 256)):
        _row9_case(window, B, KV, G, hd, S)
    assert k12.decode_attention_layer.launches == 0


@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
@pytest.mark.parametrize("window", [0, 48])
def test_row9_plain_matches_pallas_decode_attention_at_head_dims(window, hd):
    """The same at MHA (OPT-2.7B's G 1 at hd 80) and at GQA."""
    for B, KV, G, S in ((3, 4, 1, 176), (2, 2, 4, 256)):
        _row9_case(window, B, KV, G, hd, S)


def _row9_case(window, B, KV, G, hd, S):
    q, _, _, cache = _inputs(3, B, KV, G, hd, S)
    pos = np.array([130, 17, S][:B], np.int32)
    o_j = pallas_decode_attention(jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos),
                                  window=window, interpret=True)
    c_t = [cpu(a) for a in cache]
    out = k12.decode_attention_layer(cpu(q), *c_t, cpu(pos), window=window)
    for got, orig in zip(c_t, cache):  # read-only
        np.testing.assert_array_equal(to_numpy(got), orig)
    assert _rel_max(to_numpy(out), o_j) < OUT_TOL


@pytest.mark.parametrize("hd", [32] + NEW_HEAD_DIMS)
@pytest.mark.parametrize("window", [0, 48])
def test_k3_plain_matches_pallas_decode_attention_stacked(window, hd):
    """K3's plain version (`decode_attention` on layer 1 of a stacked
    cache of 3, read-only) against pallas_decode_attention_stacked, one
    sequence at pos 130 and one inactive at pos S."""
    Lc, B, KV, G, S = 3, 2, 2, 4, 256
    q, _, _, cache = _inputs(5, B, KV, G, hd, S, L=Lc)
    pos = np.array([130, S], np.int32)
    o_j = pallas_decode_attention_stacked(jnp.asarray(q), *map(jnp.asarray, cache),
                                          jnp.asarray(pos), 1, window=window, interpret=True)
    c_t = [cpu(a) for a in cache]
    out = k12.decode_attention(cpu(q), *c_t, cpu(pos), 1, window=window)
    for got, orig in zip(c_t, cache):  # read-only
        np.testing.assert_array_equal(to_numpy(got), orig)
    assert _rel_max(to_numpy(out), o_j) < OUT_TOL
    assert k12.decode_attention.launches == 0


def test_per_layer_cache_layout_matches_qtpu():
    cj = jkv.init_cache(J_TINY, 3, 21, quantized=True, per_layer=True)
    ct = tkv.init_cache(TINY_TEST, 3, 21, quantized=True, device="cpu", per_layer=True)
    assert ct.per_layer and cj.per_layer
    assert ct.num_layers == cj.num_layers == TINY_TEST.num_layers
    assert ct.max_len == cj.max_len == 24
    for got, want in zip((ct.k, ct.v, ct.k_scale, ct.v_scale),
                         (cj.k, cj.v, cj.k_scale, cj.v_scale)):
        assert len(got) == len(want)
        assert all(tuple(a.shape) == b.shape for a, b in zip(got, want))
    k, v, ks, vs, li = ct.stacked(1)  # the kernels' view: no copy
    assert li == 0 and k.shape[0] == 1 and k.data_ptr() == ct.k[1].data_ptr()
    assert vs.data_ptr() == ct.v_scale[1].data_ptr()


def _decode_run(pt, qt, cache, ids, forced):
    """Prefill, then teacher-forced decode steps; the logits of each."""
    B, P = ids.shape
    logits, cache = prefill(pt, cpu(ids), cache, TINY_TEST, qt)
    outs = [logits.numpy()]
    pos = torch.full((B,), P, dtype=torch.int32)
    for tok in forced:
        logits, cache = decode_step(pt, cpu(tok), pos, cache, TINY_TEST, qt)
        outs.append(logits.numpy())
        pos = pos + 1
    return outs, cache


@pytest.mark.parametrize("S", [64, 2048])
def test_per_layer_cache_matches_stacked(both, S):
    """The port's counterpart of qtpu's test_per_layer_cache_matches_stacked
    (tests/test_serve.py:337): W4-packed TINY_TEST, prefill 16 + 4
    teacher-forced decode steps on both layouts. At S 64 the per-layer
    decode runs K11's plain version, the stacked one K2 + K3's: the same
    function, so the logits and caches are equal. At S 2048 the per-layer
    decode takes K12 (new token unquantized): logits within qtpu's 2e-2,
    and so are the caches after dequantization (later layers' rows move
    by a code or two)."""
    _, _, pt, qt = both
    B, P, N = 2, 16, 4
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_TEST.vocab_size, (B, P), dtype=np.int32)
    forced = rng.integers(0, TINY_TEST.vocab_size, (N, B), dtype=np.int32)
    runs = {}
    for per_layer in (False, True):
        cache = tkv.init_cache(TINY_TEST, B, S, quantized=True, device="cpu",
                               per_layer=per_layer)
        assert cache.per_layer == per_layer
        runs[per_layer] = _decode_run(pt, qt, cache, ids, forced)
    (stk, c_s), (per, c_p) = runs[False], runs[True]
    for a, b in zip(per, stk):
        if S % 2048:
            np.testing.assert_array_equal(a, b)
        else:
            assert _rel(a, b) < LOGIT_TOL
    for l in range(TINY_TEST.num_layers):
        kp, vp, ksp, vsp = c_p.layer(l)
        kq, vq, ksq, vsq = c_s.layer(l)
        if S % 2048:
            for got, want in zip((kp, vp, ksp, vsp), (kq, vq, ksq, vsq)):
                np.testing.assert_array_equal(got.numpy(), want.numpy())
            continue
        for a, sa, b, sb in ((kp, ksp, kq, ksq), (vp, vsp, vq, vsq)):
            assert _rel(tkv.dequantize_kv(a, sa, torch.float32),
                        tkv.dequantize_kv(b, sb, torch.float32)) < LOGIT_TOL
    np.testing.assert_array_equal(c_p.length.numpy(), c_s.length.numpy())


def test_batcher_per_layer_layout(both):
    """The port's counterpart of qtpu's test_batcher_per_layer_layout
    (tests/test_serve.py:369): 3 requests through 2 slots with
    kv_layout="per_layer" finish with 6 tokens each, the same tokens as the
    stacked layout (at this S both decode the same function)."""
    _, _, pt, qt = both
    prompts = [np.random.default_rng(i).integers(0, TINY_TEST.vocab_size, (8 + 3 * i,))
               for i in range(3)]
    outs = {}
    for layout in ("stacked", "per_layer"):
        eng = ContinuousBatcher(pt, TINY_TEST, qmeta=qt, max_batch=2, max_seq_len=128,
                                kv_dtype="int8", decode_block=4, kv_layout=layout, device="cpu")
        assert eng.cache.per_layer == (layout == "per_layer")
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run()
        assert len(done) == 3
        for r in reqs:
            assert r.done and len(r.output) == 6
            assert all(0 <= t < TINY_TEST.vocab_size for t in r.output)
        outs[layout] = [r.output for r in reqs]
    assert outs["per_layer"] == outs["stacked"]
    with pytest.raises(ValueError):
        ContinuousBatcher(pt, TINY_TEST, qmeta=qt, kv_layout="paged", device="cpu")


@pytest.mark.parametrize("window", [0, 8])
def test_per_layer_decode_matches_qtpu(both, window):
    """TINY_TEST W4 (and with a sliding window of 8), a prefill of 12 and 4
    teacher-forced decode steps on the per-layer int8 cache at S 2048,
    against qtpu's per-layer cache on the CPU. qtpu there takes its XLA
    path (llama.py:318: not on a TPU), which quantizes the new token and
    attends s <= pos; the port takes K12's plain version, which attends
    s < pos plus the unquantized new token: logits within the 2e-2 of
    tests/test_serve.py:366, caches within it after dequantization."""
    pj, qj, pt, qt = both
    cfg_j, cfg_t = J_TINY.replace(sliding_window=window), TINY_TEST.replace(sliding_window=window)
    B, P, N, S = 2, 12, 4, 2048
    ids = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (B, P), dtype=np.int32)
    positions = np.arange(P, dtype=np.int32)[None].repeat(B, 0)
    cj = jkv.init_cache(cfg_j, B, S, quantized=True, per_layer=True)
    ct = tkv.init_cache(cfg_t, B, S, quantized=True, device="cpu", per_layer=True)
    lj, cj = jllama.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(positions), cj, cfg_j,
                                       qj)
    lt, ct = tllama.forward_with_cache(pt, cpu(ids), cpu(positions), ct, cfg_t, qt)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = np.full((B,), P, np.int32)
    for _ in range(N):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        lj, cj = jllama.forward_with_cache(pj, jnp.asarray(tok)[:, None],
                                           jnp.asarray(pos)[:, None], cj, cfg_j, qj)
        lt, ct = tllama.forward_with_cache(pt, cpu(tok)[:, None], cpu(pos)[:, None], ct,
                                           cfg_t, qt)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1
    assert ct.per_layer and cj.per_layer
    for l in range(cfg_t.num_layers):
        for a, sa, b, sb in ((ct.k[l], ct.k_scale[l], cj.k[l], cj.k_scale[l]),
                             (ct.v[l], ct.v_scale[l], cj.v[l], cj.v_scale[l])):
            got = a.numpy().astype(np.float32) * sa.numpy()[..., None]
            want = np.asarray(b, np.float32) * np.asarray(sb)[..., None]
            assert _rel(got, want) < LOGIT_TOL
