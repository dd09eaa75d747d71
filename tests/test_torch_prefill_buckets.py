"""The serving engine's prefill buckets (qtpu_torch/serve/batching.py) on
the CPU, against qtpu's engine (qtpu/serve/batching.py) on the same packed
bytes: the bucketed admission arrays (P, Tb, starts, slots, first_cols) of
staggered, chunked workloads, warmup()'s bucket set, greedy tokens on both
cache dtypes and layouts, a decoding slot named as a pad row, and a bucket
that runs past the cache end. A CPU engine runs the same bucketed shapes
eagerly that a card engine replays from CUDA graphs (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qtpu.serve.batching as jb
import qtpu_torch.serve.batching as tb
from qtpu.models.config import TINY_TEST as J_TINY
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models import TINY_TEST, llama
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

CFG = TINY_TEST
# (prompt length, max_new_tokens, temperature, submitted before step k)
WORK = [(5, 6, 0.0, 0), (40, 4, 0.5, 0), (17, 9, 0.0, 0), (70, 3, 0.0, 2), (33, 5, 0.8, 2),
        (9, 7, 0.0, 2), (3, 4, 0.0, 5), (100, 2, 0.0, 9), (12, 3, 0.0, 14), (50, 2, 0.3, 14)]


@pytest.fixture(scope="module")
def packed():
    """RTN W4 g64 fused sites of the tiny llama, built so that greedy tokens
    do not hang on bf16 roundings: a large embedding (std 1) dominates the
    residual stream and the lm_head is the embedding of a permutation of the
    vocabulary, so the next token is perm(token) by a wide logit margin (the
    layers' K/V are the model's own: their cache contents are compared
    apart, `_cache_close`)."""
    params = llama.init_params(CFG, seed=0, device="cpu")
    params["embed"] = params["embed"] * 50
    perm = torch.from_numpy(np.random.default_rng(3).permutation(CFG.vocab_size))
    params["lm_head"]["w"] = params["embed"][perm].T.contiguous()
    tparams, qmeta = fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64}))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tparams))
    return tparams, jparams, qmeta


def _dequant(cache, k, scale):
    """K or V of every layer as f32 numpy [L, B, KV, S, hd] (int8 codes times
    their scales), from either package's cache."""
    parts = getattr(cache, k)
    parts = parts if cache.per_layer else [parts]
    scales = getattr(cache, scale)
    out = [np.asarray(p.float() if isinstance(p, torch.Tensor) else p, np.float32) for p in parts]
    if scales is not None:
        scales = scales if cache.per_layer else [scales]
        out = [o * np.asarray(s)[..., None] for o, s in zip(out, scales)]
    return np.concatenate(out)


def _cache_close(tcache, jcache):
    """Every position of both caches (written rows, pad positions and decode
    overshoot alike) within 3e-2: int8 codes may differ by up to 2 from
    qtpu's (bf16 summation order of k/v, about 1e-2 a code here), bf16
    values by an ulp (7.8e-3 below 2)."""
    for k, s in (("k", "k_scale"), ("v", "v_scale")):
        a, b = _dequant(tcache, k, s), _dequant(jcache, k, s)
        assert a.shape == b.shape and np.abs(b).max() > 0.5
        np.testing.assert_allclose(a, b, atol=3e-2, rtol=0)
    assert np.asarray(tcache.length).tolist() == np.asarray(jcache.length).tolist()


def _drive(mod, params, qmeta, work, **kw):
    """Run `work` on mod's engine; returns (outputs, the admission arrays of
    every prefill call, the engine). Requests are submitted before the step
    their entry names."""
    extra = {"device": "cpu"} if mod is tb else {}
    eng = mod.ContinuousBatcher(params, J_TINY if mod is jb else CFG, qmeta=qmeta, **kw, **extra)
    arrays, inner = [], eng._prefill_chunk_arrays

    def recorded():
        out = inner()
        arrays.append(tuple(np.asarray(a).tolist() for a in out))
        return out

    eng._prefill_chunk_arrays = recorded
    reqs, step = [], 0
    pending = sorted(work, key=lambda w: w[3])
    while pending or eng.queue or eng.prefilling or any(s is not None for s in eng.slots):
        while pending and pending[0][3] <= step:
            n, m, t, _ = pending.pop(0)
            prompt = np.random.default_rng(1000 + len(reqs)).integers(0, CFG.vocab_size, n)
            reqs.append(eng.submit(prompt, max_new_tokens=m, temperature=t))
        eng.step()
        step += 1
        assert step < 500
    assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
    return [r.output for r in reqs], arrays, eng


ENGINE = dict(max_batch=4, max_seq_len=120, decode_block=4, prefill_chunk=32,
              prefill_parallel=3)


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("kv_layout", ["stacked", "per_layer"])
def test_admissions_and_greedy_tokens_equal_qtpus(packed, kv_dtype, kv_layout):
    """A staggered, chunked workload (admissions of one row and of P =
    min(_bucket(n), prefill_parallel, max_batch) = 3 rows with pad rows, full
    chunks, bucketed final chunks) gives the same admission arrays
    (ids [P, Tb], starts, slots, tokens consumed, first_cols, ptemps) call for
    call on both engines, and the same greedy tokens."""
    tparams, jparams, qmeta = packed
    kw = dict(ENGINE, kv_dtype=kv_dtype, kv_layout=kv_layout)
    greedy = [(n, m, 0.0, k) for n, m, _, k in WORK]
    want, want_arr, jeng = _drive(jb, jparams, qmeta, greedy, **kw)
    got, got_arr, eng = _drive(tb, tparams, qmeta, greedy, **kw)
    assert got_arr == want_arr
    shapes = {(len(a[0]), len(a[0][0])) for a in got_arr}
    assert shapes == {(1, 16), (1, 32), (3, 16), (3, 32)}
    assert set(eng.prefill_shapes) == shapes and eng.prefill_calls == len(got_arr)
    assert any(s == eng.cache.max_len for a in got_arr for s in a[1])  # pad rows ran
    assert got == want
    _cache_close(eng.cache, jeng.cache)


def test_sampled_admission_arrays_equal_qtpus(packed):
    """With sampled requests (temperature > 0) the arrays still match: the
    schedule depends on the token counts, not on the tokens drawn."""
    tparams, jparams, qmeta = packed
    _, want, _ = _drive(jb, jparams, qmeta, WORK, kv_dtype="int8", **ENGINE)
    _, got, _ = _drive(tb, tparams, qmeta, WORK, kv_dtype="int8", **ENGINE)
    assert got == want
    assert any(t > 0 for a in got for t in a[5])


@pytest.mark.parametrize("kw", [
    dict(max_batch=8, max_seq_len=1024, prefill_chunk=256),
    dict(max_batch=8, max_seq_len=160, prefill_chunk=256),
    dict(max_batch=4, max_seq_len=96, prefill_chunk=40, prefill_parallel=2),
    dict(max_batch=32, max_seq_len=4096, prefill_chunk=512),
    dict(max_batch=2, max_seq_len=30, prefill_chunk=8, prefill_parallel=1),
    dict(max_batch=16, max_seq_len=32752, prefill_chunk=1024, prefill_parallel=16),
])
def test_warmup_buckets_equal_qtpus(monkeypatch, kw):
    """The (P, Tb) set warmup() captures equals the shapes qtpu's warmup()
    compiles its fused engine step at (its program calls recorded, not run)."""
    seen = set()

    def fused_step(params, cache, ids, *args):
        seen.add(tuple(ids.shape))
        return jnp.zeros((ids.shape[0],), jnp.int32), jnp.zeros((1, 1), jnp.int32), cache

    monkeypatch.setattr(jb, "_fused_step", fused_step)
    monkeypatch.setattr(jb, "decode_multi", lambda *a, **k: (jnp.zeros((1, 1), jnp.int32), a[3]))
    small = jb.init_cache(J_TINY, 1, 8)  # the program calls are not run: any cache will do
    monkeypatch.setattr(jb, "init_cache", lambda *a, **k: small)
    jb.ContinuousBatcher({}, J_TINY, **kw).warmup()
    monkeypatch.setattr(tb, "init_cache", lambda *a, **k: None)  # the set needs no cache
    eng = tb.ContinuousBatcher({}, CFG, device="cpu", **kw)
    assert sorted(seen) == eng.prefill_buckets
    assert eng.prefill_buckets


def test_a_decoding_slot_named_as_a_pad_row_keeps_its_kv(packed):
    """Two admissions while slot 0 decodes: P = 4 rows, two of them pad rows
    on slot 0 (decoding) and a free slot. Slot 0's K/V bytes before the
    step's decode block are unchanged, its length is lifted to S + Tb as
    qtpu's max() lifts it, and both engines hold equal lengths after every
    step."""
    tparams, jparams, qmeta = packed
    kw = dict(max_batch=4, max_seq_len=96, decode_block=4, prefill_chunk=32, kv_dtype="int8")
    engines = {}
    for mod, params in ((tb, tparams), (jb, jparams)):
        extra = {"device": "cpu"} if mod is tb else {}
        eng = mod.ContinuousBatcher(params, J_TINY if mod is jb else CFG, qmeta=qmeta, **kw,
                                    **extra)
        eng.submit(np.arange(11) % CFG.vocab_size, max_new_tokens=40)
        eng.step()  # slot 0's prefill
        eng.step()  # a decode block
        engines[mod] = eng
    eng, jeng = engines[tb], engines[jb]
    pos = len(eng.slots[0].prompt) + len(eng.slots[0].output) - 1
    rows = [t[:, 0, :, :pos].clone() for t in (eng.cache.k, eng.cache.v, eng.cache.k_scale,
                                                eng.cache.v_scale)]
    for e in (eng, jeng):
        e.submit(np.arange(20) % CFG.vocab_size, max_new_tokens=3)
        e.submit(np.arange(7) % CFG.vocab_size, max_new_tokens=3)
    arrays = eng._prefill_chunk_arrays
    seen = []
    eng._prefill_chunk_arrays = lambda: seen.append(arrays()) or seen[-1]
    eng.step()
    jeng.step()
    ids, starts, slots, ns, _, _ = seen[0]
    S = eng.cache.max_len
    assert ids.shape == (4, 32) and slots.tolist() == [1, 2, 0, 3] and ns == [20, 7]
    assert starts.tolist() == [0, 0, S, S]
    after = [t[:, 0, :, :pos] for t in (eng.cache.k, eng.cache.v, eng.cache.k_scale,
                                        eng.cache.v_scale)]
    assert all(torch.equal(a, b) for a, b in zip(rows, after))
    assert int(eng.cache.length[0]) == int(eng.cache.length[3]) == S + 32
    assert eng.cache.length.tolist() == np.asarray(jeng.cache.length).tolist()
    while any(s is not None for s in eng.slots):
        eng.step()
        jeng.step()
        assert eng.cache.length.tolist() == np.asarray(jeng.cache.length).tolist()


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
def test_a_bucket_past_the_cache_end_runs_as_qtpus(packed, kv_dtype):
    """A final chunk whose bucket runs past the cache end (prompt 97, chunk
    64: a 64-token bucket at start 64 on S 104) is written at S - 64, as
    qtpu's dynamic_update_slice clamps its start, which overwrites the
    first chunk's positions 40-63: the port writes qtpu's cache and gives
    qtpu's tokens all the same (a fault of qtpu's the port keeps, ROADMAP
    section 3)."""
    tparams, jparams, qmeta = packed
    kw = dict(max_batch=2, max_seq_len=100, decode_block=4, prefill_chunk=64, kv_dtype=kv_dtype)
    work = [(97, 3, 0.0, 0)]
    want, want_arr, jeng = _drive(jb, jparams, qmeta, work, **kw)
    got, got_arr, eng = _drive(tb, tparams, qmeta, work, **kw)
    assert eng.cache.max_len == 104
    assert [(len(a[0][0]), a[1][0]) for a in got_arr] == [(64, 0), (64, 64)]
    assert got_arr == want_arr and got == want
    _cache_close(eng.cache, jeng.cache)


def test_a_bucket_wider_than_the_cache_raises_as_qtpus(packed):
    """A 33-token prompt on an engine of max_seq_len 40 (S 48) makes a
    64-token bucket, wider than the cache: qtpu's cache update refuses it
    when the program is traced, and the port raises before it runs."""
    tparams, jparams, qmeta = packed
    kw = dict(max_batch=2, max_seq_len=40, decode_block=1, kv_dtype="int8")
    with pytest.raises(TypeError, match="update"):
        _drive(jb, jparams, qmeta, [(33, 2, 0.0, 0)], **kw)
    with pytest.raises(ValueError, match="wider than the cache"):
        _drive(tb, tparams, qmeta, [(33, 2, 0.0, 0)], **kw)
