"""The port's serving stack on the CPU: the KV cache against qtpu's, the
continuous batcher against the port's own greedy_generate, sampling, and
the demo CLI."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.models.config import TINY_TEST as J_TINY
from qtpu.serve import kvcache as jkv
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.models import TINY_TEST, llama
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.__main__ import main as serve_main
from qtpu_torch.serve.batching import ContinuousBatcher
from qtpu_torch.serve.decode import greedy_generate, mixed_sample, sample_token


def cpu(a):
    """numpy -> a tensor on the CPU (the port's entry points default to cuda)."""
    return to_torch(a, device="cpu")


CFG = TINY_TEST


@pytest.fixture(scope="module")
def packed():
    params = llama.init_params(CFG, seed=0, device="cpu")
    return fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64}))


def test_init_cache_layout_matches_qtpu():
    for quant in (False, True):
        cj = jkv.init_cache(J_TINY, 3, 21, quantized=quant)
        ct = tkv.init_cache(CFG, 3, 21, quantized=quant, device="cpu")
        assert ct.max_len == cj.max_len == 24  # rounded up to a multiple of 8
        assert tuple(ct.k.shape) == cj.k.shape
        assert str(ct.k.dtype).split(".")[-1] == str(cj.k.dtype)
        if quant:
            assert tuple(ct.k_scale.shape) == cj.k_scale.shape


@pytest.mark.parametrize("quant", [False, True])
def test_cache_layer_write_prefill_matches_qtpu(quant):
    """T > 1: active rows write their chunk (a start past S - T is moved
    back as qtpu's dynamic_update_slice moves it); rows with start >= S
    write nothing."""
    L, B, KV, S, hd, T, l = 2, 4, 2, 16, 64, 5, 1
    rng = np.random.default_rng(0)
    kn = rng.standard_normal((B, T, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16)
    vn = rng.standard_normal((B, T, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16)
    start = np.array([0, 7, S - 2, S], np.int32)
    cj = jkv.init_cache(J_TINY.replace(num_layers=L), B, S, quantized=quant)
    ct = tkv.init_cache(CFG.replace(num_layers=L), B, S, quantized=quant, device="cpu")
    want = jkv.cache_layer_write(cj.layer(l), jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(start), quant)
    tkv.cache_layer_write(ct, l, cpu(kn), cpu(vn), cpu(start))
    for got, w in zip(ct.layer(l), want):
        if w is None:
            assert got is None
            continue
        g, w = to_numpy(got), np.asarray(w)
        if g.dtype == ml_dtypes.bfloat16:
            g, w = g.view(np.uint16), w.view(np.uint16)
        np.testing.assert_array_equal(g, w)
    assert not to_numpy(ct.k[0]).astype(np.float32).any()  # other layers untouched


def test_cache_layer_write_decode_matches_qtpu():
    """T = 1: rows with start outside [0, S) write nothing."""
    L, B, KV, S, hd, l = 2, 4, 2, 16, 64, 0
    rng = np.random.default_rng(1)
    kn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16)
    vn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16)
    start = np.array([-1, 3, S - 1, S], np.int32)
    cj = jkv.init_cache(J_TINY.replace(num_layers=L), B, S, quantized=True)
    ct = tkv.init_cache(CFG.replace(num_layers=L), B, S, quantized=True, device="cpu")
    want = jkv.cache_layer_write(cj.layer(l), jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(start), True)
    tkv.cache_layer_write(ct, l, cpu(kn), cpu(vn), cpu(start))
    for got, w in zip(ct.layer(l), want):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(w))


@pytest.mark.parametrize("quant", [False, True])
def test_cache_layer_write_into_slots(quant, monkeypatch):
    """Writing a batch of 2 into cache rows [2, 0] equals writing the full
    batch with the other rows inactive; the mask is never read on the host."""
    L, B, KV, S, hd, T, l = 2, 4, 2, 24, 64, 5, 1
    rng = np.random.default_rng(2)
    kn = cpu(rng.standard_normal((2, T, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16))
    vn = cpu(rng.standard_normal((2, T, KV, hd)).astype(np.float32).astype(ml_dtypes.bfloat16))
    full = [tkv.init_cache(CFG.replace(num_layers=L), B, S, quantized=quant, device="cpu")
            for _ in range(2)]
    monkeypatch.setattr(torch, "nonzero", None)  # any host read of the mask fails
    tkv.cache_layer_write(full[0], l, kn, vn, torch.tensor([3, 7], dtype=torch.int32),
                          slots=torch.tensor([2, 0]))
    pad = lambda t: torch.stack([t[1], torch.ones_like(t[0]), t[0], torch.ones_like(t[0])])
    tkv.cache_layer_write(full[1], l, pad(kn), pad(vn),
                          torch.tensor([7, S, 3, S], dtype=torch.int32))
    for a, b in zip(full[0].layer(l), full[1].layer(l)):
        if a is not None:
            assert a.abs().sum() > 0
            assert torch.equal(a, b)


def test_batcher_matches_greedy_generate(packed):
    params, qmeta = packed
    prompts = [np.random.default_rng(10 + i).integers(0, CFG.vocab_size, 6 + 3 * i)
               for i in range(3)]
    expected = []
    for p in prompts:
        cache = tkv.init_cache(CFG, 1, 128, quantized=True, device="cpu")
        toks, _ = greedy_generate(params, torch.as_tensor(p[None], dtype=torch.int32), cache,
                                  CFG, 5, qmeta)
        expected.append(toks[0].tolist())
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=2, max_seq_len=128,
                            kv_dtype="int8", device="cpu")
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    done = eng.run()
    assert len(done) == 3
    for req, exp in zip(reqs, expected):
        assert req.done and req.output == exp, (req.output, exp)
    m = eng.metrics()
    assert m["requests"] == 3 and m["total_tokens"] == 15 and m["decode_steps"] > 0


def test_batcher_staggered_and_chunked_admission(packed):
    """A request joining mid-flight, and prompts spanning several prefill
    chunks admitted in parallel, decode exactly as alone."""
    params, qmeta = packed
    lens = [5, 40, 17, 33]
    prompts = [np.random.default_rng(100 + i).integers(0, CFG.vocab_size, n)
               for i, n in enumerate(lens)]
    expected = []
    for p in prompts:
        cache = tkv.init_cache(CFG, 1, 128, quantized=True, device="cpu")
        toks, _ = greedy_generate(params, torch.as_tensor(p[None], dtype=torch.int32), cache,
                                  CFG, 4, qmeta)
        expected.append(toks[0].tolist())
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=4, max_seq_len=96,
                            kv_dtype="int8", prefill_chunk=16, prefill_parallel=2,
                            decode_block=4, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts[:3]]
    eng.step()
    eng.step()
    reqs.append(eng.submit(prompts[3], max_new_tokens=4))
    eng.run()
    for req, exp in zip(reqs, expected):
        assert req.done and req.output == exp, (req.output, exp)


def test_sampling_modes():
    logits = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 100)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    assert sample_token(logits, gen).tolist() == logits.argmax(-1).tolist()
    assert tuple(sample_token(logits, gen, temperature=1.0, top_k=10).shape) == (4,)
    top = sample_token(logits, gen, temperature=0.8, top_p=0.5)
    assert bool((top >= 0).all() and (top < 100).all())
    temps = torch.tensor([0.0, 1.0, 0.0, 0.5])
    mixed = mixed_sample(logits, temps, gen)
    assert mixed[0] == logits[0].argmax() and mixed[2] == logits[2].argmax()
    assert mixed_sample(logits, None).tolist() == logits.argmax(-1).tolist()


def test_serve_cli_on_cpu(capsys, monkeypatch):
    assert serve_main(["--device", "cpu", "--kv", "int8", "--requests", "2", "--tokens", "3",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "packed model with rtn W4 g64" in out and "2 requests, 6 tokens" in out
    # --http warms the engine and opens the front end (serve_forever stubbed
    # to return at once; the server and the engine thread are shut down)
    from qtpu_torch.serve.http import ThreadingHTTPServer

    served = []
    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever",
                        lambda self, *a, **k: served.append(self.server_address[1]))
    assert serve_main(["--device", "cpu", "--http", "0"]) == 0
    out = capsys.readouterr().out
    assert "engine warmup" in out and f"serving on http://127.0.0.1:{served[0]}" in out
    assert served[0] > 0
    packed, qmeta = pack_model(llama.init_params(CFG, device="cpu"), "apot", {"w_bit": 4})
    assert set(packed["layers"]["q_proj"]) == {"data", "scales", "codebook"}
    assert dict(qmeta)["lm_head"] == (4, 128, CFG.hidden_size, CFG.vocab_size)
    with pytest.raises(ValueError, match="w_bit=4 only"):  # codebooks are 4-bit
        pack_model(llama.init_params(CFG, device="cpu"), "pot", {"w_bit": 8})


def _engine_outputs(packed, warm, temps):
    """Outputs of a fresh int8-KV engine (seed 3) on three prompts at the
    given temperatures, warmed first or not; and the engine."""
    params, qmeta = packed
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=2, max_seq_len=96,
                            kv_dtype="int8", decode_block=4, seed=3, device="cpu")
    if warm:
        assert eng.warmup() > 0.0
    reqs = [eng.submit(np.random.default_rng(30 + i).integers(0, CFG.vocab_size, 6 + i),
                       max_new_tokens=9, temperature=t) for i, t in enumerate(temps)]
    eng.run()
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0), (0.0, 0.8, 0.0)])
def test_warmed_engine_answers_as_a_cold_one(packed, temps):
    """warmup() runs its prefill on a scratch cache and puts the generator's
    state back: greedy requests, and one at temperature 0.8 from the same
    seed, come out the same (as tests/test_serve.py holds qtpu's)."""
    cold, _ = _engine_outputs(packed, False, temps)
    warm, _ = _engine_outputs(packed, True, temps)
    assert warm == cold
    assert all(len(o) == 9 for o in cold)


@pytest.mark.parametrize("kv_layout", ["stacked", "per_layer"])
def test_warmup_leaves_the_cache_and_generator_as_they_were(packed, kv_layout):
    params, qmeta = packed
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=2, max_seq_len=64,
                            kv_dtype="int8", kv_layout=kv_layout, device="cpu")
    eng.submit(np.arange(7) % CFG.vocab_size, max_new_tokens=3)
    eng.step()  # a prefill: the live cache holds rows
    stores = lambda c: [t.clone() for f in (c.k, c.v, c.k_scale, c.v_scale, (c.length,))
                        for t in (f if isinstance(f, tuple) else (f,))]
    before, state = stores(eng.cache), eng.generator.get_state()
    assert any(bool(t.any()) for t in before)
    dt = eng.warmup(include_sampling=True)
    assert dt > 0.0 and not eng.graphs  # a CPU engine captures nothing
    assert all(torch.equal(a, b) for a, b in zip(before, stores(eng.cache)))
    assert torch.equal(state, eng.generator.get_state())


@pytest.mark.parametrize("chunk,want", [(1, 16), (8, 16), (16, 16), (40, 40), (256, 256)])
def test_prefill_chunk_is_clamped_as_qtpus(packed, chunk, want):
    """qtpu's engine takes prefill_chunk = max(16, prefill_chunk)."""
    from qtpu.serve import ContinuousBatcher as JBatcher

    params, qmeta = packed
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=2, max_seq_len=64,
                            prefill_chunk=chunk, device="cpu")
    jeng = JBatcher({}, J_TINY, max_batch=2, max_seq_len=64, prefill_chunk=chunk)
    assert eng.prefill_chunk == jeng.prefill_chunk == want


def test_drain_mode_blocks_match_qtpu(monkeypatch):
    """The sizes of the pure-decode blocks (decode_multi calls with nothing
    prefilling) of the port's engine equal qtpu's on one workload: 8 while a
    request waits, then 32 and 64 where every active slot has that many
    tokens left (qtpu/serve/batching.py, step())."""
    import jax

    import qtpu.serve.batching as jb
    import qtpu_torch.serve.batching as tb
    from qtpu.models import init_params as j_init

    work = [(5, 170), (7, 45), (6, 10)]  # (prompt length, max_new_tokens)

    def drive(mod, params, cfg, **kw):
        eng = mod.ContinuousBatcher(params, cfg, max_batch=2, max_seq_len=200, decode_block=8,
                                    prefill_chunk=16, **kw)
        blocks, inner = [], mod.decode_multi

        def recorded(*args, **kwargs):
            if not isinstance(args[1], jax.core.Tracer) and not eng.prefilling:
                blocks.append(args[7])
            return inner(*args, **kwargs)

        monkeypatch.setattr(mod, "decode_multi", recorded)
        reqs = [eng.submit(np.arange(n) % cfg.vocab_size, max_new_tokens=m) for n, m in work]
        eng.run()
        assert all(r.done and len(r.output) == m for r, (_, m) in zip(reqs, work))
        return blocks

    want = drive(jb, j_init(J_TINY, jax.random.PRNGKey(0)), J_TINY)
    got = drive(tb, llama.init_params(CFG, seed=0, device="cpu"), CFG, device="cpu")
    assert got == want
    assert {8, 32, 64} <= set(got), got
