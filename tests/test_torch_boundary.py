"""The port's layer-boundary decode path against qtpu on the CPU, on the same
numpy-made inputs:

  K13 layer_boundary_plain  vs qtpu pallas_layer_boundary_stacked
                            (interpret mode), within the bounds qtpu's own
                            test holds it to (tests/test_pallas_kernels.py:
                            y2 5e-3 and qkv 2e-2 absolute)
  K1 with norm_w / resid    vs qtpu pallas_quantized_matmul_stacked with
                            the same options (interpret mode), within that
                            test's `_assert_close` (relative Frobenius 2e-2,
                            absolute 5% of the largest output)

and qtpu's two decode branches end to end: a tiny Llama, RTN W4 fused, a
prefill and 4 greedy decode steps under QTPU_BOUNDARY=1 and under
QTPU_FUSE_NORM_RESID=1 on the stacked int8 and bf16 caches, against qtpu's
forward_with_cache on the CPU (which composes there: qtpu takes the branches
on a TPU only), logits within the model tests' 2e-2 and greedy tokens equal
to the port's composed path; and the calls that keep the composed path
under both switches.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.core.packing import quantize_pack as jax_quantize_pack
from qtpu.kernels.pallas_dequant_matmul import pallas_quantized_matmul_stacked
from qtpu.kernels.pallas_layer_boundary import pallas_layer_boundary_stacked
from qtpu.models import llama as jllama
from qtpu.serve.kvcache import init_cache as jax_init_cache
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.kernels import layer_boundary as k13
from qtpu_torch.models import llama as tllama
from qtpu_torch.models.config import TINY_TEST as T_TINY
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
from qtpu_torch.serve.kvcache import init_cache
from test_torch_model import CFG, LOGIT_TOL, _both, _np_params, _rel

BF16 = ml_dtypes.bfloat16
SWITCHES = ("QTPU_BOUNDARY", "QTPU_FUSE_NORM_RESID")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops: under parallel test
    workers, threads that spin waiting for each other slow them (the POT
    packing a hundredfold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


def _assert_close(out, ref):
    """tests/test_pallas_kernels.py's `_assert_close`."""
    o, r = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    rel = np.linalg.norm(o - r) / (np.linalg.norm(r) + 1e-6)
    assert rel < 2e-2, f"relative Frobenius error {rel}"
    np.testing.assert_allclose(o, r, atol=0.05 * (np.abs(r).max() + 1e-6))


def _bf16(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)


def _pack_layers(w, bits, group):
    """qtpu's quantize_pack on every layer of w [L, K, N]: numpy (data,
    scales, zeros) [L, ...]."""
    qts = [jax_quantize_pack(jnp.asarray(w[l]), bits, group) for l in range(w.shape[0])]
    return tuple(np.stack([np.asarray(getattr(q, f)) for q in qts])
                 for f in ("data", "scales", "zeros"))


# ------------------------------------------------------------------- K13
@pytest.mark.parametrize("bits,M", [(4, 8), (8, 8), (4, 1), (8, 3)])
def test_k13_plain_matches_pallas_boundary(bits, M):
    """qtpu's test shapes (L 3, D 256, F 512, Q 256, KV 128, g 128), layers
    l = 1 and l_next = 2; M = 1 and 3 pad to the TPU kernel's 8 rows."""
    L, D, F, Q, KV, g = 3, 256, 512, 256, 128, 128
    Nq = Q + 2 * KV
    rng = np.random.default_rng(bits * 10 + M)
    o = _pack_layers(_bf16(rng, L, Q, D).astype(np.float32), bits, g)
    gu = _pack_layers(_bf16(rng, L, D, 2 * F).astype(np.float32), bits, g)
    dn = _pack_layers(_bf16(rng, L, F, D).astype(np.float32), bits, g)
    qp = _pack_layers(_bf16(rng, L, D, Nq).astype(np.float32), bits, g)
    attn, x = _bf16(rng, M, Q), _bf16(rng, M, D)
    mn = (np.abs(_bf16(rng, L, D)).astype(np.float32) + 0.5).astype(BF16)
    an = (np.abs(_bf16(rng, L, D)).astype(np.float32) + 0.5).astype(BF16)
    metas = ((bits, g, Q, D), (bits, g, D, 2 * F), (bits, g, F, D), (bits, g, D, Nq))
    l, ln = 1, 2
    y2_j, qkv_j = pallas_layer_boundary_stacked(
        jnp.asarray(attn), jnp.asarray(x), jnp.asarray(mn), jnp.asarray(an),
        *(jnp.asarray(a) for site in (o, gu, dn, qp) for a in site),
        *metas, l, ln, eps=1e-5, interpret=True)

    def view(site, i):
        return {k: cpu(a[i]) for k, a in zip(("data", "scales", "zeros"), site)}

    n0 = k13.layer_boundary.launches
    y2, qkv = k13.layer_boundary(cpu(attn), cpu(x), cpu(mn[l]), cpu(an[ln]), view(o, l),
                                 view(gu, l), view(dn, l), view(qp, ln), metas)
    assert k13.layer_boundary.launches == n0  # the plain version: no launch
    assert y2.shape == (M, D) and qkv.shape == (M, Nq) and y2.dtype == torch.bfloat16
    assert np.abs(to_numpy(y2).astype(np.float32) - np.asarray(y2_j, np.float32)).max() < 5e-3
    assert np.abs(to_numpy(qkv).astype(np.float32) - np.asarray(qkv_j, np.float32)).max() < 2e-2


def _metas(bits=(4, 4, 4, 4), groups=(128,) * 4, Q=256, D=256, F=512, Nq=512):
    (b1, b2, b3, b4), (g1, g2, g3, g4) = bits, groups
    return ((b1, g1, Q, D), (b2, g2, D, 2 * F), (b3, g3, F, D), (b4, g4, D, Nq))


@pytest.mark.parametrize("case", ["mixed_bits", "mixed_groups", "no_chain", "w2", "symmetric"])
def test_k13_supported_refuses_what_qtpu_refuses(case):
    """Every packing pallas_layer_boundary_stacked raises NotImplementedError
    for (qtpu composes instead) is one that `supported` refuses."""
    L, D, Q = 1, 256, 256
    metas = {"mixed_bits": _metas(bits=(4, 8, 4, 4)),
             "mixed_groups": _metas(groups=(128, 64, 128, 128)),
             "no_chain": _metas()[:3] + ((4, 128, D + 128, 512),),
             "w2": _metas(bits=(2, 2, 2, 2)), "symmetric": _metas()}[case]
    sites = [{"data": np.zeros((L, m[2] * m[0] // 8, m[3]), np.int8),
              "scales": np.ones((L, m[2] // m[1], m[3]), BF16),
              "zeros": None if case == "symmetric" else np.zeros((L, m[2] // m[1], m[3]), np.uint8)}
             for m in metas]
    with pytest.raises(NotImplementedError):
        pallas_layer_boundary_stacked(
            jnp.zeros((8, Q), jnp.bfloat16), jnp.zeros((8, D), jnp.bfloat16),
            jnp.ones((L, D), jnp.bfloat16), jnp.ones((L, D), jnp.bfloat16),
            *(None if a is None else jnp.asarray(a) for s in sites
              for a in (s["data"], s["scales"], s["zeros"])),
            *metas, 0, 0, interpret=True)
    assert not k13.supported(metas, [{k: None if v is None else cpu(v[0]) for k, v in s.items()}
                                     for s in sites])
    ok = [{"data": 0, "scales": 0, "zeros": 0}] * 4
    assert k13.supported(_metas(), ok)


# ------------------------------------------------------------ K1 options
@pytest.mark.parametrize("option", ["norm_w", "resid", "both"])
def test_k1_options_plain_match_pallas_stacked(option):
    """tests/test_pallas_kernels.py:471-501's case: L 3, M 8, K 256, N 256,
    g 64, every layer, with the option(s) on the Pallas kernel and on K1."""
    L, M, K, N, g = 3, 8, 256, 256, 64
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((M, K))).astype(np.float32).astype(BF16)
    data = rng.integers(-128, 128, (L, K // 2, N), dtype=np.int8)
    scales = (rng.random((L, K // g, N)) * 0.01 + 1e-3).astype(np.float32).astype(BF16)
    zeros = rng.integers(0, 16, (L, K // g, N), dtype=np.uint8)
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32).astype(BF16)
    resid = rng.standard_normal((M, N)).astype(np.float32).astype(BF16)
    meta = (4, g, K, N)
    use_n, use_r = option in ("norm_w", "both"), option in ("resid", "both")
    for l in range(L):
        want = pallas_quantized_matmul_stacked(
            jnp.asarray(x), jnp.asarray(data), jnp.asarray(scales), jnp.asarray(zeros), meta,
            jnp.int32(l), norm_w=jnp.asarray(nw) if use_n else None,
            resid=jnp.asarray(resid) if use_r else None, eps=1e-5, interpret=True)
        got = k1.quantized_matmul(cpu(x), cpu(data[l]), cpu(scales[l]), cpu(zeros[l]), meta,
                                  norm_w=cpu(nw[l]) if use_n else None,
                                  resid=cpu(resid) if use_r else None, eps=1e-5)
        _assert_close(to_numpy(got), want)


# ------------------------------------------------------------ end to end
class _Spy:
    """Counts the port's K13 calls and its K1 calls with each option (on the
    CPU no kernel launches, so the launch counters stay at 0)."""

    def __init__(self, monkeypatch):
        self.boundary = self.norm_w = self.resid = 0
        lb, qmm = tllama.layer_boundary, tllama.quantized_matmul

        def boundary(*a, **kw):
            self.boundary += 1
            return lb(*a, **kw)

        def matmul(*a, norm_w=None, resid=None, **kw):
            self.norm_w += norm_w is not None
            self.resid += resid is not None
            return qmm(*a, norm_w=norm_w, resid=resid, **kw)

        monkeypatch.setattr(tllama, "layer_boundary", boundary)
        monkeypatch.setattr(tllama, "quantized_matmul", matmul)

    def counts(self):
        return {"boundary": self.boundary, "norm_w": self.norm_w, "resid": self.resid}


@pytest.fixture(scope="module")
def both():
    return _both(packed=True)


def _greedy(pt, qt, ids, positions, kv, steps):
    """The port's prefill and `steps` free-running greedy decode steps:
    tokens [B, steps + 1]."""
    B, S = ids.shape[0], 32
    ct = init_cache(T_TINY, B, S, quantized=kv == "int8", device="cpu")
    lt, ct = tllama.forward_with_cache(pt, cpu(ids), cpu(positions), ct, T_TINY, qt)
    toks, pos = [lt[:, -1].argmax(-1)], cpu(positions[:, -1] + 1)
    for _ in range(steps):
        lt, ct = tllama.forward_with_cache(pt, toks[-1].to(torch.int32)[:, None], pos[:, None],
                                           ct, T_TINY, qt)
        toks.append(lt[:, -1].argmax(-1))
        pos = pos + 1
    return torch.stack(toks, 1)


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("switch", SWITCHES)
def test_decode_branch_matches_qtpu(switch, kv, both, monkeypatch):
    """A prefill of 8 and 4 decode steps (B 2, sequences at offsets 0 and 2)
    under one switch, teacher-forced with qtpu's greedy tokens, against
    qtpu's composed forward_with_cache: logits within 2e-2, the same argmax
    wherever qtpu's top-1/top-2 margin is wider than 4x that tolerance (the
    rule of tests/test_torch_model.py: the composed path of the port flips a
    near tie of this model too), and the branch's calls per step (boundary:
    K1 with norm_w once, K13 once a layer; fuse: K1 with norm_w and with
    resid once a layer each, and so at the prefill, as in qtpu). Free-running,
    the branch picks the same greedy tokens as the port's composed path."""
    pj, qj, pt, qt = both
    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)
    B, T, steps, S = 2, 8, 4, 32
    quant = kv == "int8"
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, T), dtype=np.int32)
    positions = np.array([0, 2], np.int32)[:, None] + np.arange(T, dtype=np.int32)[None, :]
    composed = _greedy(pt, qt, ids, positions, kv, steps)
    monkeypatch.setenv(switch, "1")
    spy = _Spy(monkeypatch)
    cj = jax_init_cache(CFG, B, S, quantized=quant)
    ct = init_cache(T_TINY, B, S, quantized=quant, device="cpu")
    lj, cj = jllama.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(positions), cj, CFG, qj)
    lt, ct = tllama.forward_with_cache(pt, cpu(ids), cpu(positions), ct, T_TINY, qt)
    L = CFG.num_layers
    fuse = switch == "QTPU_FUSE_NORM_RESID"  # the fuse branch prefills too (K13 does not)
    assert spy.counts() == {"boundary": 0, "norm_w": L * fuse, "resid": L * fuse}
    pos = positions[:, -1] + 1
    checked = 0
    for i in range(steps + 1):
        lj_np = np.asarray(lj[:, -1])
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        top2 = np.sort(lj_np, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 4 * LOGIT_TOL * np.linalg.norm(lj_np, axis=-1) / np.sqrt(
            lj_np.shape[-1])
        tok = lj_np.argmax(-1)
        np.testing.assert_array_equal(lt[:, -1].argmax(-1).numpy()[sure], tok[sure])
        checked += int(sure.sum())
        if i == steps:
            break
        tok = tok.astype(np.int32)
        lj, cj = jllama.forward_with_cache(pj, jnp.asarray(tok)[:, None],
                                           jnp.asarray(pos)[:, None], cj, CFG, qj)
        lt, ct = tllama.forward_with_cache(pt, cpu(tok)[:, None], cpu(pos)[:, None], ct,
                                           T_TINY, qt)
        pos = pos + 1
    assert checked >= B * (steps + 1) // 2
    want = ({"boundary": L * steps, "norm_w": steps, "resid": 0} if switch == "QTPU_BOUNDARY"
            else {"boundary": 0, "norm_w": L * (steps + 1), "resid": L * (steps + 1)})
    assert spy.counts() == want
    assert torch.equal(_greedy(pt, qt, ids, positions, kv, steps), composed)


def _sites(method):
    """TINY_TEST's numpy weights packed by the port with `method`: rtn (the
    branches' packing), pot (codebook sites), smoothquant W8A8 ("a8" metas),
    gptq with actorder ("perm" sites, so q/k/v stay unfused)."""
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.convert import params_to_torch

    pt = params_to_torch(_np_params(CFG), device="cpu")
    mcfg = {"w_bit": 4, "q_group_size": 64}
    stats = None
    if method in ("smoothquant", "gptq"):
        blocks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 1, 32))
        stats = collect_calibration_stats(tllama.forward, pt, blocks, T_TINY,
                                          collect_hessian=method == "gptq")
    if method == "smoothquant":
        mcfg = {"w_bit": 8, "q_group_size": 64, "alpha": 0.5, "act_quant": True}
    if method == "gptq":
        mcfg = {**mcfg, "actorder": True}
    return fuse_packed_sites(*pack_model(pt, method, mcfg, stats))


@pytest.mark.parametrize("case", ["unset", "per_layer", "prefill", "slots", "b33",
                                  "pot", "w8a8", "gptq_perm"])
def test_composed_path_where_the_branches_do_not_apply(case, monkeypatch):
    """Calls the branches do not take: with both switches at "1" (and with
    "", "0" and "true" for `unset`) the step makes no K13 call and no K1 call
    with an option, and its logits equal the step with the switches unset
    bit for bit (`unset`: only "1" turns a switch on). per_layer: qtpu's
    unrolled long-context layout; pot, w8a8, gptq_perm: sites that are not
    plain packed. prefill and slots (not a decode step) and b33 (over the
    32 rows K13 takes) are calls K13 does not take and the fuse branch
    does, at any row count as qtpu's stacked delivery does: one K1 call
    with norm_w and one with resid a layer, on the CPU's plain versions bit
    for bit the composed ops."""
    method = {"pot": "pot", "w8a8": "smoothquant", "gptq_perm": "gptq"}.get(case, "rtn")
    pt, qt = _sites(method)
    B = 33 if case == "b33" else 2
    T = 8 if case == "prefill" else 1
    per_layer = case == "per_layer"
    S = 2048 if per_layer else 32
    rng = np.random.default_rng(4)
    ids = cpu(rng.integers(0, CFG.vocab_size, (B, T), dtype=np.int32))
    positions = cpu((np.arange(T, dtype=np.int32)[None, :] + 5).repeat(B, 0))
    slots = torch.arange(B, dtype=torch.int64) if case == "slots" else None

    def step():
        cache = init_cache(T_TINY, B, S, quantized=True, device="cpu", per_layer=per_layer)
        g = torch.Generator().manual_seed(0)
        for t in ((cache.k, cache.v) if not per_layer else (*cache.k, *cache.v)):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        for t in ((cache.k_scale, cache.v_scale) if not per_layer
                  else (*cache.k_scale, *cache.v_scale)):
            t.copy_(torch.rand(t.shape, generator=g) * 0.02 + 1e-3)
        return tllama.forward_with_cache(pt, ids, positions, cache, T_TINY, qt, slots=slots)[0]

    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)
    want = step()
    spy = _Spy(monkeypatch)
    for value in (("", "0", "true") if case == "unset" else ("1",)):
        for s in SWITCHES:
            monkeypatch.setenv(s, value)
        assert torch.equal(step(), want)
    fused = CFG.num_layers if case in ("prefill", "slots", "b33") else 0
    assert spy.counts() == {"boundary": 0, "norm_w": fused, "resid": fused}


@pytest.mark.parametrize("switch", SWITCHES)
def test_batcher_decode_steps_take_the_branch(switch, both, monkeypatch):
    """The serving engine: its decode steps (decode_multi, T = 1 without
    slots) take the branch; its prefills (with slots) compose under the
    boundary switch (K13 takes decode steps only) and take the fuse branch
    under the fuse switch, as qtpu's stacked delivery does at any T. Under
    the fuse switch the CPU runs the same arithmetic as the composed step,
    so the tokens equal the engine's without the switch."""
    from qtpu_torch.serve.batching import ContinuousBatcher

    _, _, pt, qt = both
    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)

    def serve():
        eng = ContinuousBatcher(pt, T_TINY, qmeta=qt, max_batch=2, max_seq_len=40,
                                kv_dtype="int8", decode_block=4, device="cpu")
        rng = np.random.default_rng(5)
        for n in (9, 12, 7):
            eng.submit(rng.integers(0, CFG.vocab_size, n, dtype=np.int32), max_new_tokens=6)
        done = eng.run()
        return [r.output for r in sorted(done, key=lambda r: r.uid)], eng.metrics()

    want, _ = serve()
    monkeypatch.setenv(switch, "1")
    spy = _Spy(monkeypatch)
    got, m = serve()
    L, steps = CFG.num_layers, m["decode_steps"]
    assert steps > 0 and m["prefill_calls"] > 0
    if switch == "QTPU_BOUNDARY":
        assert spy.counts() == {"boundary": L * steps, "norm_w": steps, "resid": 0}
        assert [len(o) for o in got] == [6, 6, 6]
    else:
        calls = L * (steps + m["prefill_calls"])
        assert spy.counts() == {"boundary": 0, "norm_w": calls, "resid": calls}
        assert got == want
