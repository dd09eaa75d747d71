"""The port's GPTQ against qtpu on the CPU, on the same numpy-made weights,
Hessians and calibration statistics: parity mode bit for bit, the
compensated sweep (true and proxy Hessians, low-rank prepare, actorder) to
a tolerance, the support matrix of the packed export, and at model level
quantize_model / pack_model (with and without actorder) / fold and fuse
and the logits of the fake-quant and packed models.

The compensated sweep is not bit for bit: torch.linalg's Cholesky and
triangular solve sum in another order than jnp.linalg's, U agrees to about
3e-5, and where a weight lands within that of a rounding tie its code
flips by one step and the compensation carries the other error along the
row. At the tiny-test model's 256-512-wide sites that moves 0.2-1% of the
codes (ROADMAP queue 3); the loss tr(ΔW H ΔWᵀ) stays within 0.1%.

At model level qtpu's compensated GPTQ runs under one jax.jit: run
eagerly, each of its primitives compiles on its own inside lax.map, which
takes about four times as long on these shapes. Parity mode, compared bit
for bit, stays eager.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.calib.stats import CalibStats
from qtpu.models.config import TINY_TEST
from qtpu.quant import apply as japply
from qtpu.quant import gptq as jgptq
from qtpu_torch.convert import params_to_numpy, to_numpy
from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import fused_mlp as _k4
from qtpu_torch.quant import apply as tapply
from qtpu_torch.quant import gptq
from test_torch_quant import (  # noqa: F401  (model and one_torch_thread are fixtures)
    BF16,
    _bits_equal,
    _jstats,
    _rel,
    _w_imp,
    cpu,
    logits_match,
    model,
    one_torch_thread,
    qtpu_once,
)

GPTQ_W_TOL = 1e-2  # layer level: relative Frobenius error of the dequantized weight
GPTQ_LOSS_TOL = 1e-2  # relative gap of the loss tr(ΔW H ΔWᵀ)
MODEL_FLIPS = 0.02  # model level: share of weights off qtpu's (one-code flips)
MODEL_W_TOL = 3e-2  # model level: relative Frobenius error, flips included


@pytest.mark.parametrize("n_bit", [2, 3, 4, 8])
def test_gptq_parity_mode_equals_qtpu_bit_for_bit(n_bit):
    w, _ = _w_imp(n_bit)
    w[:, 5] = 0.0  # a flat column: the 1e-5 clamp binds
    want = np.asarray(jgptq._parity_column_quantize(jnp.asarray(w), n_bit))
    got = gptq._parity_column_quantize(cpu(w), n_bit).numpy()
    np.testing.assert_array_equal(got, want)
    lay = gptq.gptq_quantize_layer(cpu(w.astype(BF16)), None, n_bit, error_compensation=False)
    _bits_equal(to_numpy(lay), jgptq.gptq_quantize_layer(jnp.asarray(w.astype(BF16)), None, n_bit,
                                                         error_compensation=False))


def _correlated(seed, C=128, O=64, T=512):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((C, 8))
    X = (rng.standard_normal((T, 8)) @ F.T + 0.1 * rng.standard_normal((T, C))).astype(np.float32)
    W = rng.standard_normal((O, C)).astype(np.float32)
    return W, (X.T @ X).astype(np.float32)


def _loss(w, wq, H):
    d = np.asarray(wq, np.float64) - np.asarray(w, np.float64)
    return float(np.trace(d @ np.asarray(H, np.float64) @ d.T))


@pytest.mark.parametrize("kind", ["true_h", "true_h_actorder", "proxy_lowrank",
                                  "proxy_lowrank_actorder", "proxy_dense"])
def test_gptq_compensated_layer_matches_qtpu(kind):
    # seed 12: at seed 11 with actorder one code lands on the other side of
    # a rounding tie and the compensation carries it on (1.4% relative,
    # loss +0.57%; ROADMAP queue 3)
    W, H = _correlated(12)
    C = W.shape[1]
    kw = dict(n_bit=4, q_group_size=64, blocksize=64, error_compensation=True,
              actorder=kind.endswith("actorder"))
    if kind.startswith("true_h"):
        jargs, targs, Hl = (jnp.asarray(H),), (cpu(H),), H
    else:
        S = 8 if "lowrank" in kind else C + 8
        v = np.abs(np.random.default_rng(3).standard_normal((S, C))).astype(np.float32)
        jargs, targs = (None,), (None,)
        kw_j, kw_t = dict(stat_vectors=jnp.asarray(v)), dict(stat_vectors=cpu(v))
        Hl = np.asarray(jgptq.build_proxy_hessian(jnp.asarray(v)))
    extra_j = {} if kind.startswith("true_h") else kw_j
    extra_t = {} if kind.startswith("true_h") else kw_t
    want = np.asarray(jgptq.gptq_quantize_layer(jnp.asarray(W), *jargs, **kw, **extra_j))
    got = gptq.gptq_quantize_layer(cpu(W), *targs, **kw, **extra_t).numpy()
    assert _rel(got, want) < GPTQ_W_TOL
    lt, lj = _loss(W, got, Hl), _loss(W, want, Hl)
    assert abs(lt / lj - 1) < GPTQ_LOSS_TOL, (lt, lj)


def test_gptq_return_ints_reconstruct():
    W, H = _correlated(13)
    Wq, q, s, z = gptq.gptq_quantize_layer(cpu(W), cpu(H), 4, q_group_size=64, blocksize=64,
                                           return_ints=True)
    deq = (q - z.repeat_interleave(64, dim=-1)) * s.repeat_interleave(64, dim=-1)
    torch.testing.assert_close(deq, Wq, rtol=0, atol=0)
    assert float(q.min()) >= 0 and float(q.max()) <= 15


def test_gptq_lowrank_prepare_matches_dense():
    """qtpu's own check, on the port: the O(C·S²) factor equals the dense
    one, batched over a leading (layer) axis, and UᵀU is H⁻¹."""
    v = np.abs(np.random.default_rng(4).standard_normal((2, 12, 192))).astype(np.float32)
    U_dense = gptq.gptq_prepare_factor(gptq.build_proxy_hessian(cpu(v), 0.01), 0.01)
    U_low = gptq.gptq_prepare_factor_lowrank(cpu(v), 0.01)
    torch.testing.assert_close(U_low, U_dense, rtol=2e-3, atol=2e-4)
    want = np.asarray(jgptq.gptq_prepare_factor_lowrank(jnp.asarray(v[1]), 0.01))
    np.testing.assert_allclose(U_low[1].numpy(), want, rtol=2e-3, atol=2e-4)
    H = gptq.build_proxy_hessian(cpu(v[0]), 0.01).double().numpy()
    Heff = H + (0.01 * np.mean(np.diag(H)) + 1e-8) * np.eye(H.shape[0])
    Ul = U_low[0].double().numpy()
    np.testing.assert_allclose(Ul.T @ Ul, np.linalg.inv(Heff), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(gptq.proxy_hessian_diag(cpu(v[0])).numpy(),
                               np.asarray(jgptq.proxy_hessian_diag(jnp.asarray(v[0]))), rtol=1e-6)


@pytest.mark.parametrize("diag", [(1.0, 3.0, 2.0, 0.5), (1.0, -3.0, 2.0, 0.5)])
def test_gptq_prepare_factor_last_resort_like_qtpu(diag):
    """A PSD H factors; an indefinite one fails both dampings and leaves
    the identity in both packages."""
    H = np.diag(np.array(diag, np.float32))
    H[0, 1] = H[1, 0] = 0.25
    want = np.asarray(jgptq.gptq_prepare_factor(jnp.asarray(H), 0.01))
    got = gptq.gptq_prepare_factor(cpu(H), 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got, np.eye(4, dtype=np.float32)) == (min(diag) < 0)


@pytest.mark.parametrize("args", [
    (3, 64, 128, False, 1, 256), (4, 0, 128, False, 1, 256), (4, 96, 128, False, 1, 256),
    (4, 64, 128, False, 1, 256, False), (4, 64, 128, True, 0, 256), (4, 64, 128, True, 3, 256),
    (8, 64, 32, True, 2, 256),
])
def test_check_packed_export_equals_qtpu(args):
    try:
        want = jgptq.check_packed_export(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            gptq.check_packed_export(*args)
        assert str(got.value) == str(e)
    else:
        assert gptq.check_packed_export(*args) == want == 64




# ------------------------------------------------------------ model level
FAKE_CASES = {
    "parity": {"w_bit": 4, "q_group_size": 64},
    "true_h": {"w_bit": 4, "q_group_size": 64, "error_compensation": True},
    "actorder": {"w_bit": 4, "q_group_size": 64, "error_compensation": True, "actorder": True},
}
PACK_CASES = {  # the second: W8, the proxy Hessian (low-rank prepare, as the serve CLI
    # runs it) and shard-local actorder perms
    "w4": {"w_bit": 4, "q_group_size": 64},
    "w8_proxy_actorder": {"w_bit": 8, "q_group_size": 64, "nsamples": 2, "actorder": True,
                          "actorder_shards": 2},
}
SITE_INPUT = {"q_proj": "attn_in", "k_proj": "attn_in", "v_proj": "attn_in", "o_proj": "o_in",
              "gate_proj": "mlp_in", "up_proj": "mlp_in", "down_proj": "down_in",
              "lm_head": "head_in"}


def _true_h(case):
    return "proxy" not in case and case != "parity"


def _qtpu_jit(fn, pj, js, hessian):
    """fn(params, CalibStats) under one jax.jit; a pack_model's metas (Python
    tuples, fixed at trace time) are returned beside the params."""
    metas = {}

    def run(pj, mean_abs, max_abs, h):
        out = fn(pj, CalibStats(mean_abs=mean_abs, max_abs=max_abs, hessian=h,
                                n_batches=js.n_batches))
        if isinstance(out, tuple):
            metas["m"] = out[1]
            return out[0]
        return out

    st = _jstats(js, hessian)
    out = jax.jit(run)(pj, st.mean_abs, st.max_abs, st.hessian)
    return (out, metas["m"]) if metas else out


def _fake_both(case, model):
    p, pj, pt, js, ts, ts_nh = model
    mcfg = FAKE_CASES[case]
    h = _true_h(case)
    if case == "parity":
        run = lambda: japply.quantize_model(pj, "gptq", mcfg, _jstats(js, h))
    else:
        run = lambda: _qtpu_jit(lambda a, st: japply.quantize_model(a, "gptq", mcfg, st),
                                pj, js, h)
    want = qtpu_once(("gptq-fake", case), run)
    return want, tapply.quantize_model(pt, "gptq", mcfg, ts if h else ts_nh)


def _pack_both(case, model):
    p, pj, pt, js, ts, ts_nh = model
    mcfg = PACK_CASES[case]
    h = _true_h(case)
    want = qtpu_once(("gptq-pack", case), lambda: _qtpu_jit(
        lambda a, st: japply.pack_model(a, "gptq", mcfg, st), pj, js, h))
    return want, tapply.pack_model(pt, "gptq", mcfg, ts if h else ts_nh)


def _hessian(js, site, l, case, perm=None):
    """The [K, K] Hessian the sweep used (true, or the proxy from the
    first `nsamples` stat vectors), in the column order of the weight."""
    in_site = SITE_INPUT[site]
    if _true_h(case):
        H = js.hessian[in_site] if l is None else js.hessian[in_site][l]
    else:
        v = js.mean_abs[in_site][:2]
        v = v if l is None else v[:, l]
        H = np.asarray(jgptq.build_proxy_hessian(jnp.asarray(v), 0.01))
    H = np.asarray(H, np.float64)
    return H if perm is None else H[perm][:, perm]


def _close_to_qtpu(got, want, w0, H):
    """One layer's dequantized [K, N] weights against qtpu's: few flips,
    the Frobenius gap, and the loss tr(ΔWᵀ H ΔW) within 1%."""
    got, want, w0 = (np.asarray(a, np.float64) for a in (got, want, w0))
    assert (np.abs(got - want) <= 1e-6 * np.abs(want).max()).mean() >= 1 - MODEL_FLIPS
    assert _rel(got, want) < MODEL_W_TOL

    def loss(wq):
        d = wq - w0
        return float(np.trace(d.T @ H @ d))

    assert abs(loss(got) / loss(want) - 1) < GPTQ_LOSS_TOL


def _layers(tree):
    sites = {k: v for k, v in tree["layers"].items() if isinstance(v, dict)}
    sites["lm_head"] = tree["lm_head"]
    return sites


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_quantize_model_gptq_matches_qtpu(case, model):
    p, pj, pt, js, *_ = model
    want, got = _fake_both(case, model)
    want, got = _layers(want), _layers(params_to_numpy(got))
    assert set(got) == set(want)
    for site, w in want.items():
        g, w = np.asarray(got[site]["w"]), np.asarray(w["w"])
        assert g.dtype == w.dtype and g.shape == w.shape, site
        if case == "parity":
            _bits_equal(g, w)
            continue
        w0 = np.asarray(_layers(p)[site]["w"], np.float32)
        if site == "lm_head":
            _close_to_qtpu(g, w, w0, _hessian(js, site, None, case))
        else:
            for l in range(TINY_TEST.num_layers):
                _close_to_qtpu(g[l], w[l], w0[l], _hessian(js, site, l, case))


def _dequant(site, meta, l=None):
    leaf = (lambda k: site[k]) if l is None else (lambda k: site[k][l])
    return dequantize_parts(cpu(leaf("data")), cpu(leaf("scales")), cpu(leaf("zeros")),
                            meta[0], meta[1], torch.float32).numpy()


def compare_packed_gptq(case, want, got, p, js):
    """The same metas, keys, dtypes and shapes, equal actorder perms, and
    the dequantized codes close to qtpu's (above)."""
    (pj, qj), (pt, qt) = want, got
    assert qt == qj
    meta = dict(qj)
    want, got = _layers(pj), _layers(params_to_numpy(pt))
    assert set(got) == set(want)
    for name, s in want.items():
        t = got[name]
        assert set(t) == set(s), name
        for k in s:
            assert np.asarray(t[k]).dtype == np.asarray(s[k]).dtype, (name, k)
            assert np.asarray(t[k]).shape == np.asarray(s[k]).shape, (name, k)
        if "perm" in s:
            np.testing.assert_array_equal(t["perm"], np.asarray(s["perm"]))
        if name not in SITE_INPUT:  # fused: compared through the logits
            continue
        w0 = np.asarray(_layers(p)[name]["w"], np.float32)
        for l in ([None] if name == "lm_head" else range(TINY_TEST.num_layers)):
            perm = None if "perm" not in s else np.asarray(s["perm"] if l is None else s["perm"][l])
            w0l = w0 if l is None else w0[l]
            w0l = w0l if perm is None else w0l[perm]
            _close_to_qtpu(_dequant(t, meta[name], l), _dequant(s, meta[name], l), w0l,
                           _hessian(js, name, l, case, perm))


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_model_gptq_matches_qtpu(case, model):
    p, pj, pt, js, *_ = model
    compare_packed_gptq(case, *_pack_both(case, model), p, js)
    if case == "w8_proxy_actorder":  # shard-local perms: no gather crosses K/2
        perm = _pack_both(case, model)[1][0]["layers"]["q_proj"]["perm"]
        half = perm.shape[-1] // 2
        assert perm.dtype == torch.int32
        assert bool((perm[:, :half] < half).all() and (perm[:, half:] >= half).all())


def test_fold_and_fuse_gptq_actorder_match_qtpu(model):
    """q/k/v share one input, so their actorder perms are equal and the
    sites fuse, keeping one perm; gate/up likewise."""
    p, pj, pt, js, *_ = model
    want, got = _pack_both("w8_proxy_actorder", model)
    want = japply.fuse_packed_sites(*japply.fold_smooth(*want))
    got = tapply.fuse_packed_sites(*tapply.fold_smooth(*got))
    compare_packed_gptq("w8_proxy_actorder", want, got, p, js)
    layers, qd = got[0]["layers"], dict(got[1])
    assert {"qkv_proj", "gateup_proj"} <= set(layers)
    assert "perm" in layers["qkv_proj"]
    # actorder sites run the composed MLP, not K4 (qtpu's guard)
    assert not _k4.supported(qd["gateup_proj"], qd["down_proj"], layers["gateup_proj"],
                             layers["down_proj"])


@pytest.mark.parametrize("fake,packed", [("true_h", "w4"), ("actorder", "w8_proxy_actorder")])
def test_gptq_fake_and_packed_logits_match_qtpu(fake, packed, model):
    logits_match(_fake_both(fake, model), _pack_both(packed, model))
