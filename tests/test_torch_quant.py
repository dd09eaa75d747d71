"""The port's calibrated quantizers against qtpu on the CPU, on the same
numpy-made weights, token ids and calibration statistics (qtpu's stats
moved to the port with `convert.stats_to_torch`): the capture forward and
calibration statistics, AWQ, SmoothQuant, GPTQ (parity and compensated),
pack_model / fold_smooth / fuse_packed_sites for those methods, and the
slice end to end (fake-quant and packed logits, SmoothQuant W8A8 serving
with the int8 KV cache, the serve CLI and the benchmark runner).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.calib.stats import collect_calibration_stats as jax_collect
from qtpu.models import llama as jllama
from qtpu.models.config import TINY_TEST
from qtpu.quant import apply as japply
from qtpu.quant import awq as jawq
from qtpu.quant import smoothquant as jsq
from qtpu.serve import decode as jdecode
from qtpu.serve import kvcache as jkv
from qtpu_torch.bench.__main__ import main as bench_main
from qtpu_torch.calib import collect_calibration_stats
from qtpu_torch.convert import params_to_numpy, params_to_torch, stats_to_torch, to_numpy, to_torch
from qtpu_torch.kernels import fused_mlp as _k4
from qtpu_torch.models import config as tconfig
from qtpu_torch.models import llama as tllama
from qtpu_torch.quant import apply as tapply
from qtpu_torch.quant import awq, smoothquant
from qtpu_torch.serve import decode as tdecode
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.__main__ import main as serve_main

BF16 = ml_dtypes.bfloat16
T_CFG = tconfig.TINY_TEST
STAT_TOL = 2e-2  # capture statistics: bf16 layers summed in another order
LOGIT_TOL = 3e-2  # relative Frobenius error of the f32 logits


def cpu(a):
    return to_torch(a, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def _np(t):
    return np.asarray(to_numpy(t) if isinstance(t, torch.Tensor) else t).astype(np.float32)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == BF16:
        got, want = got.view(np.uint16), want.view(np.uint16)
    np.testing.assert_array_equal(got, want)


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    Q, KV = cfg.q_dim, cfg.kv_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32).astype(BF16)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32).astype(BF16)

    return {
        "embed": w(V, D),
        "layers": {
            "attn_norm": norm(L, D), "mlp_norm": norm(L, D),
            "q_proj": {"w": w(L, D, Q)}, "k_proj": {"w": w(L, D, KV)},
            "v_proj": {"w": w(L, D, KV)}, "o_proj": {"w": w(L, Q, D)},
            "gate_proj": {"w": w(L, D, F)}, "up_proj": {"w": w(L, D, F)},
            "down_proj": {"w": w(L, F, D)},
        },
        "final_norm": norm(D),
        "lm_head": {"w": w(D, V)},
    }


def _batches(n=4, S=160, seed=5):
    """Calibration ids: 640 tokens, more than the widest site's 512
    channels, so the true Hessians have full rank as in real use."""
    return [np.random.default_rng(seed + i).integers(0, 512, (1, S), dtype=np.int32)
            for i in range(n)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops: under parallel test
    workers, threads that spin waiting for each other slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(numpy params, qtpu params, port params, qtpu stats with true
    Hessians, the same stats on the port, the port's stats without)."""
    p = _np_params(TINY_TEST)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    js = jax_collect(jllama.forward, pj, _batches(), TINY_TEST, collect_hessian=True)
    js = SimpleNamespace(**{f: {k: np.asarray(v) for k, v in getattr(js, f).items()}
                            for f in ("mean_abs", "max_abs", "hessian")}, n_batches=js.n_batches)
    ts = stats_to_torch(js, device="cpu")
    ts_nh = stats_to_torch(js, device="cpu")
    ts_nh.hessian = None
    return p, pj, params_to_torch(p, device="cpu"), js, ts, ts_nh


def _jstats(js, hessian=True):
    """qtpu's CalibStats from the numpy fields (optionally without H)."""
    from qtpu.calib.stats import CalibStats

    conv = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return CalibStats(mean_abs=conv(js.mean_abs), max_abs=conv(js.max_abs),
                      hessian=conv(js.hessian) if hessian else None, n_batches=js.n_batches)


# --------------------------------------------------------------- capture
@pytest.mark.parametrize("capture", ["stats", "hessian"])
def test_capture_forward_matches_qtpu(capture, model):
    p, pj, pt, *_ = model
    ids = _batches(1, S=40, seed=9)[0]
    lj, sj = jllama.forward(pj, jnp.asarray(ids), TINY_TEST, capture=capture)
    lt, st = tllama.forward(pt, cpu(ids), T_CFG, capture=capture)
    assert _rel(lt.numpy(), lj) < STAT_TOL
    assert set(st) == set(sj) == set(tllama.INPUT_SITES)
    for site in st:
        assert set(st[site]) == set(sj[site])
        for key, want in sj[site].items():
            got = st[site][key]
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, (site, key)
            assert _rel(got.numpy(), want) < STAT_TOL, (site, key)


def test_collect_calibration_stats_matches_qtpu(model):
    p, pj, pt, js, *_ = model
    got = collect_calibration_stats(tllama.forward, pt, _batches(), T_CFG, collect_hessian=True)
    assert got.n_batches == js.n_batches == 4
    for field in ("mean_abs", "max_abs", "hessian"):
        mine, want = getattr(got, field), getattr(js, field)
        assert set(mine) == set(want)
        for site in want:
            assert tuple(mine[site].shape) == want[site].shape
            assert _rel(mine[site].numpy(), want[site]) < STAT_TOL, (field, site)
    assert got.for_linear_site("gate_proj") == "mlp_in"
    nh = collect_calibration_stats(tllama.forward, pt, _batches(1), T_CFG)
    assert nh.hessian is None and tuple(nh.mean_abs["down_in"].shape) == (1, 2, 512)


def test_forward_refuses_unknown_capture():
    p = tllama.init_params(T_CFG, device="cpu")
    with pytest.raises(ValueError, match="capture"):
        tllama.forward(p, torch.zeros((1, 4), dtype=torch.int64), T_CFG, capture="grads")


# ------------------------------------------------------------------- AWQ
def _w_imp(seed, out=96, inp=256):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out, inp)) * 0.05).astype(np.float32)
    imp = np.abs(rng.standard_normal(inp)).astype(np.float32) ** 2
    return w, imp


@pytest.mark.parametrize("n_bit,group,protect,sf", [
    (4, 64, 0.01, 2.0), (3, 128, 0.05, 1.5), (8, -1, 0.02, 1.0), (4, 32, 0.1, 1.7),
])
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_awq_quantize_equals_qtpu_bit_for_bit(n_bit, group, protect, sf, dtype):
    w, imp = _w_imp(n_bit * 10 + max(group, 0))
    w = w.astype(dtype)
    want = jawq.awq_quantize(jnp.asarray(w), jnp.asarray(imp), n_bit, group, protect, sf)
    got = awq.awq_quantize(cpu(w), cpu(imp), n_bit, group, protect, sf)
    _bits_equal(to_numpy(got), want)
    _bits_equal(awq._protection_scale_vec(cpu(imp), protect, sf).numpy(),
                jawq._protection_scale_vec(jnp.asarray(imp), protect, sf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_awq_search_picks_qtpu_factor(seed):
    w, imp = _w_imp(100 + seed, out=64, inp=128)
    want = float(jawq.awq_search_scale_factor(jnp.asarray(w), jnp.asarray(imp), 3, 64, 0.05))
    got = awq.awq_search_scale_factor(cpu(w), cpu(imp), 3, 64, 0.05)
    assert got.dtype == torch.float32 and float(got) == want


# ----------------------------------------------------------- SmoothQuant
def _w_amax(seed, out=96, inp=256):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out, inp)) * 0.05).astype(np.float32).astype(BF16)
    amax = (np.abs(rng.standard_normal(inp)) * 4 + 0.01).astype(np.float32)
    amax[:3] = 0.0  # the 1e-5 clamp binds
    return w, amax


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("alpha", [0.5, 0.25, 0.85])
def test_smoothing_scales_within_two_ulps_of_qtpu(alpha):
    """torch.pow against XLA's pow: not bit for bit (torch takes x^0.5 as
    sqrt); the gap is at most two ulps, and most scales are equal."""
    w, amax = _w_amax(int(alpha * 100))
    want = np.asarray(jsq.compute_smoothing_scales(jnp.asarray(amax), jnp.asarray(w), alpha))
    got = smoothquant.compute_smoothing_scales(cpu(amax), cpu(w), alpha).numpy()
    assert got.dtype == np.float32
    assert _ulps(got, want) <= 2
    assert (got == want).mean() >= 0.9


@pytest.mark.parametrize("n_bit,group,alpha", [(8, 128, 0.5), (4, 64, 0.5), (4, -1, 0.7)])
def test_smoothquant_fake_quant_matches_qtpu(n_bit, group, alpha):
    """From one smoothing vector (qtpu's) the weights equal bit for bit;
    through each package's own scales >= 99.9% of elements are equal and
    the rest within one quantization step."""
    w, amax = _w_amax(7 + n_bit)
    s_j = jsq.compute_smoothing_scales(jnp.asarray(amax), jnp.asarray(w), alpha)
    want = np.asarray(jsq.smoothquant_quantize(jnp.asarray(w), jnp.asarray(amax), n_bit, group,
                                               alpha)[0])
    ws = smoothquant.smooth_weights(cpu(w), cpu(np.asarray(s_j)))
    _bits_equal(to_numpy(ws), jsq.smooth_weights(jnp.asarray(w), s_j))
    got, s = smoothquant.smoothquant_quantize(cpu(w), cpu(amax), n_bit, group, alpha)
    g, wt = _np(got), want.astype(np.float32)
    assert (g == wt).mean() >= 0.999
    step = (np.abs(_np(smoothquant.smooth_weights(cpu(w), s))).max() * 2) / (2**n_bit - 1)
    assert np.abs(g - wt).max() <= step * 1.01
    back = smoothquant.reverse_smoothing(smoothquant.smooth_weights(cpu(w), s), s)
    assert _rel(_np(back), w.astype(np.float32)) < 1e-2


def test_search_alpha_picks_qtpu_alpha():
    w, amax = _w_amax(3, out=64, inp=128)
    want = float(jsq.search_alpha(jnp.asarray(w), jnp.asarray(amax), 8, 64))
    got = smoothquant.search_alpha(cpu(w), cpu(amax), 8, 64)
    assert float(got) == want


# ------------------------------------------------------- model transforms
FAKE_CASES = {
    "awq": {"w_bit": 4, "q_group_size": 64, "protect_ratio": 0.05, "scale_factor": 2.0},
    "awq_search": {"w_bit": 3, "q_group_size": 64, "protect_ratio": 0.05, "search_scale": True},
    "smoothquant": {"w_bit": 8, "q_group_size": 64, "alpha": 0.5},
}
PACK_CASES = {
    "awq": {"w_bit": 4, "q_group_size": 64, "protect_ratio": 0.05, "scale_factor": 2.0},
    "smoothquant": {"w_bit": 4, "q_group_size": 64, "alpha": 0.5},
    "smoothquant_a8": {"w_bit": 8, "q_group_size": 64, "alpha": 0.5, "act_quant": True},
}
_QTPU = {}  # qtpu's results, computed once per module (its jit traces are slow)


def _method(case):
    return case.split("_")[0]


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def qtpu_once(key, fn):
    if key not in _QTPU:
        _QTPU[key] = fn()
    return _QTPU[key]


def _fake_both(case, model, cases=FAKE_CASES, hessian=False):
    p, pj, pt, js, ts, ts_nh = model
    mcfg = cases[case]
    want = qtpu_once(("fake", case), lambda: japply.quantize_model(
        pj, _method(case), mcfg, _jstats(js, hessian)))
    return want, tapply.quantize_model(pt, _method(case), mcfg, ts if hessian else ts_nh)


def _pack_both(case, model, cases=PACK_CASES, hessian=False):
    p, pj, pt, js, ts, ts_nh = model
    mcfg = cases[case]
    want = qtpu_once(("pack", case), lambda: japply.pack_model(
        pj, _method(case), mcfg, _jstats(js, hessian)))
    return want, tapply.pack_model(pt, _method(case), mcfg, ts if hessian else ts_nh)


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_quantize_model_matches_qtpu(case, model):
    """Leaves from the same stats: awq bit for bit; smoothquant's weights
    >= 99.9% equal (pow, above) and its smooth vectors within 2 ulps."""
    want, got = _fake_both(case, model)
    lw, lg = _leaves(want), _leaves(params_to_numpy(got))
    assert set(lg) == set(lw)
    for path, w in lw.items():
        g, w = np.asarray(lg[path]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if "smooth" in str(path):
            assert _ulps(g, w) <= 2, path
        elif case == "smoothquant" and str(path[-1]) == "['w']":
            assert (g.astype(np.float32) == w.astype(np.float32)).mean() >= 0.999, path
        else:
            _bits_equal(g, w)


def _compare_packed(case, want, got):
    """Equal trees and metas: awq bit for bit; SmoothQuant's
    smoothing vectors within 2 ulps of qtpu's (pow), so where a leaf's
    bytes differ >= 99% of them are equal and the values within 1e-2."""
    (pj, qj), (pt, qt) = want, got
    assert qt == qj
    lw, lg = _leaves(pj), _leaves(params_to_numpy(pt))
    assert set(lg) == set(lw)
    for path, w in lw.items():
        g, w = np.asarray(lg[path]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if "smooth" in str(path):
            assert _ulps(g, w) <= 2, path
        elif not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            assert case.startswith("smoothquant"), path
            assert (g.view(np.uint8) == w.view(np.uint8)).mean() >= 0.99, path
            assert _rel(g.astype(np.float32), w.astype(np.float32)) < 1e-2, path


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_model_matches_qtpu(case, model):
    _compare_packed(case, *_pack_both(case, model))


@pytest.mark.parametrize("case", ["awq", "smoothquant", "smoothquant_a8"])
def test_fold_and_fuse_match_qtpu(case, model):
    """fold_smooth then fuse_packed_sites: the same tree and metas. AWQ's
    and SmoothQuant's q/k/v and gate/up vectors are shared, so they fold
    and the sites fuse; W8A8 sites never fuse."""
    want, got = _pack_both(case, model)
    want = japply.fuse_packed_sites(*japply.fold_smooth(*want))
    got = tapply.fuse_packed_sites(*tapply.fold_smooth(*got))
    _compare_packed(case, want, got)
    names = set(got[0]["layers"])
    if case == "smoothquant_a8":
        assert "qkv_proj" not in names and all(len(m) == 5 for _, m in got[1])
        assert "smooth" in got[0]["layers"]["o_proj"]  # o_proj's vector stays
    else:
        assert {"qkv_proj", "gateup_proj"} <= names
        assert "smooth" not in got[0]["layers"]["qkv_proj"]


@pytest.mark.parametrize("case,k4", [("awq", True), ("smoothquant", True),
                                     ("smoothquant_a8", False)])
def test_k4_guard_after_fold(case, k4, model):
    """After fold_smooth, AWQ's and SmoothQuant-W4's gateup/down pairs are
    plain packed sites that K4 takes at decode; W8A8 sites run the composed
    MLP (qtpu's guard, llama.py:371-378)."""
    p, qm = tapply.fuse_packed_sites(*tapply.fold_smooth(*_pack_both(case, model)[1]))
    layers, qd = p["layers"], dict(qm)
    assert _k4.supported(qd.get("gateup_proj"), qd.get("down_proj"),
                         layers.get("gateup_proj"), layers.get("down_proj")) == k4


def test_fuse_keeps_unequal_shared_keys_apart():
    """A smooth vector that differs across q/k/v blocks the fusion; an
    equal one is kept once."""
    p = tllama.init_params(T_CFG, device="cpu")
    packed, qmeta = tapply.pack_model(p, "rtn", {"w_bit": 4, "q_group_size": 64})
    s = torch.ones(T_CFG.num_layers, T_CFG.hidden_size)
    for site, v in (("q_proj", s), ("k_proj", s), ("v_proj", 2 * s), ("gate_proj", s),
                    ("up_proj", s)):
        packed["layers"][site] = dict(packed["layers"][site], smooth=v)
    fused, fmeta = tapply.fuse_packed_sites(packed, qmeta)
    assert "qkv_proj" not in fused["layers"] and "gateup_proj" in fused["layers"]
    assert torch.equal(fused["layers"]["gateup_proj"]["smooth"], s)
    assert dict(fmeta)["gateup_proj"] == (4, 64, 256, 1024)


@pytest.mark.parametrize("method", ["pot", "apot"])
def test_pot_apot_raise_naming_their_slice(method):
    """POT/APOT are ported (tests/test_torch_pot.py holds them to qtpu):
    fake quantization runs at any width; the refusal left is qtpu's, a
    codebook pack at another width than 4 bits."""
    p = tllama.init_params(T_CFG, device="cpu")
    q = tapply.quantize_model(p, method, {"w_bit": 4, "q_group_size": 64, "grid_step": 0.25})
    w, wq = p["layers"]["q_proj"]["w"], q["layers"]["q_proj"]["w"]
    assert wq.shape == w.shape and wq.dtype == w.dtype and bool(torch.isfinite(wq).all())
    assert not torch.equal(wq, w)
    with pytest.raises(ValueError, match="w_bit=4 only"):
        tapply.pack_model(p, method, {"w_bit": 8, "q_group_size": 64})


# ---------------------------------------------------------- end to end
def _forward_both(want, got, ids, qmeta=None):
    w = np.asarray(jllama.forward(want, jnp.asarray(ids), TINY_TEST, qmeta=qmeta))
    g = tllama.forward(got, cpu(ids), T_CFG, qmeta=qmeta)
    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
    return _rel(g.numpy(), w)


def logits_match(fake, packed):
    """forward on the fake-quant weights and on the packed, folded, fused
    artifact: each within LOGIT_TOL of qtpu's."""
    ids = np.random.default_rng(21).integers(0, 512, (2, 40), dtype=np.int32)
    assert _forward_both(*fake, ids) < LOGIT_TOL
    (pj, qj), (pt, qt) = [tapply.fuse_packed_sites(*tapply.fold_smooth(*packed[1]))
                          if i else japply.fuse_packed_sites(*japply.fold_smooth(*packed[0]))
                          for i in (0, 1)]
    assert qt == qj
    assert _forward_both(pj, pt, ids, qmeta=qj) < LOGIT_TOL


@pytest.mark.parametrize("fake,packed", [("awq", "awq"), ("smoothquant", "smoothquant_a8")])
def test_fake_and_packed_logits_match_qtpu(fake, packed, model):
    """K1 and K6's plain versions on the CPU: the SmoothQuant artifact is
    W8A8."""
    logits_match(_fake_both(fake, model), _pack_both(packed, model))


def test_w8a8_prefill_and_decode_match_qtpu(model):
    """SmoothQuant W8A8 through forward_with_cache on the int8 KV cache:
    a prefill of 12 tokens and 4 decode steps, teacher-forced with qtpu's
    greedy tokens."""
    want, got = _pack_both("smoothquant_a8", model)
    kj = japply.fuse_packed_sites(*japply.fold_smooth(*want))
    kt = tapply.fuse_packed_sites(*tapply.fold_smooth(*got))
    B, T = 2, 12
    ids = np.random.default_rng(8).integers(0, 512, (B, T), dtype=np.int32)
    cj = jkv.init_cache(TINY_TEST, B, 32, quantized=True)
    ct = tkv.init_cache(T_CFG, B, 32, quantized=True, device="cpu")
    lj, cj = jdecode.prefill(kj[0], jnp.asarray(ids), cj, TINY_TEST, kj[1])
    lt, ct = tdecode.prefill(kt[0], cpu(ids), ct, T_CFG, kt[1])
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = np.full((B,), T, np.int32)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32).reshape(B)
        lj, cj = jdecode.decode_step(kj[0], jnp.asarray(tok), jnp.asarray(pos), cj, TINY_TEST,
                                     kj[1])
        lt, ct = tdecode.decode_step(kt[0], cpu(tok), cpu(pos), ct, T_CFG, kt[1])
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1


def test_serve_cli_w8a8_on_cpu(capsys):
    assert serve_main(["--device", "cpu", "--method", "smoothquant", "--a8", "--kv", "int8",
                       "--requests", "2", "--tokens", "3", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "packed model with smoothquant W8A8 g64" in out and "2 requests, 6 tokens" in out
    for method in ("awq", "gptq"):
        assert serve_main(["--device", "cpu", "--method", method, "--kv", "int8",
                           "--requests", "1", "--tokens", "2"]) == 0
        assert f"packed model with {method} W4 g64" in capsys.readouterr().out
    assert serve_main(["--device", "cpu", "--method", "apot", "--requests", "1",
                       "--tokens", "2"]) == 0
    assert "packed model with apot W4 g64" in capsys.readouterr().out


def test_runner_calibrated_methods_on_tiny_test(tmp_path):
    cfg = {
        "model_name": "tiny-test", "quantization_methods": ["awq", "gptq", "smoothquant"],
        "calibration_dataset": "synthetic", "test_dataset": "synthetic",
        "n_calibration_samples": 2, "calibration_block_size": 64,
        "n_test_samples": 2, "test_block_size": 64,
        "quantization_config": {
            "awq": {"w_bit": 4, "q_group_size": 64, "protect_ratio": 0.01},
            "gptq": {"w_bit": 4, "q_group_size": 64, "error_compensation": True},
            "smoothquant": {"w_bit": 8, "q_group_size": 64, "alpha": 0.5, "act_quant": True},
        },
        "packed_eval": True,
        "serving": {"benchmark": True, "max_batch_size": 2, "pack_method": "smoothquant"},
        "verbose": False, "device": "cpu",
    }
    path, out = tmp_path / "config.json", tmp_path / "results.json"
    path.write_text(json.dumps(cfg))
    assert bench_main([str(path), "--out", str(out)]) == 0
    res = json.loads(out.read_text())["results"]
    assert list(res) == ["raw", "awq", "gptq", "smoothquant", "serving"]
    for name, rec in res.items():
        assert rec["error"] is None and rec.get("packed_error") is None, (name, rec)
    for name in ("awq", "gptq", "smoothquant"):
        assert abs(res[name]["packed_perplexity"] / res[name]["perplexity"] - 1) < 1e-2, name
    assert res["serving"]["tokens_per_second"] > 0
    assert res["serving"]["config"]["pack_method"] == "smoothquant"
