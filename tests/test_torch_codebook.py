"""The port's POT/APOT codebook path against qtpu on the CPU, on the same
numpy-made weights and token ids: K7's plain version against qtpu's XLA
reference and the Pallas kernel in interpret mode, quantize_model and
pack_model for pot and apot, packed and fused codebook sites in forward,
decode on the bf16 KV cache (K8's plain version), qtpu's packed artifacts
crossing over through convert, the benchmark runner and the serve CLI.

Codes and scales equal qtpu's bit for bit but for the counted groups that
tests/test_torch_pot.py describes (the log2 window and ties of the scale
race).
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.bench.runner import QuantizationBenchmark as JaxBenchmark
from qtpu.core.packing import pack_int4 as jax_pack_int4
from qtpu.kernels.dequant_matmul import _codebook_matmul_ref
from qtpu.kernels.pallas_dequant_matmul import pallas_codebook_matmul
from qtpu.models import llama as jllama
from qtpu.models.config import TINY_TEST
from qtpu.quant import apply as japply
from qtpu.quant.apot import apot_quantize_codes as jax_apot_codes
from qtpu.quant.pot import pot_codebook as jax_pot_codebook
from qtpu.quant.pot import pot_quantize_codes as jax_pot_codes
from qtpu.serve import decode as jdecode
from qtpu.serve import kvcache as jkv
from qtpu_torch.bench import QuantizationBenchmark
from qtpu_torch.convert import params_to_numpy, params_to_torch, to_numpy, to_torch
from qtpu_torch.kernels import codebook_matmul as k7
from qtpu_torch.kernels import kv_attention as k8
from qtpu_torch.models import config as tconfig
from qtpu_torch.models import llama as tllama
from qtpu_torch.quant import apply as tapply
from qtpu_torch.serve import decode as tdecode
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.__main__ import main as serve_main
from test_torch_pot import _check_groups, _cols, _window_groups
from test_torch_quant import _np_params, one_torch_thread  # noqa: F401  (a fixture)

BF16 = ml_dtypes.bfloat16
T_CFG = tconfig.TINY_TEST
LOGIT_TOL = 2e-2  # relative Frobenius error of the f32 logits (bf16 layers, other sum orders)
PPL_TOL = 1e-2
METHODS = {"pot": {"w_bit": 4, "q_group_size": 64},
           "apot": {"w_bit": 4, "q_group_size": 64, "k": 2}}


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def _assert_close(out, ref):
    """tests/test_pallas_kernels.py's tolerance for the Pallas kernel."""
    o, r = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert _rel(o, r) < 2e-2
    np.testing.assert_allclose(o, r, atol=0.05 * (np.abs(r).max() + 1e-6))


# ----------------------------------------------------------- K7 plain
def _site(method, K, N, g, seed):
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.05).astype(np.float32)
    grid = (0.01, 2.01, 0.1)
    if method == "pot":
        codes, sc = jax_pot_codes(jnp.asarray(w), 4, g, grid=grid)
        cb = jax_pot_codebook(4)
    else:
        codes, sc, cb = jax_apot_codes(jnp.asarray(w), 4, g, grid=grid)
    return jax_pack_int4(codes, g), sc.astype(jnp.bfloat16), cb


@pytest.mark.parametrize("method", ["pot", "apot"])
@pytest.mark.parametrize("M,g", [(1, 64), (16, 64), (16, 128), (40, 32)])
def test_k7_plain_matches_qtpu_reference_and_pallas(method, M, g):
    K, N = 256, 256
    data, sc, cb = _site(method, K, N, g, M + g)
    x = (np.random.default_rng(M).standard_normal((M, K))).astype(np.float32).astype(BF16)
    meta = (4, g, K, N)
    got = to_numpy(k7.codebook_matmul(cpu(x), cpu(data), cpu(sc), cpu(cb), meta))
    ref = _codebook_matmul_ref(jnp.asarray(x), data, sc, cb, meta)
    _assert_close(got, ref)
    _assert_close(got, pallas_codebook_matmul(jnp.asarray(x), data, sc, cb, meta, interpret=True))
    assert k7.codebook_matmul.launches == 0  # the CPU takes the plain version


def test_k7_plain_weight_is_qtpus_dequantized_weight():
    data, sc, cb = _site("apot", 128, 64, 64, 3)
    w = k7.codebook_weight(cpu(data), cpu(sc), cpu(cb), (4, 64, 128, 64), torch.float32)
    eye = jnp.eye(128, dtype=jnp.float32)
    want = _codebook_matmul_ref(eye, data, sc, cb, (4, 64, 128, 64))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))


# ----------------------------------------------------------- model level
@pytest.fixture(scope="module")
def model():
    p = _np_params(TINY_TEST)
    return p, jax.tree_util.tree_map(jnp.asarray, p), params_to_torch(p, device="cpu")


SITES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _site_weights(tree):
    """{site: [L, K, N] or [K, N]} of a dense params tree, as numpy f32."""
    t = params_to_numpy(tree) if isinstance(tree["lm_head"]["w"], torch.Tensor) else tree
    out = {s: np.asarray(t["layers"][s]["w"]).astype(np.float32) for s in SITES}
    out["lm_head"] = np.asarray(t["lm_head"]["w"]).astype(np.float32)[None]
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_quantize_model_equals_qtpu(method, model):
    """Fake-quant leaves: groups along K (the reference orientation) equal
    bit for bit, the counted groups apart."""
    p, pj, pt = model
    mcfg = METHODS[method]
    want = _site_weights(japply.quantize_model(pj, method, mcfg))
    got = _site_weights(tapply.quantize_model(pt, method, mcfg))
    w = _site_weights(p)
    g = mcfg["q_group_size"]
    ties = 0
    for site in w:
        for l in range(w[site].shape[0]):
            rows = [a[l].T.reshape(-1, g) for a in (w[site], got[site], want[site])]
            n_win, n_tie = _check_groups(*rows, _window_groups(rows[0]))
            ties += n_tie
    assert ties <= 4


@pytest.mark.parametrize("method", list(METHODS))
def test_pack_model_equals_qtpu(method, model):
    """data, scales and codebook leaves: the same bytes per (group, column),
    the counted groups apart; the same qmeta."""
    p, pj, pt = model
    mcfg = METHODS[method]
    (pk_j, qm_j), (pk_t, qm_t) = japply.pack_model(pj, method, mcfg), tapply.pack_model(pt, method,
                                                                                       mcfg)
    assert qm_t == qm_j
    g = mcfg["q_group_size"]
    w = _site_weights(p)
    npt = params_to_numpy(pk_t)
    for site in w:
        sj = pk_j["lm_head"] if site == "lm_head" else pk_j["layers"][site]
        st = npt["lm_head"] if site == "lm_head" else npt["layers"][site]
        assert set(st) == set(sj) == {"data", "scales", "codebook"}
        for k in st:
            assert st[k].dtype == np.asarray(sj[k]).dtype and st[k].shape == sj[k].shape, (site, k)
        np.testing.assert_array_equal(st["codebook"], np.asarray(sj["codebook"]))
        for l in range(w[site].shape[0]):
            def pick(a):
                a = np.asarray(a)
                return a if site == "lm_head" else a[l]
            K, N = w[site].shape[1:]
            meta = (4, g, K, N)
            deq = [k7.codebook_weight(cpu(pick(s["data"])), cpu(pick(s["scales"])),
                                      cpu(pick(s["codebook"])), meta, torch.float32).numpy()
                   for s in (st, sj)]
            same_bytes = (_cols(pick(st["data"]).view(np.uint8), g // 2)
                          == _cols(np.asarray(pick(sj["data"])).view(np.uint8), g // 2)).all(1)
            same_scale = (pick(st["scales"]).view(np.uint16).T.reshape(-1)
                          == np.asarray(pick(sj["scales"])).view(np.uint16).T.reshape(-1))
            same = same_bytes & same_scale.reshape(N, K // g).T.reshape(-1)
            wg = _cols(w[site][l], g)
            _check_groups(wg, _cols(deq[0], g), _cols(deq[1], g), _window_groups(wg), same)


@pytest.fixture(scope="module")
def packed(model):
    """{method: (qtpu's packed tree, qmeta, the port's packed tree)}."""
    p, pj, pt = model
    out = {}
    for method, mcfg in METHODS.items():
        pk_j, qm = japply.pack_model(pj, method, mcfg)
        pk_t, qm_t = tapply.pack_model(pt, method, mcfg)
        out[method] = (pk_j, qm, pk_t)
    return out


def _ids(seed=21, B=2, S=40):
    return np.random.default_rng(seed).integers(0, 512, (B, S), dtype=np.int32)


@pytest.mark.parametrize("method", list(METHODS))
def test_packed_logits_match_qtpu(method, packed):
    """The port's artifact and qtpu's artifact moved through convert, both
    through the port's forward, against qtpu's forward on its artifact."""
    pk_j, qm, pk_t = packed[method]
    ids = _ids()
    want = np.asarray(jllama.forward(pk_j, jnp.asarray(ids), TINY_TEST, qmeta=qm))
    crossed = params_to_torch(jax.tree_util.tree_map(np.asarray, pk_j), device="cpu")
    for tree in (pk_t, crossed):
        got = tllama.forward(tree, cpu(ids), T_CFG, qmeta=qm)
        assert got.dtype == torch.float32 and _rel(got.numpy(), want) < LOGIT_TOL


@pytest.mark.parametrize("method", list(METHODS))
def test_fused_codebook_sites_match_unfused(method, packed):
    """q/k/v and gate/up share one level table, so they fuse with one copy
    of it and give the same logits (qtpu tests/test_model.py:251-264)."""
    _, qm, pk_t = packed[method]
    fused, fmeta = tapply.fuse_packed_sites(pk_t, qm)
    assert "qkv_proj" in fused["layers"] and "gateup_proj" in fused["layers"]
    cb = fused["layers"]["qkv_proj"]["codebook"]
    assert tuple(cb.shape) == (T_CFG.num_layers, 16)
    ids = cpu(_ids(4))
    a = tllama.forward(pk_t, ids, T_CFG, qmeta=qm)
    b = tllama.forward(fused, ids, T_CFG, qmeta=fmeta)
    torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("window", [0, 10])
def test_bf16_cache_prefill_and_decode_match_qtpu(method, window, packed):
    """forward_with_cache on a bf16 KV cache: a prefill of 12 tokens, then 4
    decode steps (K8's plain version), teacher-forced with qtpu's greedy
    tokens, on qtpu's fused artifact moved through convert; window 10: a
    sliding window that binds."""
    pk_j, qm, _ = packed[method]
    fj, fq = japply.fuse_packed_sites(pk_j, qm)
    ft = params_to_torch(jax.tree_util.tree_map(np.asarray, fj), device="cpu")
    jcfg = TINY_TEST.replace(sliding_window=window)
    tcfg = T_CFG.replace(sliding_window=window)
    B, T = 2, 12
    ids = _ids(8, B, T)
    cj = jkv.init_cache(jcfg, B, 32, quantized=False)
    ct = tkv.init_cache(tcfg, B, 32, quantized=False, device="cpu")
    lj, cj = jdecode.prefill(fj, jnp.asarray(ids), cj, jcfg, fq)
    lt, ct = tdecode.prefill(ft, cpu(ids), ct, tcfg, fq)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = np.full((B,), T, np.int32)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32).reshape(B)
        lj, cj = jdecode.decode_step(fj, jnp.asarray(tok), jnp.asarray(pos), cj, jcfg, fq)
        lt, ct = tdecode.decode_step(ft, cpu(tok), cpu(pos), ct, tcfg, fq)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1
    assert k8.decode_attention_write_bf16.launches == 0  # the CPU takes the plain version


def test_k8_plain_matches_qtpu_write_and_attention():
    """K8's plain version: the cache after the write equals qtpu's
    cache_layer_write exactly (an inactive slot writes nothing), the output
    is within the Pallas test's 3e-2 of qtpu's interpret-mode kernel."""
    _k8_case(64)


@pytest.mark.parametrize("hd", [48, 80, 96, 112])
def test_k8_plain_matches_qtpu_write_and_attention_at_head_dims(hd):
    """The same at the head dims K8 takes besides 32, 64 and 128
    (OPT-2.7B's bf16 decode at 80)."""
    _k8_case(hd)


def _k8_case(hd):
    from qtpu.kernels.pallas_kv_attention import pallas_decode_attention_write_bf16

    rng = np.random.default_rng(6)
    L, B, H, KV, S = 2, 4, 8, 4, 64

    def bf(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(BF16)

    q, kn, vn = bf(B, H, hd), bf(B, 1, KV, hd), bf(B, 1, KV, hd)
    kc, vc = bf(L, B, KV, S, hd), bf(L, B, KV, S, hd)
    pos = np.array([5, 17, 40, S], np.int32)
    for window in (0, 16):
        out_j, ko, vo = pallas_decode_attention_write_bf16(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc[1]),
            jnp.asarray(vc[1]), jnp.asarray(pos), window=window, interpret=True)
        k_all, v_all = cpu(kc), cpu(vc)
        out = k8.decode_attention_write_bf16(cpu(q), cpu(kn), cpu(vn), k_all, v_all, cpu(pos), 1,
                                             window=window)
        np.testing.assert_array_equal(to_numpy(k_all[1]).view(np.uint16),
                                      np.asarray(ko).view(np.uint16))
        np.testing.assert_array_equal(to_numpy(v_all[1]).view(np.uint16),
                                      np.asarray(vo).view(np.uint16))
        np.testing.assert_array_equal(to_numpy(k_all[0]).view(np.uint16), kc[0].view(np.uint16))
        np.testing.assert_allclose(to_numpy(out)[:-1].astype(np.float32),
                                   np.asarray(out_j, np.float32)[:-1], rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------ bench, CLI
BENCH_CONFIG = {
    "model_name": "tiny-test", "quantization_methods": ["pot", "apot"],
    "calibration_dataset": "synthetic", "test_dataset": "synthetic",
    "n_calibration_samples": 2, "calibration_block_size": 64,
    "n_test_samples": 2, "test_block_size": 64,
    "quantization_config": {"pot": dict(METHODS["pot"], grid_step=0.05), "apot": METHODS["apot"]},
    "packed_eval": True,
    "serving": {"benchmark": True, "max_batch_size": 2, "pack_method": "pot",
                "kv_cache_dtype": "bfloat16"},
    "verbose": False,
}


def test_runner_pot_apot_match_qtpu(model):
    """Both runners on the same numpy params: perplexities (fake-quant and
    packed) within 1e-2 of qtpu's, sizes equal, serving on the POT artifact
    with the bf16 KV cache."""
    p, pj, pt = model
    benches = {}
    for name, cls, params, extra in (("qtpu", JaxBenchmark, pj, {}),
                                     ("port", QuantizationBenchmark, pt, {"device": "cpu"})):
        b = cls(dict(BENCH_CONFIG, **extra))
        b.setup()
        b.params = params
        b.benchmark_raw_model()
        for m in METHODS:
            b.benchmark_method(m)
        b.benchmark_serving()
        benches[name] = b.results
    jr, tr = benches["qtpu"], benches["port"]
    assert list(tr) == list(jr) == ["raw", "pot", "apot", "serving"]
    for name in ("raw", "pot", "apot"):
        assert tr[name].error is None and tr[name].packed_error is None, name
        assert tr[name].model_size_mb == jr[name].model_size_mb, name
        assert tr[name].bits_per_byte == jr[name].bits_per_byte, name
        assert abs(tr[name].perplexity / jr[name].perplexity - 1) < PPL_TOL, name
        if name != "raw":
            assert abs(tr[name].packed_perplexity / jr[name].packed_perplexity - 1) < PPL_TOL
    assert tr["serving"].error is None and tr["serving"].tokens_per_second > 0


def test_runner_pot_sweep_records_packed_error_at_w8(tmp_path):
    """A w_bit sweep: pot@w4 packs, pot@w8 has no codebook form and records
    packed_error without failing the run (qtpu tests/test_bench.py:192-196)."""
    cfg = dict(BENCH_CONFIG, quantization_methods=["pot"], serving={"benchmark": False},
               quantization_config={"pot": {"w_bit": [4, 8], "q_group_size": 64,
                                            "grid_step": 0.2}}, device="cpu")
    path, out = tmp_path / "config.json", tmp_path / "results.json"
    path.write_text(json.dumps(cfg))
    from qtpu_torch.bench.__main__ import main as bench_main

    assert bench_main([str(path), "--out", str(out)]) == 0
    res = json.loads(out.read_text())["results"]
    assert list(res) == ["raw", "pot@w4", "pot@w8"]
    assert res["pot@w4"]["packed_perplexity"] is not None and res["pot@w4"]["error"] is None
    assert res["pot@w8"]["error"] is None and res["pot@w8"]["perplexity"] is not None
    assert "w_bit=4 only" in res["pot@w8"]["packed_error"]


@pytest.mark.parametrize("method", ["pot", "apot"])
def test_serve_cli_codebook_on_the_default_bf16_cache(method, capsys):
    assert serve_main(["--device", "cpu", "--method", method, "--requests", "2", "--tokens", "3",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert f"packed model with {method} W4 g64" in out and "2 requests, 6 tokens" in out
