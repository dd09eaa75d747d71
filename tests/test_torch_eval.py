"""The port's quantize-and-evaluate path against qtpu on the CPU, on the
same numpy-made weights and tokens: RTN fake quantization bit for bit,
quantize_model / fold_smooth leaves, sizes exactly, the synthetic and
fixture data, forward logits (dense, fake-quant, packed + fused; causal
and sliding-window), perplexity, and the benchmark runner's results JSON.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.bench.results import BenchmarkResult as JaxResult
from qtpu.configs import default_config as jax_default_config
from qtpu.configs import list_presets as jax_list_presets
from qtpu.core import dtypes as jdtypes
from qtpu.core import groups as jgroups
from qtpu.core import sizing as jsizing
from qtpu.core.packing import quantize_pack as jax_quantize_pack
from qtpu.data import fixture as jfixture
from qtpu.data import pipeline as jpipeline
from qtpu.data import synthetic as jsynthetic
from qtpu.eval.perplexity import evaluate_perplexity as jax_ppl
from qtpu.models import llama as jllama
from qtpu.models.config import TINY_MISTRAL_TEST, TINY_TEST, TINYLLAMA_1_1B
from qtpu.quant import apply as japply
from qtpu.quant import rtn as jrtn
from qtpu_torch.bench import QuantizationBenchmark
from qtpu_torch.bench.__main__ import main as bench_main
from qtpu_torch.configs import default_config, list_presets, load_presets, validate_config
from qtpu_torch.convert import params_to_numpy, params_to_torch, to_torch
from qtpu_torch.core import dtypes, groups, sizing
from qtpu_torch.core.dtypes import MiB
from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.data import fixture, pipeline, synthetic
from qtpu_torch.eval import evaluate_perplexity
from qtpu_torch.models import config as tconfig
from qtpu_torch.models import llama as tllama
from qtpu_torch.quant import apply as tapply
from qtpu_torch.quant import rtn

BF16 = ml_dtypes.bfloat16
FIXTURE = Path(__file__).resolve().parent.parent / "fixtures" / "public_bytes"
# relative Frobenius error of the f32 logits: both sides run bf16 layers,
# rounded and summed in another order (XLA vs PyTorch CPU kernels)
LOGIT_TOL = 2e-2
PPL_TOL = 1e-2  # relative perplexity, the acceptance bound of the eval path
MCFG = {"w_bit": 4, "q_group_size": 64}
T_CFG = {"tiny-test": tconfig.TINY_TEST, "tiny-mistral-test": tconfig.TINY_MISTRAL_TEST}
J_CFG = {"tiny-test": TINY_TEST, "tiny-mistral-test": TINY_MISTRAL_TEST}


def cpu(a):
    return to_torch(a, device="cpu")


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


def _assert_trees_equal(tree_t, tree_j):
    """Every leaf of the port's tree equals qtpu's, bit for bit."""
    flat_t = jax.tree_util.tree_flatten_with_path(params_to_numpy(tree_t))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree_j)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        want = np.asarray(flat_j[path])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        if leaf.dtype == BF16:
            leaf, want = leaf.view(np.uint16), want.view(np.uint16)
        np.testing.assert_array_equal(leaf, want, err_msg=str(path))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


# ------------------------------------------------------------------ RTN
@pytest.mark.parametrize("fn", ["pseudo_quantize", "symmetric_fake_quantize"])
@pytest.mark.parametrize("n_bit,group", [(4, 64), (4, -1), (3, 32), (8, 128), (2, 32)])
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_rtn_equals_qtpu_bit_for_bit(fn, n_bit, group, dtype):
    rng = np.random.default_rng(n_bit * 100 + max(group, 0))
    w = (rng.standard_normal((96, 256)) * 0.05).astype(np.float32)
    w[3, :64] = 0.0  # a flat group: the 1e-5 scale clamp binds
    w[5] *= 40.0  # an outlier row
    w = w.astype(dtype)
    want = np.asarray(getattr(jrtn, fn)(jnp.asarray(w), n_bit=n_bit, q_group_size=group))
    got = getattr(rtn, fn)(cpu(w), n_bit=n_bit, q_group_size=group)
    got = params_to_numpy({"w": got})["w"]
    assert got.dtype == want.dtype
    if dtype == BF16:
        got, want = got.view(np.uint16), want.view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_rtn_rejects_what_qtpu_rejects():
    with pytest.raises(ValueError, match="group"):
        rtn.pseudo_quantize(torch.zeros(4, 100), 4, 64)
    with pytest.raises(ValueError, match="2-D"):
        rtn.pseudo_quantize(torch.zeros(2, 4, 8), 4, -1)


@pytest.mark.parametrize("shape,group", [((8, 256), 64), ((8, 256), -1), ((2, 4, 32), -1)])
def test_groups_equal_qtpu(shape, group):
    w = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    gt, st = groups.to_groups(torch.from_numpy(w), group)
    gj, sj = jgroups.to_groups(jnp.asarray(w), group)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert tuple(st) == tuple(sj)
    np.testing.assert_array_equal(groups.from_groups(gt, st).numpy(), w)
    assert groups.num_groups(shape, group) == jgroups.num_groups(shape, group)


# ------------------------------------------------------ model transforms
def test_quantize_model_rtn_leaves_equal_qtpu():
    p = _np_params(TINY_TEST)
    want = japply.quantize_model(jax.tree_util.tree_map(jnp.asarray, p), "rtn", MCFG)
    got = tapply.quantize_model(params_to_torch(p, device="cpu"), "rtn", MCFG)
    _assert_trees_equal(got, want)


def test_fold_smooth_equals_qtpu():
    """numpy smooth vectors on every foldable site (q/k/v and gate/up share
    theirs, down_proj folds into up_proj's scales, lm_head into final_norm)
    and on o_proj, which stays."""
    cfg = TINY_TEST
    L, D, F, Q = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    rng = np.random.default_rng(11)

    def smooth(*shape):
        return (0.5 + rng.random(shape)).astype(np.float32).astype(BF16)

    s_attn, s_mlp = smooth(L, D), smooth(L, D)
    extra = {"q_proj": s_attn, "k_proj": s_attn, "v_proj": s_attn, "gate_proj": s_mlp,
             "up_proj": s_mlp, "down_proj": smooth(L, F), "o_proj": smooth(L, Q)}
    s_head = smooth(D)
    pj, qj = japply.pack_model(jax.tree_util.tree_map(jnp.asarray, _np_params(cfg)), "rtn", MCFG)
    pt, qt = tapply.pack_model(params_to_torch(_np_params(cfg), device="cpu"), "rtn", MCFG)
    for site, s in extra.items():
        pj["layers"][site] = dict(pj["layers"][site], smooth=jnp.asarray(s))
        pt["layers"][site] = dict(pt["layers"][site], smooth=cpu(s))
    pj["lm_head"] = dict(pj["lm_head"], smooth=jnp.asarray(s_head))
    pt["lm_head"] = dict(pt["lm_head"], smooth=cpu(s_head))
    fj, _ = japply.fold_smooth(pj, qj)
    ft, q_out = tapply.fold_smooth(pt, qt)
    assert q_out == qt
    assert "smooth" in ft["layers"]["o_proj"] and "smooth" not in ft["layers"]["down_proj"]
    _assert_trees_equal(ft, fj)


def test_quantize_model_refuses_unported_methods():
    """Every qtpu method is ported; an unknown one is refused as qtpu
    refuses it."""
    p = tllama.init_params(tconfig.TINY_TEST, device="cpu")
    with pytest.raises(ValueError, match="unknown quantization method"):
        tapply.quantize_model(p, "lloyd", MCFG)
    with pytest.raises(ValueError, match="does not support method"):
        tapply.pack_model(p, "lloyd", MCFG)


# ----------------------------------------------------------------- sizes
def test_sizes_equal_qtpu():
    p = _np_params(TINY_TEST)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = params_to_torch(p, device="cpu")
    assert sizing.count_params(pt) == jsizing.count_params(pj)
    for w, g, z in ((32, -1, True), (4, 128, True), (4, 64, False), (8, 32, True)):
        assert sizing.get_model_size(pt, w, g, z) == jsizing.get_model_size(pj, w, g, z)
    packed_j, _ = japply.pack_model(pj, "rtn", MCFG)
    packed_t, _ = tapply.pack_model(pt, "rtn", MCFG)
    assert sizing.get_packed_size(packed_t) == jsizing.get_packed_size(packed_j)
    w = np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32)
    for bits, grp, sym in ((4, 64, False), (2, 32, True), (8, 128, False)):
        qt = quantize_pack(torch.from_numpy(w), bits, grp, sym)
        qj = jax_quantize_pack(jnp.asarray(w), bits, grp, sym)
        assert sizing.get_packed_size({"w": qt}) == jsizing.get_packed_size({"w": qj})
        assert sizing.count_params([qt]) == jsizing.count_params([qj]) == w.size
    assert sizing.bits_to_mb(3 * MiB) == jsizing.bits_to_mb(3 * MiB) == 3.0


def test_tinyllama_sizes_at_full_shapes():
    """All of TinyLlama-1.1B's shapes (meta tensors, nothing allocated)
    against jax.eval_shape of qtpu's init_params: the W4 g128 accounting
    is 68.13 MB at 2.078 bits per byte of the bf16 model."""
    pt = tllama.init_params(tconfig.TINYLLAMA_1_1B, device="meta")
    pj = jax.eval_shape(lambda: jllama.init_params(TINYLLAMA_1_1B, jax.random.PRNGKey(0)))
    n = sizing.count_params(pt)
    assert n == jsizing.count_params(pj)
    bits = sizing.get_model_size(pt, 4, 128, True)
    assert bits == jsizing.get_model_size(pj, 4, 128, True)
    assert round(bits / (8 * MiB), 2) == 68.13
    assert round(bits / (n * 2), 3) == 2.078


# ------------------------------------------------------------------ data
def test_synthetic_stream_byte_identical():
    for vocab, n, seed in ((512, 3000, 1234), (32000, 5000, 42)):
        got = synthetic.synthetic_token_stream(vocab, n, seed)
        want = jsynthetic.synthetic_token_stream(vocab, n, seed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got = synthetic.synthetic_blocks(512, 3, 64, seed=42)
    want = jsynthetic.synthetic_blocks(512, 3, 64, seed=42)
    assert [b.tobytes() for b in got] == [b.tobytes() for b in want]


def test_pipeline_equals_qtpu(monkeypatch):
    fx = f"fixture:{FIXTURE}"
    args = dict(n_samples=4, block_size=512, vocab_size=32000)
    got = pipeline.get_calibration_dataset(None, fx, None, "validation", **args)
    want = jpipeline.get_calibration_dataset(None, fx, None, "validation", **args)
    assert [b.tobytes() for b in got] == [b.tobytes() for b in want]
    got = pipeline.get_test_dataset(None, fx, None, "test", 4, 2048, 32000)
    want = jpipeline.get_test_dataset(None, fx, None, "test", 4, 2048, 32000)
    assert got.shape == (1, 153772) and got.tobytes() == want.tobytes()
    # qtpu's rule: a named dataset without a tokenizer is the synthetic stream
    got = pipeline.get_test_dataset(None, "wikitext", None, "test", 2, 64, 512)
    want = jpipeline.get_test_dataset(None, "wikitext", None, "test", 2, 64, 512)
    assert got.tobytes() == want.tobytes()
    # with a tokenizer, a named dataset comes from `datasets.load_dataset`
    # (both packages import it on that branch), here an in-memory one
    datasets = pytest.importorskip("datasets")
    rows = datasets.Dataset.from_dict({"text": ["ab cde", "", "f gh ijkl"]})
    monkeypatch.setattr(datasets, "load_dataset", lambda *a, split=None: rows)

    class Words:
        def __call__(self, text, return_tensors=None):
            out = type("R", (), {})()
            out.input_ids = np.asarray([[len(w) for w in text.split()]], np.int64)
            return out

    got = pipeline.get_test_dataset(Words(), "wikitext", None, "test", 2, 64, 512)
    want = jpipeline.get_test_dataset(Words(), "wikitext", None, "test", 2, 64, 512)
    assert got.dtype == np.int32 and got.tolist() == [[2, 3, 1, 2, 4]]
    assert got.tobytes() == want.tobytes()


def test_fixture_files_equal_qtpu(tmp_path):
    """A fixture written by the port is byte for byte the one qtpu writes,
    and each package reads the other's."""
    rng = np.random.default_rng(2)
    blocks = [rng.integers(0, 32000, (1, 64), dtype=np.int32) for _ in range(3)]
    test = rng.integers(0, 32000, (1, 500), dtype=np.int32)
    meta = {"dataset": "numpy", "model_name": "tiny-test"}
    fixture.save_fixture(str(tmp_path / "t"), blocks, test, meta)
    jfixture.save_fixture(str(tmp_path / "j"), blocks, test, meta)
    for name in ("meta.json", "calib_blocks.npy", "test_tokens.npy"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert fixture.fixture_meta(str(tmp_path / "j")) == jfixture.fixture_meta(str(tmp_path / "t"))
    got = fixture.load_fixture_calibration(str(tmp_path / "j"), 2, 64)
    want = jfixture.load_fixture_calibration(str(tmp_path / "t"), 2, 64)
    assert [b.tobytes() for b in got] == [b.tobytes() for b in want]
    assert fixture.load_fixture_test(str(tmp_path / "j")).tobytes() == test.tobytes()
    with pytest.raises(ValueError, match="block size"):
        fixture.load_fixture_calibration(str(tmp_path / "t"), 2, 128)
    with pytest.raises(ValueError, match="calibration blocks"):
        fixture.load_fixture_calibration(str(tmp_path / "t"), 4, 64)


@pytest.mark.parametrize("name", ["float16", "float32", "bfloat16", "int8"])
def test_dtypes_resolve_like_qtpu(name):
    """A config's dtype string names the same type, of the same width."""
    got, want = dtypes.resolve_dtype(name), jdtypes.resolve_dtype(name)
    assert str(got).removeprefix("torch.") == np.dtype(want).name
    assert dtypes.bits_of(name) == jdtypes.bits_of(want) == got.itemsize * 8
    assert dtypes.resolve_dtype(None) is None and dtypes.resolve_dtype(got) is got
    with pytest.raises(ValueError, match="unknown dtype"):
        dtypes.resolve_dtype("float7")


# --------------------------------------------------------- forward, ppl
def _variants(name):
    """(qtpu params, qmeta, port params, qmeta) for dense, RTN fake-quant and
    RTN-packed + fused weights of one tiny config."""
    p = _np_params(J_CFG[name])
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = params_to_torch(p, device="cpu")
    packed_j = japply.fuse_packed_sites(*japply.pack_model(pj, "rtn", MCFG))
    packed_t = tapply.fuse_packed_sites(*tapply.pack_model(pt, "rtn", MCFG))
    return {
        "dense": (pj, None, pt, None),
        "fake": (japply.quantize_model(pj, "rtn", MCFG), None,
                 tapply.quantize_model(pt, "rtn", MCFG), None),
        "packed": (*packed_j, *packed_t),
    }


@pytest.mark.parametrize("name", ["tiny-test", "tiny-mistral-test"])
def test_forward_matches_qtpu(name):
    """S = 40: no multiple of 128, and past tiny-mistral's window of 8."""
    ids = np.random.default_rng(4).integers(0, 512, (2, 40), dtype=np.int32)
    for kind, (pj, qj, pt, qt) in _variants(name).items():
        want = np.asarray(jllama.forward(pj, jnp.asarray(ids), J_CFG[name], qmeta=qj))
        got = tllama.forward(pt, cpu(ids), T_CFG[name], qmeta=qt)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) < LOGIT_TOL, kind


def test_perplexity_matches_qtpu():
    ids = synthetic.synthetic_token_stream(512, 3 * 64 + 5, seed=1234)
    for kind, (pj, qj, pt, qt) in _variants("tiny-test").items():
        want = jax_ppl(pj, jnp.asarray(ids), TINY_TEST, n_samples=3, block_size=64, qmeta=qj)
        got = evaluate_perplexity(pt, ids, tconfig.TINY_TEST, n_samples=3, block_size=64,
                                  qmeta=qt)
        assert abs(got / want - 1) < PPL_TOL, (kind, got, want)


def test_perplexity_refuses_a_mesh():
    """A mesh with a pipe dim runs the GPipe schedule on the llama family
    and moe only, as qtpu's pipeline_nll; the sharded and pipelined evals
    themselves are tested in tests/test_torch_sharding.py and
    tests/test_torch_pipeline.py."""
    from types import SimpleNamespace

    from qtpu_torch.models import gpt2 as tgpt2

    p = tgpt2.init_params(tconfig.TINY_GPT2_TEST, device="cpu")
    with pytest.raises(NotImplementedError, match="llama family"):
        evaluate_perplexity(p, np.zeros((1, 128), np.int32), tconfig.TINY_GPT2_TEST, 1, 64,
                            arch="gpt2", mesh=SimpleNamespace(mesh_dim_names=("data", "pipe")))


# ---------------------------------------------------------------- runner
RUN_CONFIG = {
    "model_name": "tiny-test",
    "quantization_methods": ["rtn"],
    "calibration_dataset": "synthetic",
    "test_dataset": "synthetic",
    "n_calibration_samples": 2,
    "calibration_block_size": 64,
    "n_test_samples": 2,
    "test_block_size": 64,
    "quantization_config": {"rtn": {"w_bit": 4, "q_group_size": 64}},
    "packed_eval": True,
    "serving": {"benchmark": True, "max_batch_size": 2},
    "verbose": False,
    "device": "cpu",
}


def test_runner_results_have_qtpu_schema(tmp_path):
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(RUN_CONFIG))
    out = tmp_path / "results.json"
    assert bench_main([str(cfg_path), "--out", str(out)]) == 0
    saved = json.loads(out.read_text())
    assert {"timestamp", "config", "environment", "results"} <= set(saved)
    assert saved["environment"]["backend"] == "cpu" and saved["environment"]["torch_version"]
    assert list(saved["results"]) == ["raw", "rtn", "serving"]
    ref = JaxResult("x", {})
    ref.perplexity, ref.packed_perplexity = 1.0, 1.0
    for name, rec in saved["results"].items():
        assert rec["error"] is None, (name, rec["error"])
        if name == "serving":
            assert rec["tokens_per_second"] > 0
            continue
        assert set(JaxResult("x", {}).to_dict()) <= set(rec)
        assert rec["perplexity"] > 1.0
    rec = saved["results"]["rtn"]
    assert set(rec) == set(ref.to_dict())
    assert abs(rec["packed_perplexity"] / rec["perplexity"] - 1) < PPL_TOL
    # qtpu's arithmetic size model: W4 + 16/64 scale + 4/64 zero bits of 16
    assert rec["bits_per_byte"] == (4 + 20 / 64) / 2
    assert saved["results"]["raw"]["bits_per_byte"] == 16.0


def test_runner_sweeps_w_bit():
    cfg = dict(RUN_CONFIG, packed_eval=False, serving={"benchmark": False},
               quantization_config={"rtn": {"w_bit": [4, 8], "q_group_size": 64}})
    bench = QuantizationBenchmark(cfg)
    bench.run_all_benchmarks()
    assert list(bench.results) == ["raw", "rtn@w4", "rtn@w8"]
    sizes = [bench.results[n].model_size_mb for n in ("rtn@w4", "rtn@w8", "raw")]
    assert sizes == sorted(sizes) and all(r.is_success() for r in bench.results.values())


@pytest.mark.parametrize("extra,match", [
    ({"mesh": {"data": 1, "model": 2, "pipe": 1}}, "mesh 1x2x1 needs 2 devices, have 1"),
    ({"mesh": {"data": 2, "model": 1, "pipe": 1}}, "mesh 2x1x1 needs 2 devices, have 1"),
], ids=["extra0-sharding slice", "extra1-sharding slice"])
def test_runner_refuses_what_is_not_ported(extra, match, capsys):
    """A mesh above the world's ranks (one process here) is logged with
    qtpu's message and the run goes on single-device, as qtpu's
    `_setup_mesh` does; sharded runs: tests/test_torch_sharding.py."""
    bench = QuantizationBenchmark(dict(RUN_CONFIG, **extra, verbose=True,
                                       serving={"benchmark": False}))
    bench.run_all_benchmarks()
    assert f"{match} — running single-device" in capsys.readouterr().out
    assert bench.mesh is None and all(r.is_success() for r in bench.results.values())


def test_configs_equal_qtpu_apart_from_device():
    mine = default_config()
    assert mine.pop("device") == "cuda"
    assert mine == jax_default_config()
    assert list_presets() == jax_list_presets()
    for preset in load_presets().values():  # every preset validates
        validate_config({k: v for k, v in preset.items() if k != "description"})
    with pytest.raises(KeyError, match="no quantization_config"):
        validate_config({"quantization_methods": ["rtn"], "quantization_config": {}})
