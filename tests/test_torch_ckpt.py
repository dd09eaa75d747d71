"""The port's artifacts (qtpu_torch.ckpt) against qtpu's (qtpu.ckpt), and the
benchmark's checkpoint_path / save_artifacts flow against qtpu's.

An artifact written by either package loads in the other to the same
tensors, bit for bit, and saved again gives the same files: params.npz
equal key for key (dtype, shape, bytes) and meta.json equal as a dict.
Cases: packed W2/W4/W8 (RTN), POT and APOT codebook sites, a SmoothQuant
W8A8 model, bf16 raw params and an MoE [L, E, ...] tree. A version-1
artifact loads to version-2 bytes in both; a newer pack_format is refused
by both. The benchmark run on a tiny local Llama checkpoint (a model_name
that is no preset) with save_artifacts gives the artifact qtpu's benchmark
gives on the same checkpoint, byte for byte. Every comparison is exact but
the perplexities (relative 1e-2, the eval path's bound: bf16 forwards
summed in another order).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from qtpu.bench import QuantizationBenchmark as JaxBenchmark
from qtpu.ckpt import load_quantized as jax_load
from qtpu.ckpt import save_quantized as jax_save
from qtpu.models import get_arch as jax_get_arch
from qtpu.models.hf_import import config_from_hf as jax_config_from_hf
from qtpu_torch.bench.runner import QuantizationBenchmark
from qtpu_torch.calib import collect_calibration_stats
from qtpu_torch.ckpt import load_quantized, save_quantized
from qtpu_torch.convert import map_tree, params_to_numpy, to_numpy
from qtpu_torch.models import get_arch, llama, moe
from qtpu_torch.models.config import TINY_MOE_TEST, TINY_TEST
from qtpu_torch.quant.apply import pack_model
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

PPL_TOL = 1e-2

CASES = {  # case -> (method, mcfg); "bf16": the raw params, "moe": TINY_MOE_TEST rtn
    "w2": ("rtn", {"w_bit": 2, "q_group_size": 64}),
    "w4": ("rtn", {"w_bit": 4, "q_group_size": 64}),
    "w8": ("rtn", {"w_bit": 8, "q_group_size": 128}),
    "pot": ("pot", {"w_bit": 4, "q_group_size": 64}),
    "apot": ("apot", {"w_bit": 4, "q_group_size": 64}),
    "w8a8": ("smoothquant", {"w_bit": 8, "q_group_size": 128, "alpha": 0.5, "act_quant": True}),
    "bf16": (None, None),
    "moe": ("rtn", {"w_bit": 4, "q_group_size": 64}),
}


def _artifact(case):
    """(params, qmeta, meta) of one case, the port's tensors on the CPU."""
    method, mcfg = CASES[case]
    if case == "moe":
        params = moe.init_params(TINY_MOE_TEST, seed=3, device="cpu")
        packed, qmeta = pack_model(params, "rtn", mcfg, arch="moe")
        return packed, qmeta, {"method": method, "model": "tiny-moe-test", **mcfg}
    params = llama.init_params(TINY_TEST, seed=1, device="cpu")
    if method is None:
        return params, None, {}
    stats = None
    if method == "smoothquant":
        batches = [np.random.default_rng(i).integers(0, TINY_TEST.vocab_size, (1, 32),
                                                     dtype=np.int32) for i in range(2)]
        stats = collect_calibration_stats(llama.forward, params, batches, TINY_TEST)
    packed, qmeta = pack_model(params, method, mcfg, stats)
    return packed, qmeta, {"method": method, "model": "tiny-test", **mcfg}


def _files(d):
    """({key: array} of params.npz, meta.json as a dict)."""
    with np.load(d / "params.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((d / "meta.json").read_text())


def _same_files(a, b):
    (xa, ma), (xb, mb) = _files(a), _files(b)
    assert ma == mb
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and xa[k].shape == xb[k].shape, k
        assert xa[k].tobytes() == xb[k].tobytes(), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same_tree(got, want):
    """Tensor leaves of two trees, or a tree and a numpy tree, bit for bit."""
    lg, lw = _leaves(got), _leaves(want)
    assert sorted(lg) == sorted(lw)
    for k in lg:
        a = to_numpy(lg[k]) if isinstance(lg[k], torch.Tensor) else np.asarray(lg[k])
        b = to_numpy(lw[k]) if isinstance(lw[k], torch.Tensor) else np.asarray(lw[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _to_jax(tree):
    return map_tree(params_to_numpy(tree), jnp.asarray)


@pytest.mark.parametrize("case", list(CASES))
def test_port_writes_qtpu_reads(tmp_path, case):
    params, qmeta, meta = _artifact(case)
    save_quantized(tmp_path / "a", params, qmeta, meta)
    pj, qj, mj = jax_load(tmp_path / "a")
    assert qj == qmeta and mj == meta
    _same_tree(params, pj)
    jax_save(tmp_path / "b", pj, qj, mj)
    _same_files(tmp_path / "a", tmp_path / "b")


@pytest.mark.parametrize("case", list(CASES))
def test_qtpu_writes_port_reads(tmp_path, case):
    params, qmeta, meta = _artifact(case)
    jax_save(tmp_path / "a", _to_jax(params), qmeta, meta)
    pt, qt, mt = load_quantized(tmp_path / "a", device="cpu")
    assert qt == qmeta and mt == meta
    _same_tree(pt, params)
    assert all(t.device.type == "cpu" for t in _leaves(pt).values())
    save_quantized(tmp_path / "b", pt, qt, mt)
    _same_files(tmp_path / "a", tmp_path / "b")


def test_both_packages_write_the_same_artifact(tmp_path):
    """The same bf16 weights packed RTN W4 by each package and saved by
    each: the same files."""
    params = llama.init_params(TINY_TEST, seed=2, device="cpu")
    mcfg = {"w_bit": 4, "q_group_size": 64}
    from qtpu.quant.apply import pack_model as jax_pack

    pj, qj = jax_pack(_to_jax(params), "rtn", mcfg)
    jax_save(tmp_path / "j", pj, qj, {"method": "rtn"})
    save_quantized(tmp_path / "t", *pack_model(params, "rtn", mcfg), {"method": "rtn"})
    _same_files(tmp_path / "j", tmp_path / "t")


def test_round_trip_keeps_the_forward(tmp_path):
    params, qmeta, meta = _artifact("w4")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, TINY_TEST.vocab_size, (1, 24)))
    before = llama.forward(params, ids, TINY_TEST, qmeta=qmeta)
    save_quantized(tmp_path / "ck", params, qmeta, meta)
    loaded, qm, m = load_quantized(tmp_path / "ck", device="cpu")
    assert qm == qmeta and m["method"] == "rtn"
    assert torch.equal(llama.forward(loaded, ids, TINY_TEST, qmeta=qm), before)


def test_served_artifact_gives_the_in_process_tokens(tmp_path):
    """The loaded artifact, sites fused, serves the greedy tokens of the
    packed params it was saved from (int8 cache, the CPU's eager engine)."""
    from qtpu_torch.quant.apply import fuse_packed_sites
    from qtpu_torch.serve.batching import ContinuousBatcher

    params, qmeta, meta = _artifact("w4")
    save_quantized(tmp_path / "ck", params, qmeta, meta)
    loaded, qm, _ = load_quantized(tmp_path / "ck", device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, TINY_TEST.vocab_size, 9 + 5 * i) for i in range(3)]
    outs = []
    for tree, q in ((loaded, qm), (params, qmeta)):
        fp, fq = fuse_packed_sites(tree, q)
        eng = ContinuousBatcher(fp, TINY_TEST, qmeta=fq, max_batch=2, max_seq_len=64,
                                kv_dtype="int8", decode_block=4, seed=0, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_v1_artifact_migrates_and_newer_is_refused(tmp_path):
    """A pack_format 1 artifact (plain lo | hi << 4 W4 bytes, no
    pack_format field), written by hand, loads to the version-2 bytes in
    both packages; pack_format 99 is refused by both."""
    params, qmeta, meta = _artifact("w4")
    save_quantized(tmp_path / "v2", params, qmeta, meta)
    info = json.loads((tmp_path / "v2" / "meta.json").read_text())
    assert info["pack_format"] == 2
    del info["pack_format"]
    d = tmp_path / "v1"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(info))
    w4_sites = {s for s, m in qmeta if m[0] == 4}
    arrays, _ = _files(tmp_path / "v2")
    migrated = 0
    for k, a in arrays.items():
        parts = k.split("::")
        if a.dtype == np.int8 and parts[-1] == "data" and parts[-2] in w4_sites:
            arrays[k] = (a.view(np.uint8) ^ np.uint8(0x80)).view(np.int8)
            migrated += 1
    assert migrated == len(w4_sites)
    np.savez(d / "params.npz", **arrays)
    pt, qt, _ = load_quantized(d, device="cpu")
    pj, qj, _ = jax_load(d)
    assert qt == qj == qmeta
    _same_tree(pt, params)
    _same_tree(pj, params)
    info["pack_format"] = 99
    (d / "meta.json").write_text(json.dumps(info))
    for load in (lambda: load_quantized(d, device="cpu"), lambda: jax_load(d)):
        with pytest.raises(ValueError, match="pack_format"):
            load()


# --------------------------------------------------- the benchmark's flow
def _hf_checkpoint(path, family="llama"):
    t = transformers
    common = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)
    if family == "llama":
        cfg, cls = t.LlamaConfig(intermediate_size=256, **common), t.LlamaForCausalLM
    else:
        cfg = t.MixtralConfig(intermediate_size=96, num_local_experts=4, **common)
        cls = t.MixtralForCausalLM
    torch.manual_seed(0)
    cls(cfg).save_pretrained(path, safe_serialization=True)
    return str(path)


def _run_config(ckpt, art):
    return {
        "model_name": "my-local-llama",  # no preset: the checkpoint's config rules
        "checkpoint_path": ckpt,
        "quantization_methods": ["rtn"],
        "calibration_dataset": "synthetic", "n_calibration_samples": 2,
        "calibration_block_size": 64,
        "test_dataset": "synthetic", "n_test_samples": 2, "test_block_size": 64,
        "quantization_config": {"rtn": {"w_bit": 4, "q_group_size": 64}},
        "save_artifacts": {"dir": art, "method": "rtn"},
        "verbose": False,
    }


def test_runner_imports_a_checkpoint_and_saves_qtpus_artifact(tmp_path):
    ckpt = _hf_checkpoint(tmp_path / "hf")
    config = _run_config(ckpt, str(tmp_path / "art"))
    bench = QuantizationBenchmark(dict(config, device="cpu"))
    bench.run_all_benchmarks()
    assert list(bench.results) == ["raw", "rtn"]
    assert all(r.is_success() for r in bench.results.values())
    assert bench.model_cfg.hidden_size == 128 and bench.tokenizer is None
    jbench = JaxBenchmark(dict(config, save_artifacts={"dir": str(tmp_path / "jart"),
                                                       "method": "rtn"}))
    jbench.run_all_benchmarks()
    for name in ("raw", "rtn"):
        a, b = bench.results[name].perplexity, jbench.results[name].perplexity
        assert math.isfinite(a) and abs(a / b - 1) < PPL_TOL, (name, a, b)
    # the two benchmarks' artifacts: the same files
    _same_files(tmp_path / "art", tmp_path / "jart")
    # which load in both packages, to params qtpu's forward runs
    pt, qt, mt = load_quantized(tmp_path / "art", device="cpu")
    assert mt == {"method": "rtn", "model": "my-local-llama", "w_bit": 4, "q_group_size": 64}
    _same_tree(pt, pack_model(bench.params, "rtn", config["quantization_config"]["rtn"])[0])
    pj, qj, _ = jax_load(tmp_path / "art")
    assert qj == qt
    cfg = jax_config_from_hf(ckpt)
    logits = jax_get_arch("llama").forward(pj, jnp.arange(16)[None], cfg, qmeta=qj)
    assert bool(jnp.all(jnp.isfinite(logits)))
    got = get_arch("llama").forward(pt, torch.arange(16)[None], bench.model_cfg, qmeta=qt)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=2e-2, atol=2e-2)


def test_runner_logs_a_failed_artifact_save_and_carries_on(tmp_path):
    """qtpu's rule: a failed save is logged, the results stand."""
    ckpt = _hf_checkpoint(tmp_path / "hf")
    blocker = tmp_path / "art"
    blocker.write_text("a file where the artifact's directory would go")
    bench = QuantizationBenchmark(dict(_run_config(ckpt, str(blocker)), device="cpu"))
    bench.run_all_benchmarks()  # the save's mkdir fails
    assert list(bench.results) == ["raw", "rtn"]
    assert all(r.is_success() for r in bench.results.values())
    assert blocker.is_file()


def test_runner_takes_the_arch_from_the_checkpoint(tmp_path):
    """A Mixtral checkpoint runs as a MoE model under a llama preset's name
    (raw and rtn, its artifact saved with [L, E, ...] expert leaves); a
    llama checkpoint passes under a MoE preset's name."""
    moe_ckpt = _hf_checkpoint(tmp_path / "mixtral", "mixtral")
    config = dict(_run_config(moe_ckpt, str(tmp_path / "art")), model_name="tiny-test",
                  device="cpu")
    # group 32: the checkpoint's experts are 96 wide
    bench = QuantizationBenchmark(dict(config, quantization_config={
        "rtn": {"w_bit": 4, "q_group_size": 32}}))
    bench.run_all_benchmarks()
    assert bench.model_cfg.arch == "moe" and list(bench.results) == ["raw", "rtn"]
    assert all(r.is_success() for r in bench.results.values())
    packed, qmeta, _ = load_quantized(str(tmp_path / "art"), device="cpu")
    assert tuple(packed["layers"]["exp_down"]["data"].shape[:2]) == (
        bench.model_cfg.num_layers, bench.model_cfg.num_experts)
    assert "exp_gate" in dict(qmeta) and "router" not in dict(qmeta)
    llama_ckpt = _hf_checkpoint(tmp_path / "llama")
    bench = QuantizationBenchmark(dict(config, model_name="tiny-moe-test",
                                       checkpoint_path=llama_ckpt))
    bench.setup()
    assert bench.model_cfg.arch == "llama" and bench.params["embed"].shape == (256, 128)
