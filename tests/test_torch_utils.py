"""qtpu_torch.utils (timing, debug, compcache) and the benchmark's
profile_dir on the CPU, against qtpu.utils where the two can be held side
by side: assert_all_finite's messages, checked() raising on a NaN or a
division by zero made inside a function, and the QTPU_COMPILE_CACHE
switch (off, a path, the default)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.utils import compcache as jcompcache
from qtpu.utils import debug as jdebug
from qtpu_torch.kernels import _build
from qtpu_torch.utils import compcache, debug, timing


def _trees():
    """(name, numpy tree) pairs: clean trees and trees with one NaN or Inf
    in a nested dict, a list, a tuple, a bf16-able leaf; integer leaves are
    not checked."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    base = lambda: {"layers": {"q_proj": {"scales": f(4, 3), "data": np.arange(6, dtype=np.int8)},
                               "o_proj": [f(2), f(3, 2)]},
                    "embed": f(5, 4), "pair": (f(2), np.ones(3, np.int32))}
    cases = [("clean", base())]
    for where in ("scales", "o_proj1", "embed", "pair0", "two"):
        t = base()
        if where == "scales":
            t["layers"]["q_proj"]["scales"][1, 2] = np.nan
        elif where == "o_proj1":
            t["layers"]["o_proj"][1][0, 1] = np.inf
        elif where == "embed":
            t["embed"][0, 0] = -np.inf
        elif where == "pair0":
            t["pair"][0][1] = np.nan
        else:  # two leaves: the first in jax's flatten order (sorted keys) is named
            t["layers"]["q_proj"]["scales"][0, 0] = np.nan
            t["embed"][2, 1] = np.nan
        cases.append((where, t))
    return cases


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_torch_tree(v) for v in t)
    return torch.from_numpy(t)


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_jax_tree(v) for v in t)
    return jnp.asarray(t)


def _message(fn, tree):
    try:
        fn(tree, "params")
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(6))
def test_assert_all_finite_messages_equal_qtpus(case):
    name, tree = _trees()[case]
    want = _message(jdebug.assert_all_finite, _jax_tree(tree))
    got = _message(debug.assert_all_finite, _torch_tree(tree))
    assert got == want
    assert (got is None) == (name == "clean")
    if name == "scales":
        assert got == "non-finite values in params['layers']['q_proj']['scales']"
    bf16 = {k: v for k, v in _torch_tree(tree).items() if k == "embed"}
    bf16["embed"] = bf16["embed"].bfloat16()
    got16 = _message(debug.assert_all_finite, bf16)
    assert (got16 is None) == (name not in ("embed", "two"))


# (name, qtpu's function, the port's, input): each makes its NaN or Inf inside
INNER = [
    ("nan_inside", lambda x: jnp.where(jnp.isnan(jnp.log(x)), 0.0, x),
     lambda x: torch.where(torch.isnan(torch.log(x)), 0.0, x), -np.ones(4, np.float32)),
    ("div_by_zero_inside", lambda x: jnp.where(jnp.isinf(1.0 / x), 0.0, x),
     lambda x: torch.where(torch.isinf(1.0 / x), 0.0, x), np.array([1.0, 0.0, 2.0], np.float32)),
    ("nan_in", lambda x: x * 2.0, lambda x: x * 2.0, np.array([1.0, np.nan], np.float32)),
    ("clean", lambda x: jnp.tanh(x) @ jnp.ones((3, 2)), lambda x: torch.tanh(x) @ torch.ones(3, 2),
     np.arange(6, dtype=np.float32).reshape(2, 3)),
    ("clean_log", lambda x: jnp.log(x) + 1.0, lambda x: torch.log(x) + 1.0,
     np.array([1.0, 3.0], np.float32)),
]


@pytest.mark.parametrize("case", [c[0] for c in INNER])
def test_checked_raises_where_qtpus_raises(case):
    """The outputs of all three are finite where a value made inside is not:
    qtpu's checkify float checks raise, and so does the port's checked()."""
    _, jfn, tfn, x = next(c for c in INNER if c[0] == case)
    try:
        want = np.asarray(jdebug.checked(jfn)(jnp.asarray(x)))
        jraised = False
    except Exception as e:  # checkify.JaxRuntimeError
        jraised = "nan" in str(e) or "division by zero" in str(e)
        assert jraised, e
    if jraised:
        with pytest.raises(FloatingPointError, match="non-finite values made by"):
            debug.checked(tfn)(torch.from_numpy(x))
    else:
        got = debug.checked(tfn)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (case.startswith("clean")) != jraised
    tfn(torch.from_numpy(x))  # unchecked, nothing raises


def test_debug_nans_scopes_and_restores():
    x = -torch.ones(3)
    torch.log(x)
    with debug.debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(x)
        with debug.debug_nans(False):
            assert bool(torch.isnan(torch.log(x)).all())
        with pytest.raises(FloatingPointError):
            torch.sqrt(x)
        buf = torch.empty(4096)  # uninitialized memory is not a value made: not checked
        with pytest.raises(FloatingPointError):
            buf.fill_(float("inf"))
    assert bool(torch.isnan(torch.log(x)).all())  # restored: off


def test_timers_on_the_cpu():
    a = torch.randn(64, 64)
    with timing.Timer(a) as t:
        b = a @ a
    assert t.elapsed > 0 and t.device_elapsed is None  # no CUDA device: no events
    best, out = timing.timed(lambda m: m @ m, a, iters=3)
    assert best > 0 and torch.equal(out, a @ a)
    per = timing.timed_chain(lambda s: {"x": s["x"] @ b * 1e-3}, {"x": a}, iters=4)
    assert per > -1.0  # a differenced time; noise may make a tiny chain's negative
    assert timing._cuda_devices({"a": [a, (b,)], "d": torch.device("cpu")}) == set()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "tr")) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert prof is not None
    files = list((tmp_path / "tr").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_bench_profile_dir_writes_a_trace(tmp_path):
    """profile_dir is accepted (qtpu's option) and each perplexity eval of
    the run writes a Chrome trace there."""
    from qtpu_torch.bench import QuantizationBenchmark

    cfg = {"model_name": "tiny-test", "quantization_methods": ["rtn"],
           "calibration_dataset": "synthetic", "test_dataset": "synthetic",
           "n_calibration_samples": 2, "calibration_block_size": 32, "n_test_samples": 2,
           "test_block_size": 32, "quantization_config": {"rtn": {"w_bit": 4, "q_group_size": 64}},
           "packed_eval": True, "serving": {"benchmark": False}, "verbose": False,
           "device": "cpu", "profile_dir": str(tmp_path / "prof")}
    bench = QuantizationBenchmark(cfg)
    bench.run_all_benchmarks()
    assert all(r.is_success() for r in bench.results.values())
    files = sorted((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 3  # raw, rtn, rtn packed
    names = {e.get("name") for e in json.loads(files[-1].read_text())["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


@pytest.fixture
def build_dir(monkeypatch):
    """Restores the kernels' build directory after a test moves it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("QTPU_COMPILE_CACHE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("off", ["off", "0", "none", "OFF"])
def test_compile_cache_off_builds_into_a_fresh_process_dir(build_dir, off):
    build_dir.setenv("QTPU_COMPILE_CACHE", off)
    assert compcache.enable_compilation_cache() is None
    assert jcompcache.enable_compilation_cache() is None  # qtpu's: off, too
    d = _build.BUILD_DIR
    assert d != _build.DEFAULT_BUILD_DIR and d.is_dir() and not any(d.iterdir())
    assert compcache.enable_compilation_cache() is None and _build.BUILD_DIR == d  # one a process


def test_compile_cache_path_and_default(build_dir, tmp_path):
    build_dir.setenv("QTPU_COMPILE_CACHE", str(tmp_path / "cc"))
    assert compcache.enable_compilation_cache() == str(tmp_path / "cc")
    assert _build.BUILD_DIR == tmp_path / "cc"
    assert compcache.enable_compilation_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    lib, _ = _build.build_host("qtpu_native")  # a build lands in the relocated directory
    assert lib.parent == tmp_path / "arg" and lib.is_file()
    assert not list((tmp_path / "arg").glob("*.tmp"))
    build_dir.delenv("QTPU_COMPILE_CACHE")
    assert compcache.enable_compilation_cache() == str(_build.DEFAULT_BUILD_DIR)
    assert _build.DEFAULT_BUILD_DIR == Path(_build.__file__).resolve().parents[2] / "build" / "qtpu_torch"


def test_the_engine_applies_the_switch(build_dir, tmp_path):
    """ContinuousBatcher.__init__ calls enable_compilation_cache(), as qtpu's."""
    from qtpu_torch.models import TINY_TEST
    from qtpu_torch.serve.batching import ContinuousBatcher

    build_dir.setenv("QTPU_COMPILE_CACHE", str(tmp_path / "eng"))
    ContinuousBatcher({}, TINY_TEST, max_batch=1, max_seq_len=16, device="cpu")
    assert _build.BUILD_DIR == tmp_path / "eng"


def test_off_in_a_process_of_its_own_leaves_nothing():
    """With the cache off a process builds into its own directory, and the
    directory is gone when the process exits."""
    code = ("from qtpu_torch.utils.compcache import enable_compilation_cache\n"
            "from qtpu_torch.kernels import _build\n"
            "enable_compilation_cache()\n"
            "print(_build.build_host('qtpu_native')[0])\n")
    env = dict(os.environ, QTPU_COMPILE_CACHE="off")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=Path(_build.__file__).resolve().parents[2])
    assert out.returncode == 0, out.stderr
    lib = Path(out.stdout.strip().splitlines()[-1])
    assert lib.name.startswith("libqtpu_native-") and not lib.parent.exists()
