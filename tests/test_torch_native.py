"""qtpu_torch.native (csrc/qtpu_native.cpp built by kernels/_build.py) on
the CPU: its bytes equal qtpu's qtpu.native and the port's own packers
(qtpu_torch.core.packing, qtpu_torch.data.pipeline.block_pack), its numpy
fallback gives the same, and processes building it at once each load a
whole library. qtpu's library is built by `qtpu_library` into a directory
of this test process's own, so the comparison never depends on another
process's in-place `make` of qtpu/native."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qtpu import native as jnative
from qtpu_torch import native
from qtpu_torch.core import packing
from qtpu_torch.data import pipeline
from qtpu_torch.kernels import _build

# TinyLlama-1.1B's site widths (K, N), K cut to 256 rows (two groups of 128)
SITES = [(256, 2048), (256, 256), (256, 5632), (256, 2048)]
# qtpu/native/Makefile's CXXFLAGS
QTPU_NATIVE_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-Wall")


@pytest.fixture(scope="session")
def _qtpu_native_so(tmp_path_factory):
    """qtpu's unchanged qtpu/native/qtpu_native.cpp built with its Makefile's
    flags into a temporary file of this process's own, renamed into place:
    qtpu's loader runs `make` in its package directory, which several test
    processes may do at once, and a process that loads the file while
    another writes it takes qtpu's numpy fallback without a word."""
    src = Path(jnative.__file__).with_name("qtpu_native.cpp")
    out = tmp_path_factory.mktemp("qtpu_native") / "libqtpu_native.so"
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    r = subprocess.run([_build.host_compiler(), *QTPU_NATIVE_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"qtpu's native library did not build:\n{r.stderr}"
    os.replace(tmp, out)
    return out


@pytest.fixture
def qtpu_library(_qtpu_native_so, monkeypatch):
    """qtpu.native loaded from _qtpu_native_so as qtpu's own loader loads
    it (the same checks), for this test only. It fails where the library
    does not load; it never skips."""
    lib = ctypes.CDLL(str(_qtpu_native_so))
    lib.qtpu_version.restype = ctypes.c_int
    lib.qtpu_block_pack.restype = ctypes.c_int64
    assert lib.qtpu_version() == 1
    monkeypatch.setattr(jnative, "_lib", lib)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.available()
    return lib


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """Both paths of the module: the built library, and the numpy fallback
    a machine without a host compiler takes."""
    assert native.available()  # the library builds here (g++)
    if request.param == "fallback":
        monkeypatch.setattr(native, "_lib", None)
    return request.param


@pytest.mark.parametrize("g", [32, 64, 128])
def test_pack_int4_bytes_equal(path, g, qtpu_library):
    q = np.random.default_rng(g).integers(0, 16, (256, 96), dtype=np.uint8)
    got = native.pack_int4(q, g)
    assert got.dtype == np.int8 and got.shape == (128, 96)
    np.testing.assert_array_equal(got, jnative.pack_int4(q, g))
    np.testing.assert_array_equal(got, packing.pack_int4(torch.from_numpy(q), g).numpy())
    back = native.unpack_int4(got, g)
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(back, jnative.unpack_int4(got, g))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("site", range(len(SITES)))
def test_quantize_pack_bytes_equal(path, bits, site, qtpu_library):
    K, N = SITES[site]
    w = (np.random.default_rng(site).standard_normal((K, N)) * 0.02).astype(np.float32)
    data, scales, zeros = native.quantize_pack(w, bits, 128)
    qt = packing.quantize_pack(torch.from_numpy(w), bits, 128)
    np.testing.assert_array_equal(data, qt.data.numpy())
    np.testing.assert_array_equal(zeros, qt.zeros.numpy())
    # the port keeps bf16 scales: the native f32 scales round to exactly them
    assert torch.equal(torch.from_numpy(scales).bfloat16(), qt.scales)
    jd, js, jz = jnative.quantize_pack(w, bits, 128)
    np.testing.assert_array_equal(data, jd)
    np.testing.assert_array_equal(zeros, jz)
    if path == "native":  # qtpu's native packer keeps the same f32 scales
        np.testing.assert_array_equal(scales, js)


def test_block_pack_equals_the_numpy_packer(path, qtpu_library):
    rng = np.random.default_rng(3)
    samples = [rng.integers(0, 32000, size=n, dtype=np.int32) for n in (5, 170, 40, 3, 999)]
    for block in (16, 128, 2048):
        got = native.block_pack(samples, block)
        want = pipeline.block_pack(samples, block)
        assert len(got) == len(want) == sum(s.size for s in samples) // block
        for a, b, c in zip(got, want, jnative.block_pack(samples, block)):
            assert a.shape == (1, block) and a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="group_size"):
        native.pack_int4(np.zeros((100, 4), np.uint8), 64)
    with pytest.raises(ValueError, match="group_size"):
        native.quantize_pack(np.zeros((128, 4), np.float32), 4, 48)
    with pytest.raises(ValueError, match="bits"):
        native.quantize_pack(np.zeros((128, 4), np.float32), 2, 64)


def test_processes_building_at_once_load_a_whole_library(tmp_path):
    """Four processes build the library into one empty directory at the same
    time: each writes a temporary file of its own and renames it, so every
    one loads a whole library and one file is left."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from qtpu_torch.kernels import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "from qtpu_torch import native\n"
            "assert native.available()\n"
            "import numpy as np\n"
            "q = np.arange(64 * 8, dtype=np.uint8).reshape(64, 8) % 16\n"
            "assert (native.unpack_int4(native.pack_int4(q, 64), 64) == q).all()\n")
    root = Path(_build.__file__).resolve().parents[2]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert [f.name.startswith("libqtpu_native-") for f in tmp_path.iterdir()] == [True]


def _compiler(tmp_path, refuse_openmp: bool):
    """A host compiler script: g++ itself, but failing as a compiler without
    an OpenMP runtime does when -fopenmp is asked (refuse_openmp), or
    failing on every build."""
    script = tmp_path / "cxx"
    gxx = _build.host_compiler()
    body = (f'case " $* " in *" -fopenmp "*) '
            f'echo "fatal error: cannot read spec file libgomp.spec" >&2; exit 1;; esac\n'
            f'exec {gxx} "$@"\n') if refuse_openmp else 'echo "no" >&2; exit 1\n'
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_a_compiler_without_openmp_builds_the_serial_loops(tmp_path, monkeypatch):
    """Where the compiler has no OpenMP runtime the library builds without
    -fopenmp (its pragmas then leave the serial loops): the same bytes."""
    monkeypatch.setenv("CXX", _compiler(tmp_path, refuse_openmp=True))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_built", None)
    path, flags = native.build_info()
    assert "-fopenmp" not in flags and Path(path).parent == tmp_path / "build"
    w = (np.random.default_rng(5).standard_normal((256, 384)) * 0.02).astype(np.float32)
    data, scales, zeros = native.quantize_pack(w, 4, 128)
    qt = packing.quantize_pack(torch.from_numpy(w), 4, 128)
    np.testing.assert_array_equal(data, qt.data.numpy())
    np.testing.assert_array_equal(zeros, qt.zeros.numpy())


def test_a_failed_build_raises_where_a_compiler_is(tmp_path, monkeypatch):
    """The numpy fallback is for a machine without a host compiler; a
    compiler that fails raises with its output."""
    monkeypatch.setenv("CXX", _compiler(tmp_path, refuse_openmp=False))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_built", None)
    with pytest.raises(RuntimeError, match="host build failed"):
        native.available()
