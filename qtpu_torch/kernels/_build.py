"""Build the CUDA kernels of qtpu_torch/csrc at first use and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`. The build
directory is `build/qtpu_torch/` at the root of the checkout (QTPU_COMPILE_CACHE
moves it: qtpu_torch.utils.compcache); a library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Several sources build in
parallel, one `nvcc` process each (`build`); that of a source of
SPLIT_COMPILE runs its optimizer and ptxas over several threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qtpu_torch"
BUILD_DIR = DEFAULT_BUILD_DIR  # moved by qtpu_torch.utils.compcache (QTPU_COMPILE_CACHE)
SOURCES = ("dequant_matmul", "kv_attention", "fused_mlp", "flash_attention", "w8a8_matmul",
           "codebook_matmul", "moe_matmul", "kv_flash_decode", "layer_boundary")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# the attention sources, 32 instances a kernel and mode (one per head dim):
# nvcc's optimizer and ptxas over several threads (--split-compile=0), the
# same kernels' times at half the wall of one thread; the other sources
# keep the machine code they have without it
SPLIT_COMPILE = ("kv_attention", "kv_flash_decode", "flash_attention")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home) / "bin" / "nvcc"
        if home and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + (("--split-compile=0",) if name in SPLIT_COMPILE else ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, all at once.
    Returns {name: {"seconds", "cached", "ptxas"}}; raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        lib = _lib_path(name)
        if lib.is_file():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
        report[name] = {"seconds": secs, "cached": False, "ptxas": out}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-Wall")  # qtpu/native's


def host_compiler() -> str:
    """The host C++ compiler ($CXX, else g++ or c++); raises when there is none."""
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found")


def build_host(name: str) -> tuple[Path, tuple]:
    """The shared library of the host source csrc/<name>.cpp and the flags it
    was built with: HOST_FLAGS, or the same without -fopenmp where the
    compiler has no OpenMP runtime (the source's pragmas then compile to
    its serial loops, the same bytes). Built at first use to a temporary
    file of its own, then renamed, so that processes building it at once
    never load a half-written one. Raises with the compiler's output when
    no build succeeds."""
    src = CSRC / f"{name}.cpp"
    failed = []
    for flags in (HOST_FLAGS, tuple(f for f in HOST_FLAGS if f != "-fopenmp")):
        h = hashlib.sha256(" ".join(flags).encode())
        h.update(src.read_bytes())
        lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        if lib.is_file():
            return lib, flags
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        out = subprocess.run([host_compiler(), *flags, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if out.returncode == 0:
            os.replace(tmp, lib)
            return lib, flags
        os.unlink(tmp)
        failed.append(f"{' '.join(flags)}:\n{out.stdout}{out.stderr}")
    raise RuntimeError(f"{name}: host build failed\n" + "\n".join(failed))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.
    signatures: {C function: argtypes}; every function returns int."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.is_file():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def require(cond: bool, what: str) -> None:
    """Wrapper-side argument check: raise on what a kernel does not take."""
    if not cond:
        raise ValueError(what)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported an error."""
    if rc == -1:
        raise ValueError(f"{what}: arguments the kernel does not take")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L64 = ctypes.c_longlong
