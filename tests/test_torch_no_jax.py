"""The port imports nothing of the JAX package: every module of qtpu_torch
(found by walking the package, the bench's extra, graft and scaling among
them) imports in a fresh interpreter in which a meta-path finder refuses
jax, qtpu, bench_extra and __graft_entry__."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import qtpu_torch

ROOT = Path(qtpu_torch.__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "qtpu", "bench_extra", "__graft_entry__")

CHILD = """
import importlib, importlib.abc, sys
blocked = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in sys.argv[2].split(","):
    importlib.import_module(name)
print("imported", len(sys.argv[2].split(",")))
"""


def _modules():
    names = ["qtpu_torch"]
    for info in pkgutil.walk_packages(qtpu_torch.__path__, "qtpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_qtpu():
    names = _modules()
    for must in ("qtpu_torch.bench.extra", "qtpu_torch.bench.graft", "qtpu_torch.bench.scaling",
                 "qtpu_torch.bench.__main__", "qtpu_torch.serve.__main__"):
        assert must in names
    r = subprocess.run([sys.executable, "-c", CHILD, ",".join(BLOCKED), ",".join(names)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == f"imported {len(names)}"


def test_the_finder_refuses_the_jax_package():
    r = subprocess.run([sys.executable, "-c", CHILD, ",".join(BLOCKED), "qtpu.models"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "the port imported qtpu" in r.stderr
