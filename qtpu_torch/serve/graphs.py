"""CUDA graphs of the engine's decode blocks and prefill buckets.

qtpu runs a decode block as one compiled XLA program (`decode_multi`, a
jitted lax.scan) and an admission as one program per bucket shape; the
port's counterpart is a CUDA graph captured from one eager call (a
`decode_multi` block, a (P, Tb) prefill with its sampler) and replayed. A
replay runs no Python, so the wrappers' launch and route counters
(`<wrapper>.launches`, `.wgmma_launches`, ...) would miss its launches:
`capture` records what the capture added to each counter, takes it back (a
capture launches nothing), and `CapturedGraph.replay` adds it again on
every replay.
"""

from __future__ import annotations

import importlib
import pkgutil
from functools import lru_cache


@lru_cache(maxsize=None)
def counter_cells() -> tuple:
    """(wrapper, attribute) of every launch and route counter of the kernel
    wrappers in qtpu_torch.kernels: the int attributes named `launches` or
    `*_launches`, each wrapper once."""
    import qtpu_torch.kernels as pkg

    cells, seen = [], set()
    for info in sorted(pkgutil.iter_modules(pkg.__path__), key=lambda m: m.name):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for obj in vars(mod).values():
            if not callable(obj) or id(obj) in seen or not hasattr(obj, "__dict__"):
                continue
            seen.add(id(obj))
            cells += [(obj, a) for a, v in sorted(vars(obj).items())
                      if a.endswith("launches") and type(v) is int]
    return tuple(cells)


def counter_snapshot() -> list:
    return [getattr(w, a) for w, a in counter_cells()]


def _restore(values) -> None:
    for (w, a), v in zip(counter_cells(), values):
        setattr(w, a, v)


class CapturedGraph:
    """A captured decode block or prefill bucket: the graph, its static
    output and the counter deltas of one run of it."""

    def __init__(self, graph, out, delta):
        self.graph, self.out, self.delta = graph, out, delta

    def replay(self):
        """Replays the graph (no host synchronization) and counts its
        launches; returns the static output, valid until the next replay."""
        self.graph.replay()
        for (w, a), d in self.delta:
            setattr(w, a, getattr(w, a) + d)
        return self.out


def capture(fn, pool, generator=None) -> CapturedGraph:
    """Captures fn() (CUDA work on the current device, no host sync) into a
    graph that allocates from `pool`; `generator`, a CUDA torch.Generator
    that fn draws from, is registered so that each replay advances it and
    draws new numbers. A capture that fails raises. torch.cuda.graph
    empties the allocator's cache before each capture, which a large
    prefill bucket needs: captured without it, long_ctx's buckets at S
    32768 ran the card out of memory."""
    import torch

    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = counter_snapshot()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    finally:
        after = counter_snapshot()
        _restore(before)
    delta = tuple((cell, b - a) for cell, a, b in zip(counter_cells(), before, after) if b != a)
    return CapturedGraph(graph, out, delta)


def kernel_nodes(graph, dump_to=None) -> list:
    """The names of the kernel nodes of a captured torch.cuda.CUDAGraph made
    with keep_graph=True, one per launch captured (C++ names demangled),
    from the driver's DOT print of the graph (cuGraphDebugDotPrint,
    verbose). For counting launches without the profiler: a captured graph
    holds every launch as a node. dump_to: also keep the DOT file there."""
    import ctypes
    import os
    import re
    import shutil
    import tempfile

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        rc = cuda.cuGraphDebugDotPrint(graph.raw_cuda_graph(), path.encode(), 1)
        if rc != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint: CUDA driver error {rc}")
        if dump_to is not None:
            shutil.copy(path, dump_to)
        with open(path) as f:
            dot = f.read()
    names = []
    for chunk in re.split(r'"[^"\n]*node_\d+"\s*\[', dot)[1:]:
        if "KERNEL" not in chunk:
            continue
        # the label's ID record: {ID | <id> (topoId: <n>) | <symbol>\<\<\<grid,block,smem\>\>\>}
        field = re.search(r"\{ID \|[^|]*\| *([^|\n]+)", chunk)
        name = field.group(1).split("\\<\\<\\<")[0].strip() if field else chunk[:200]
        names.append(_demangle(name) if name.startswith("_Z") else name)
    return names


def _demangle(name: str) -> str:
    """A C++ symbol demangled by libstdc++'s __cxa_demangle (as it is when
    it does not demangle)."""
    import ctypes

    fn = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(-1)
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        libc = ctypes.CDLL(None)
        libc.free.argtypes = [ctypes.c_void_p]
        libc.free(ptr)
