"""CUDA graphs of the engine's decode blocks.

qtpu runs a decode block as one compiled XLA program (`decode_multi`, a
jitted lax.scan); the port's counterpart is a CUDA graph captured from one
eager `decode_multi` call and replayed per block. A replay runs no Python,
so the wrappers' launch and route counters (`<wrapper>.launches`,
`.wgmma_launches`, ...) would miss its launches: `capture` records what the
capture added to each counter, takes it back (a capture launches nothing),
and `DecodeGraph.replay` adds it again on every replay.
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


class DecodeGraph:
    """A captured block: the graph, its static output and the counter deltas
    of one run of it."""

    def __init__(self, graph, out, delta):
        self.graph, self.out, self.delta = graph, out, delta

    def replay(self):
        """Replays the graph (no host synchronization) and counts its
        launches; returns the static output, valid until the next replay."""
        self.graph.replay()
        for (w, a), d in self.delta:
            setattr(w, a, getattr(w, a) + d)
        return self.out


def capture(fn, pool, generator=None) -> DecodeGraph:
    """Captures fn() (CUDA work on the current device, no host sync) into a
    graph that allocates from `pool`; `generator`, a CUDA torch.Generator
    that fn draws from, is registered so that each replay advances it and
    draws new numbers. A capture that fails raises."""
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
    return DecodeGraph(graph, out, delta)
