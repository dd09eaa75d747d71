"""Fenced device timing and profiler traces (port of qtpu/utils/timing.py).

PyTorch's CUDA calls return before the device finishes, so a host clock
around them measures the enqueue. These timers synchronize the CUDA
devices of what they are given before reading the clock; `Timer` also
records CUDA events at its fences, for the device's own time of the span.
`profile_trace` is a torch.profiler session over CPU and (where there is a
card) CUDA activity that writes a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nested dict / list / tuple (a
    torch.device, or True for the current one, names a device itself)."""
    if tree is True:
        return {torch.device("cuda", torch.cuda.current_device())} if torch.cuda.is_available() else set()
    if isinstance(tree, torch.device):
        return {tree} if tree.type == "cuda" else set()
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree)) if tree else set()
    return set()


def fence(tree) -> None:
    """Wait until the CUDA devices of `tree`'s tensors have finished their
    queued work (nothing for CPU tensors)."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer that fences device work on enter and exit. `fence`:
    tensors (any nesting), a device, or True for the current CUDA device.
    `elapsed` is the host seconds between the fences; on a CUDA device
    `device_elapsed` is the seconds between CUDA events recorded at them
    (None otherwise)."""

    def __init__(self, fence=None):
        self.fence = fence
        self.elapsed = 0.0
        self.device_elapsed = None

    def __enter__(self):
        devs = _cuda_devices(self.fence)
        self._events = None
        if devs:
            dev = min(devs, key=lambda d: d.index or 0)
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._dev = dev
        fence(self.fence)
        if self._events:
            self._events[0].record(torch.cuda.current_stream(self._dev))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._events:
            self._events[1].record(torch.cuda.current_stream(self._dev))
        fence(self.fence)
        self.elapsed = time.perf_counter() - self._t0
        if self._events:
            self.device_elapsed = self._events[0].elapsed_time(self._events[1]) / 1e3
        return False


def timed(fn, *args, warmup: int = 1, iters: int = 5, **kw):
    """Best-of-iters latency of fn(*args, **kw), after `warmup` calls (at
    least one: kernel builds and first launches), each call fenced on the
    devices of its result. Returns (best_seconds, last_result)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kw)
        fence(result)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        fence(result)
        best = min(best, time.perf_counter() - t0)
    return best, result


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for t in items:
        leaf = _first_tensor(t)
        if leaf is not None:
            return leaf
    return None


def timed_chain(step_fn, state, iters: int = 8, repeats: int = 2):
    """Seconds per iteration of a data-dependent chain state_{k+1} =
    step_fn(state_k), ended by a host readback of the first tensor of the
    state (which waits for the whole chain); an N = 1 run is subtracted
    from an N = iters run to cancel the readback and launch overheads.
    step_fn must return a state whose tensors depend on the previous one."""

    def run(n):
        s = state
        t0 = time.perf_counter()
        for _ in range(n):
            s = step_fn(s)
        float(_first_tensor(s).float().sum())  # host readback: a real fence
        return time.perf_counter() - t0

    run(1)
    run(iters)
    best = float("inf")
    for _ in range(repeats):
        t1 = run(1)
        tn = run(iters)
        best = min(best, (tn - t1) / (iters - 1))
    return best


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler session over the block (CPU activity, and CUDA
    activity where a card is present) that writes its Chrome trace to
    `log_dir`/trace-<pid>-<ns>.json. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
