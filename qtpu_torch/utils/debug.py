"""Numerical safety checks for debugging (port of qtpu/utils/debug.py).

  - assert_all_finite: a host-side check of a nested dict / list / tuple of
    tensors, naming the first non-finite leaf by qtpu's path syntax
  - checked(fn): fn with every floating output of every operation inside it
    checked for NaN / Inf, as qtpu's checkify float_checks do inside a
    traced function (not only fn's outputs)
  - debug_nans(enable): the same check switched on or off for a scope

The operation check is a TorchDispatchMode: it sees the ATen operations
that PyTorch runs. A hand-written kernel called through ctypes writes into
a tensor that PyTorch allocated and does not pass through the dispatcher,
so its output is checked by the PyTorch operation that next reads it. Each
check reads its result back to the host, so a checked function runs
synchronously and cannot be captured into a CUDA graph.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_checking: ContextVar[bool] = ContextVar("qtpu_torch_debug_nans", default=False)


def _leaves_with_paths(tree, path=""):
    """(path, leaf) in the order jax.tree_util flattens the same tree: dict
    keys sorted, path as jax.tree_util.keystr gives it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves_with_paths(t, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
        return bool(np.isfinite(leaf).all())
    return True


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise AssertionError naming the first non-finite floating leaf."""
    for path, leaf in _leaves_with_paths(tree):
        if not _finite(leaf):
            raise AssertionError(f"non-finite values in {name}{path}")


# operations that hand out memory without computing it: what they return
# is whatever the allocator held, and is checked by the operation that
# writes it or the one that reads it next
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "set_")


class _FiniteCheck(TorchDispatchMode):
    """Raises FloatingPointError when an operation's floating output holds
    a NaN or an Inf, while the scope's check is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _checking.get() and func.overloadpacket.__name__ not in _UNINITIALIZED:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() \
                        and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(f"non-finite values made by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scope-local NaN / Inf check of every PyTorch operation (qtpu's
    jax_debug_nans switch); the previous setting is restored on exit."""
    token = _checking.set(enable)
    try:
        with _FiniteCheck():
            yield
    finally:
        _checking.reset(token)


def checked(fn):
    """fn wrapped so that a NaN or Inf made by any operation inside it
    raises FloatingPointError when it is called."""

    def wrapper(*args, **kw):
        with debug_nans(True):
            return fn(*args, **kw)

    return wrapper
