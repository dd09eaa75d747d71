"""Where the port's compiled kernels live (port of qtpu/utils/compcache.py).

qtpu persists XLA executables across processes so that a restarted server
does not compile its program zoo again. The port's compiled programs are
the CUDA libraries that `kernels/_build.py` builds with nvcc (and the host
library of `qtpu_torch.native`): each is kept in the build directory under
a name that hashes its sources and flags, so a second process loads it
instead of building it. qtpu's switch keeps its meaning here:

  QTPU_COMPILE_CACHE unset   build/qtpu_torch/ at the root of the checkout
  QTPU_COMPILE_CACHE=<path>  that directory (or the cache_dir argument)
  QTPU_COMPILE_CACHE=off     (or 0, none) a fresh directory of this process
                             (under TMPDIR, removed at exit): nothing persists

The CUDA graphs the serving engine captures live in its process only.
ContinuousBatcher calls enable_compilation_cache(), as qtpu's does."""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

_fresh: list[Path] = []  # this process's directory when the cache is off


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel build at the directory QTPU_COMPILE_CACHE (or
    cache_dir) names. Returns the persistent directory, or None when the
    cache is off (builds then go to a directory of this process)."""
    from qtpu_torch.kernels import _build

    env = os.environ.get("QTPU_COMPILE_CACHE", "")
    if env.lower() in ("off", "0", "none"):
        if not _fresh:
            d = Path(tempfile.mkdtemp(prefix="qtpu_torch_build-"))
            atexit.register(shutil.rmtree, d, True)
            _fresh.append(d)
        _build.BUILD_DIR = _fresh[0]
        return None
    d = cache_dir or env
    _build.BUILD_DIR = Path(os.path.expanduser(d)).resolve() if d else _build.DEFAULT_BUILD_DIR
    return str(_build.BUILD_DIR)
