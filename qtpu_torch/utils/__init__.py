"""Host utilities of the port (qtpu/utils): fenced timers and profiler
traces, finite checks, and the kernels' build directory."""

from qtpu_torch.utils.timing import Timer, timed  # noqa: F401
