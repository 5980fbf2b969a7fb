"""K1's device time a cloud: the profiler's ``flood_min`` kernels."""

from fbench.trace import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx["profile"]["kernel_s"], "flood_min")
    return s / ctx["n_profiled"] * 1e3 if s > 0 else None
