"""K2's device time a cloud: the profiler's ``fps_loop`` kernels."""

from fbench.trace import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx["profile"]["kernel_s"], "fps_loop")
    return s / ctx["n_profiled"] * 1e3 if s > 0 else None
