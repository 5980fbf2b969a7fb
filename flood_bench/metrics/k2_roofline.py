"""K2's share of its roofline: the least time of the profiled clouds'
FPS runs (``counts.k2_bound_s`` on the reference's count of falling
minima) over K2's device time on them."""

from fbench.counts import k2_bound_s
from fbench.trace import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx["profile"]["kernel_s"], "fps_loop")
    if s <= 0 or not ctx["k2_updates"]:
        return None
    dim = int(ctx["config"]["dim"])
    bound = sum(k2_bound_s(u, dim) for u in ctx["k2_updates"])
    return 100.0 * bound / s
