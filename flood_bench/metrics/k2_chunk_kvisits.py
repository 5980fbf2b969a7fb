"""K2's chunk visits a cloud, in thousands: the program's
``k2_chunk_visits`` counter (the FPS kernel's own count) in the profiled
clouds. It tells a K2 that does less work apart from one that does the
same work faster."""

from fbench.records import profiled


def read(ctx):
    vals = [r["counters"]["k2_chunk_visits"] for r in profiled(ctx)
            if "k2_chunk_visits" in r["counters"]]
    return sum(vals) / len(vals) * 1e-3 if vals else None
