"""K1's in-ball (sample, witness) pairs a cloud, in billions: the
program's ``k1_inball_pairs`` counter (K1's own stats, summed over its
launches) in the profiled clouds. It tells a K1 that does less work apart
from one that does the same work faster."""

from fbench.records import profiled


def read(ctx):
    vals = [r["counters"]["k1_inball_pairs"] for r in profiled(ctx)
            if "k1_inball_pairs" in r["counters"]]
    return sum(vals) / len(vals) * 1e-9 if vals else None
