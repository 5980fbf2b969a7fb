"""Calls that found their engine in the program's cache, in percent of
the profiled clouds: the program's ``engine_cache_hit`` counter. Every
cloud of a stream is a new tensor, so a stream reads 0."""

from fbench.records import profiled


def read(ctx):
    runs = [r["counters"] for r in profiled(ctx)]
    if not runs:
        return None
    return 100.0 * sum(c.get("engine_cache_hit", 0) for c in runs) / len(runs)
