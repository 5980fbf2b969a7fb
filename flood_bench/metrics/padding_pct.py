"""Padded witnesses beyond the real ones, in percent of the real ones:
the program's ``witnesses_padded`` and ``witnesses_real`` counters in the
profiled clouds."""

from fbench.records import profiled


def read(ctx):
    runs = [r["counters"] for r in profiled(ctx)]
    real = sum(c.get("witnesses_real", 0) for c in runs)
    padded = sum(c.get("witnesses_padded", 0) for c in runs)
    return 100.0 * (padded - real) / real if real else None
