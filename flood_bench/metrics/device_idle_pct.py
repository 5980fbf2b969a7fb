"""The device's idle share of the profiled clouds' window (no fences)."""


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
