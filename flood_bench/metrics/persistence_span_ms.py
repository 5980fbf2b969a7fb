"""Persistence a cloud with no fences: the program's ``persistence`` span
(``SimplexTree.compute_persistence``) in the profiled clouds."""

from fbench.records import stage_ms


def read(ctx):
    return stage_ms(ctx, lambda k: k == "persistence")
