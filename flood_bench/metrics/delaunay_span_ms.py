"""Host Delaunay a cloud with no fences: the program's ``delaunay`` span
in the profiled clouds."""

from fbench.records import stage_ms


def read(ctx):
    return stage_ms(ctx, lambda k: k == "delaunay")
