"""Host Delaunay a cloud: the program's ``delaunay`` stage."""


def read(ctx):
    vals = [st["delaunay"] for st in ctx["stages"] if "delaunay" in st]
    return sum(vals) / len(vals) * 1e3 if vals else None
