"""The engine's set-up a cloud (padding, k-d order, boxes): the
program's fenced ``engine-init`` stage."""


def read(ctx):
    vals = [st["engine-init"] for st in ctx["stages"] if "engine-init" in st]
    return sum(vals) / len(vals) * 1e3 if vals else None
