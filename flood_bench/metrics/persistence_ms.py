"""Persistence a cloud: the host clock around ``st.persistence()`` in the
stage phase."""


def read(ctx):
    vals = ctx["persistence_s"]
    return sum(vals) / len(vals) * 1e3 if vals else None
