"""The engine's admitted (block, chunk) entries that fall on a chunk
holding a padding row, in percent of all it admitted: the program's
``k1_chunks_admitted_padded`` and ``k1_chunks_admitted`` counters in the
profiled clouds. It says how much of K1's admission still reaches the
padding; a program without the counters gives nothing."""

from fbench.records import profiled


def read(ctx):
    runs = [r["counters"] for r in profiled(ctx)]
    admitted = sum(c.get("k1_chunks_admitted", 0) for c in runs)
    padded = sum(c.get("k1_chunks_admitted_padded", 0) for c in runs)
    return 100.0 * padded / admitted if admitted else None
