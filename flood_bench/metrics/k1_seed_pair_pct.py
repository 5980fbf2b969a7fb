"""K1's in-ball pairs computed in its seed pass, in percent of all its
in-ball pairs: the program's ``k1_seed_pairs`` and ``k1_inball_pairs``
counters (K1's own stats, summed over its launches) in the profiled
clouds. The seed pass admits, for each (simplex, patch), the sub-chunks
whose box meets the patch's box before the rest of the list is tested, so
a share near 0 means it never engages. A program without the counter gives
nothing."""

from fbench.records import profiled


def read(ctx):
    runs = [r["counters"] for r in profiled(ctx)
            if "k1_seed_pairs" in r["counters"]]
    total = sum(c.get("k1_inball_pairs", 0) for c in runs)
    seed = sum(c["k1_seed_pairs"] for c in runs)
    return 100.0 * seed / total if total else None
