"""K1's in-ball (sample, witness) pairs of the top pass a cloud, in
billions: the program's ``k1_inball_pairs_d<max_dimension>`` counter (K1's
own stats of that pass) in the profiled clouds. In random mode every
dimension runs a pass of its own; this is the pass of the top simplices.
A program without the counter gives nothing."""

from fbench.records import profiled


def read(ctx):
    key = f"k1_inball_pairs_d{int(ctx['config']['max_dimension'])}"
    vals = [r["counters"][key] for r in profiled(ctx) if key in r["counters"]]
    return sum(vals) / len(vals) * 1e-9 if vals else None
