"""K1's in-ball (sample, witness) pairs of the passes below the top a
cloud, in billions: the program's ``k1_inball_pairs_d<d>`` counters for d
under ``max_dimension`` summed, in the profiled clouds. Random mode runs
such a pass for every lower dimension; grid mode runs none. Together with
``k1_top_gpairs`` it is the record's ``k1_inball_pairs``. A program without
the counters gives nothing."""

from fbench.records import profiled


def read(ctx):
    top = int(ctx["config"]["max_dimension"])
    keys = [f"k1_inball_pairs_d{d}" for d in range(top)]
    vals = [sum(r["counters"].get(k, 0) for k in keys) for r in profiled(ctx)
            if any(k in r["counters"] for k in keys)]
    return sum(vals) / len(vals) * 1e-9 if vals else None
