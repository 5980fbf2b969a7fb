"""K1's sample slots run in 128-sample patches, each admitting its own
work, in percent of all the sample slots K1 ran: the program's
``k1_patch_samples`` and ``k1_samples`` counters in the profiled clouds.
It says how often K1 admits witness sub-chunks a patch at a time; a
program without the counters gives nothing."""

from fbench.records import profiled


def read(ctx):
    runs = [r["counters"] for r in profiled(ctx)]
    total = sum(c.get("k1_samples", 0) for c in runs)
    patch = sum(c.get("k1_patch_samples", 0) for c in runs)
    return 100.0 * patch / total if total else None
