#!/usr/bin/env python3
"""Where a cell's clouds spend their time, by the program's spans.

    python3 flood_bench/span_run.py --workload <cell> --seed <n> \\
        [--clouds 3] [--fenced 0]

From the root of a checkout, on the card: warms up on one cloud, runs
``--fenced`` clouds with the program's fenced stage lines and then
``--clouds`` clouds under ``torch.profiler`` (each in a ``cloud`` span,
as the traced run's phases do), and prints one JSON line: the host,
device and idle seconds a profiled cloud by program span
(``fbench.spans``), the wall seconds of each cloud, the host clock around
each cloud's persistence, and the program's record of each cloud (its
mode, counters and stage seconds). It checks no answer and is no
benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--clouds", type=int, default=3)
    ap.add_argument("--fenced", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from fbench import cell, layout
    from fbench.spans import reduce_spans

    bench = layout.load_benchmark(ROOT)
    c = layout.find_cell(bench, args.workload)
    config = layout.load_config(ROOT, bench, c["config"])
    traffic = cell.check_traffic(layout.load_traffic(c["traffic"]))
    stream = cell.Stream(config, traffic, args.seed, "cuda:0")
    stream.run(0)
    runs = []

    def run(idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = stream.run(idx)
        runs.append({"index": idx, "wall_s": time.perf_counter() - t0,
                     "persistence_s": r["persistence_s"]})

    stream.stagetimer.ENABLED = True
    try:
        for idx in range(1, args.fenced + 1):
            run(idx)
    finally:
        stream.stagetimer.ENABLED = False
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    first = args.fenced + 1
    with torch.profiler.profile(activities=acts) as prof:
        for idx in range(first, first + args.clouds):
            with torch.profiler.record_function("cloud"):
                run(idx)
    events = prof.profiler.kineto_results.events()
    clouds = [e for e in events if e.name() == "cloud"
              and str(e.device_type()).endswith("CPU")]
    window = (min(int(e.start_ns()) for e in clouds),
              max(int(e.start_ns()) + int(e.duration_ns()) for e in clouds))
    red = reduce_spans(events, window)
    per_cloud = {k: {n: s / args.clouds for n, s in v.items()}
                 for k, v in red.items()}
    records = stream.stagetimer.records()[-len(runs):]
    for r, rec in zip(runs, records):
        r.update(rec)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "window_s": (window[1] - window[0]) * 1e-9,
        "per_cloud": per_cloud, "clouds": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
