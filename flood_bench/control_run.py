#!/usr/bin/env python3
"""The readings that set the limits of ``fbench.compare``, on the chip, at
a cell's own size.

    python3 flood_bench/control_run.py --workload <cell> --seeds 1 2 3

For each seed, cloud 1 of the stream: the program's readings (the cell's
entry, checked as a run checks it) and the control's (the reference in
bfloat16 in the program's place). One JSON line a seed.
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="run the control on the first N seeds only")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from fbench import compare, control, layout
    from fbench.cell import Stream, _values, check_traffic

    bench = layout.load_benchmark(ROOT)
    cell = layout.find_cell(bench, args.workload)
    cfg = layout.load_config(ROOT, bench, cell["config"])
    traffic = check_traffic(layout.load_traffic(cell["traffic"]))
    per_dim = int(traffic["check"]["simplices_per_dim"])
    n_control = len(args.seeds) if args.control is None else args.control
    for i, seed in enumerate(args.seeds):
        stream = Stream(cfg, traffic, seed, "cuda:0")
        row = {"workload": args.workload, "seed": seed}
        r = stream.run(1)
        t0 = time.perf_counter()
        row["program"] = compare.check_cloud(
            stream.cloud(1), int(cfg["n_landmarks"]), stream.sampling(1),
            _values(r["st"]),
            compare.diagram_counter(r["diagram"]), per_dim,
            np.random.default_rng([seed, 17]))
        row["check_s"] = time.perf_counter() - t0
        del r
        if i >= n_control:
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            continue
        t0 = time.perf_counter()
        row["control"] = control.control_readings(
            stream.cloud(1), int(cfg["n_landmarks"]), stream.sampling(1),
            per_dim,
            np.random.default_rng([seed, 17]))
        row["control_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
