#!/usr/bin/env python3
"""Run one cell of the benchmark of ``flooder_tpu_torch`` once.

    python3 flood_bench/run.py --workload <cell> --seed <n> \\
        --seconds <window> --trace <0|1>

From the root of a checkout: loads the program, warms up on one cloud of
the cell's shapes, measures a window of distinct clouds (``--trace 0``:
the cell's end-to-end metrics) or runs the traced phases (``--trace 1``:
its per-layer metrics), checks a sample of the answers against the plain
reference, and prints one JSON line last on standard output, with each
number compared beside its limit as the last lines of standard error.
Exits 2 without a result when the machine lacks the cell's CUDA devices,
3 when JAX or the JAX package is loaded or the program cannot be
imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def _plain(value):
    """A reading for JSON: non-finite numbers as strings."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fbench.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"refusing to run: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    from fbench import cell

    try:
        result = cell.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    except cell.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        c["value"] = _plain(c["value"])
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
