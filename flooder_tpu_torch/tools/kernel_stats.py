"""Measure the flood kernel's realized work.

Counterpart of ``tools/kernel_stats.py``. The flood kernel skips work by
exact bounds that tighten as each block visits its chunks nearest first,
so how much it really computes is an observable of a run, not of a model.
This tool walks one scene's work-list through kernel K3
(``ops/cuda_flood_stats.py``), which computes K1's values and counts per
simplex the visited pairs, the admitted (simplex, sub-chunk) units and the
computed sample tiles. It checks K3's values against the production
engine (K1, through ``CudaFloodEngine.min_distances``) on every run and
prints one JSON record with the reference tool's keys. Times are taken
with CUDA events on a CUDA device (after one warm-up run) and with the
host clock on the CPU; ``timer`` says which.

Usage:
    python -m flooder_tpu_torch.tools.kernel_stats --points 100000 \
        --landmarks 300
    python -m flooder_tpu_torch.tools.kernel_stats --device cpu \
        --points 2000 --landmarks 40
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda_flood import BS, _inf_masked, flood_min, kernel_operations
from ..ops.cuda_flood_stats import (
    COL_PAIRS,
    COL_SUBCHUNKS,
    COL_TILES,
    flood_min_stats,
)
from .scene import build_scene


def _time_call(fn, device: torch.device):
    """(result, seconds) of one call of ``fn``: CUDA events around a run
    that follows one warm-up run on a CUDA device, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end) / 1e3


def run_with_stats(scene):
    """Walk the scene's work-list through K3 and check it against the
    production engine.

    Returns (seg_times_s: one launch's seconds in a list, counters: dict,
    parity: bool). Parity is the reference tool's rule: K3's distances
    within atol = rtol = 1e-5 of ``engine.min_distances``, inf in the same
    places.
    """
    ops = scene.operands
    (out, stats), sec = _time_call(lambda: flood_min_stats(*ops),
                                   scene.device)
    prod = scene.engine.min_distances(
        scene.sim_verts, scene.weights, scene.centers, scene.radii,
        tight=True,
    ).cpu().numpy()
    inv = torch.as_tensor(np.argsort(scene.sperm), device=out.device)
    acc2 = out.reshape(out.shape[0], -1)[: scene.num_simplices]
    mine = torch.sqrt(_inf_masked(acc2[:, inv])).cpu().numpy()
    both_inf = np.isinf(mine) & np.isinf(prod)
    parity = bool(np.allclose(
        np.where(both_inf, 0.0, mine), np.where(both_inf, 0.0, prod),
        atol=1e-5, rtol=1e-5,
    ))
    st = stats.cpu().numpy()
    counters = {
        "visited_pairs": int(st[::BS, COL_PAIRS].sum()),
        "admitted_subchunks": int(st[:, COL_SUBCHUNKS].sum()),
        "computed_tiles": int(st[:, COL_TILES].sum()),
        "worklist_pairs": int(ops[-1].numel()),
        # K1's admitted (simplex, tile, sub-chunk) units in the parity run
        "production_units": kernel_operations(scene.engine.last_stats)[0],
    }
    return [sec], counters, parity


def time_overhead(scene):
    """Time the production kernel K1 on the scene's work-list with every
    radius set to 1e-12, to approximate its per-pair cost without tile
    compute. Returns one launch's seconds in a list.

    Caveat (as in the reference tool): the ball test is ``near^2 <= r^2``,
    and a ball center inside a sub-chunk's box gives ``near^2 == 0``, which
    passes even at radius 1e-12, so some tile compute leaks into this time:
    it is an upper bound on the pure overhead.
    """
    ops = list(scene.operands)
    ops[5] = torch.full_like(ops[5], 1e-12)
    _, sec = _time_call(lambda: flood_min(*ops), scene.device)
    return [sec]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--cloud", default="cheese3d",
                    choices=("cheese3d", "eight2d"))
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--overhead", action="store_true",
        help="also time the production kernel with radii of 1e-12 "
        "(per-pair overhead, an upper bound)",
    )
    ap.add_argument("--device", default=None,
                    help="cuda[:N] (the default) or cpu")
    args = ap.parse_args(argv)

    scene = build_scene(args.points, args.landmarks, cloud=args.cloud,
                        device=args.device)
    seg_times, counters, parity = run_with_stats(scene)
    overhead = time_overhead(scene) if args.overhead else None
    dev = scene.device
    rec = {
        "points": args.points,
        "landmarks": args.landmarks,
        "cloud": args.cloud,
        "backend": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "num_simplices": int(scene.num_simplices),
        "nr": int(scene.nr),
        "rt": int(scene.rt),
        "seg_times_s": seg_times,
        "overhead_seg_times_s": overhead,
        "parity_vs_production": parity,
        **counters,
    }
    print(json.dumps(rec), flush=True)
    if not parity:
        print("PARITY FAILURE vs production kernel", file=sys.stderr)
        return 1
    if args.out:
        Path(args.out).write_text(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
