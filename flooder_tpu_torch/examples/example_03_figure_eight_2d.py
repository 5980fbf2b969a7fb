"""Example 03: Flood PH of a noisy figure-eight sample (40M points).

Counterpart of ``examples/example_03_figure_eight_2d.py``: the largest
demonstrated configuration, printing the 10 longest bars per dimension.

Run: ``python -m flooder_tpu_torch.examples.example_03_figure_eight_2d
--small`` (``--device cpu`` without CUDA).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import (flood_complex, generate_figure_eight_points_2d,
                generate_landmarks)
from ..cli import validate_device
from ..topology import SimplexTree
from ._common import add_device_flag, synchronize, use_kernel

RED = "\033[91m"
BLUE = "\033[94m"
YELLOW = "\033[93m"
RESET = "\033[0m"


def top_k_longest(bd: np.ndarray, k: int = 10) -> np.ndarray:
    """Return the top-k longest persistence bars (by lifetime)."""
    lifetimes = bd[:, 1] - bd[:, 0]
    idx = np.argsort(lifetimes)[-k:][::-1]
    return bd[idx]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--points", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = validate_device(args.device)

    n_pts = args.points or (100_000 if args.small else 40_000_000)
    n_lms = 300 if args.small else 2000

    print(f"{YELLOW}Flood PH of a noisy figure-eight sample ({n_pts} points, "
          f"{dev})")
    print(f"{YELLOW}---------------------------------------------------{RESET}")

    pts = generate_figure_eight_points_2d(n_pts, noise_std=0.02,
                                          noise_kind="gaussian", device=dev)
    synchronize(dev)

    t0_fps = time.perf_counter()
    lms = generate_landmarks(pts, n_lms, device=dev)
    synchronize(dev)
    t1_fps = time.perf_counter()

    t0_complex = time.perf_counter()
    out_complex = flood_complex(pts, lms, batch_size=64,
                                use_pallas=use_kernel(dev), device=dev)
    t1_complex = time.perf_counter()

    t0_ph = time.perf_counter()
    st = SimplexTree()
    for simplex in out_complex:
        st.insert(simplex, out_complex[simplex])
    st.make_filtration_non_decreasing()
    st.compute_persistence()
    t1_ph = time.perf_counter()

    print(
        f"{BLUE}{n_pts:8d} points ({n_lms} landmarks) | "
        f"Complex (Flood): {(t1_complex - t0_complex):6.2f} sec | "
        f"PH (Flood): {t1_ph - t0_ph:6.2f} sec | "
        f"FPS: {t1_fps - t0_fps:6.2f} sec{RESET}"
    )

    diags = [st.persistence_intervals_in_dimension(i) for i in range(2)]
    for i in range(2):
        print(f"{RED}10 longest bars (sorted by lifetime) in dimension {i}: "
              f"{RESET}")
        for j, (b, d) in enumerate(top_k_longest(diags[i], k=10)):
            print(
                f"{BLUE}  {j + 1:2d}: (birth, death)=({b:.4f}, {d:.4f}), "
                f"lifetime={(d - b):.4f} {RESET}"
            )


if __name__ == "__main__":
    main()
