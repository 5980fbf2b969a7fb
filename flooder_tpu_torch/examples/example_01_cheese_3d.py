"""Example 01: runtime of Alpha PH against Flood PH on 3-D swiss cheese.

Counterpart of ``examples/example_01_cheese_3d.py``: sweep cloud sizes,
time the Alpha pipeline (the port's ``topology.AlphaComplex`` on the
host) against Flood PH on the device, and print mean ± std per size.

Run: ``python -m flooder_tpu_torch.examples.example_01_cheese_3d --small``
(``--device cpu`` without CUDA).
"""

from __future__ import annotations

import argparse
import time

from .. import flood_complex, generate_swiss_cheese_points
from ..cli import validate_device
from ..topology import AlphaComplex, SimplexTree
from ._common import (add_device_flag, print_summary, synchronize,
                      use_kernel)

RED = "\033[91m"
BLUE = "\033[94m"
YELLOW = "\033[93m"
RESET = "\033[0m"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CI-sized sweep")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument(
        "--alpha-max-n",
        type=int,
        default=None,
        help="skip the Alpha-PH baseline above this cloud size (the host "
        "Alpha at 1M+ points costs minutes to hours on one core); the "
        "Flood rows still run at every size",
    )
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = validate_device(args.device)

    if args.small:
        n_pts_list = [2000, 5000]
        batch_sizes = [256, 256]
        reps = args.reps or 1
        n_lms = 100
    else:
        n_pts_list = [10000, 100000, 1000000, 10000000]
        batch_sizes = [1024, 1024, 256, 64]
        reps = args.reps or 5
        n_lms = 1000
    rect_min = (0.0, 0.0, 0.0)
    rect_max = (1.0, 1.0, 1.0)
    void_radius_range = (0.1, 0.2)
    k = 6
    dim = len(rect_min)

    results = []

    print(f"{YELLOW}Alpha PH vs. Flood PH timing on cheese ({dev})")
    print(f"{YELLOW}--------------------------------------{RESET}")
    for i, n_pts in enumerate(n_pts_list):
        for rep in range(reps):
            points, _, _ = generate_swiss_cheese_points(
                n_pts, rect_min, rect_max, k, void_radius_range, device=dev
            )
            synchronize(dev)

            if args.alpha_max_n is not None and n_pts > args.alpha_max_n:
                print(
                    f"{RED}{n_pts:8d} points (try {rep}) | "
                    f"Alpha skipped (--alpha-max-n {args.alpha_max_n}){RESET}"
                )
            else:
                startt = time.perf_counter()
                alpha = AlphaComplex(points.cpu().numpy()).create_simplex_tree(
                    output_squared_values=False
                )
                t1 = time.perf_counter() - startt
                alpha.compute_persistence()
                t2 = time.perf_counter() - startt
                print(
                    f"{RED}{n_pts:8d} points (try {rep}) | "
                    f"Complex (Alpha): {t1:6.2f} sec | "
                    f"PH (Alpha): {t2:6.2f} sec{RESET}"
                )
                results.append(dict(rep=rep, n_pts=n_pts, method="Alpha",
                                    complex_time=t1, ph_time=t2))
                _ = alpha.persistence_intervals_in_dimension(dim - 1)

            # warm-up: first launches and the kernels' build
            _ = flood_complex(points[:2000], n_lms, batch_size=batch_sizes[i],
                              use_pallas=use_kernel(dev), device=dev)

            startt = time.perf_counter()
            out_complex = flood_complex(points, n_lms,
                                        batch_size=batch_sizes[i],
                                        use_pallas=use_kernel(dev), device=dev)
            st = SimplexTree()
            for simplex in out_complex:
                st.insert(simplex, out_complex[simplex])
            st.make_filtration_non_decreasing()
            t1 = time.perf_counter() - startt
            st.compute_persistence()
            t2 = time.perf_counter() - startt
            print(
                f"{BLUE}{n_pts:8d} points (try {rep}) | "
                f"Complex (Flood): {t1:6.2f} sec | "
                f"PH (Flood): {t2:6.2f} sec{RESET}"
            )
            results.append(dict(rep=rep, n_pts=n_pts, method="Flood",
                                complex_time=t1, ph_time=t2))
            _ = st.persistence_intervals_in_dimension(dim - 1)

    print(f"\n{YELLOW}Summary of Timings (mean ± std over {reps} "
          f"repetitions){RESET}")
    print_summary(results, [("complex_time", "Complex Time (s)"),
                            ("ph_time", "PH Time (s)")])


if __name__ == "__main__":
    main()
