"""Example 02: Flood PH of a noisy torus sample (1M points).

Counterpart of ``examples/example_02_torus_3d.py``: the FPS / complex / PH
time split over 5 repetitions, printed as mean ± std.

Run: ``python -m flooder_tpu_torch.examples.example_02_torus_3d --small``
(``--device cpu`` without CUDA).
"""

from __future__ import annotations

import argparse
import time

from .. import (flood_complex, generate_landmarks,
                generate_noisy_torus_points_3d)
from ..cli import validate_device
from ..topology import SimplexTree
from ._common import (add_device_flag, print_summary, synchronize,
                      use_kernel)

BLUE = "\033[94m"
YELLOW = "\033[93m"
RESET = "\033[0m"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = validate_device(args.device)

    n_pts = 20_000 if args.small else 1_000_000
    n_lms = 200 if args.small else 2000
    reps = args.reps or (2 if args.small else 5)

    print(f"{YELLOW}Flood PH of a noisy torus sample ({n_pts} points, {dev})")
    print(f"{YELLOW}--------------------------------------------{RESET}")
    results = []
    for rep in range(reps):
        pts = generate_noisy_torus_points_3d(n_pts, device=dev)
        synchronize(dev)

        t0_fps = time.perf_counter()
        lms = generate_landmarks(pts, n_lms, device=dev)
        synchronize(dev)
        t1_fps = time.perf_counter()

        # warm-up: first launches and the kernels' build
        _ = flood_complex(pts[:10000], lms, use_pallas=use_kernel(dev),
                          device=dev)

        t0_complex = time.perf_counter()
        out_complex = flood_complex(pts, lms, batch_size=64,
                                    use_pallas=use_kernel(dev), device=dev)
        t1_complex = time.perf_counter()

        t0_ph = time.perf_counter()
        st = SimplexTree()
        for simplex, filtration_value in out_complex.items():
            st.insert(simplex, filtration_value)
        st.make_filtration_non_decreasing()
        st.compute_persistence()
        t1_ph = time.perf_counter()

        print(
            f"{BLUE}{n_pts:8d} points ({n_lms} landmarks) | "
            f"Complex (Flood): {(t1_complex - t0_complex):6.2f} sec | "
            f"PH (Flood): {t1_ph - t0_ph:6.2f} sec | "
            f"FPS: {t1_fps - t0_fps:6.2f} sec{RESET}"
        )
        results.append(dict(
            rep=rep, n_pts=n_pts, n_lms=n_lms, method="Flood",
            complex_time=t1_complex - t0_complex, fps_time=t1_fps - t0_fps,
            ph_time=t1_ph - t0_ph,
        ))

    print(f"\n{YELLOW}Summary of Timings (mean ± std over {reps} "
          f"repetitions){RESET}")
    print_summary(results, [("fps_time", "FPS Time (s)"),
                            ("complex_time", "Complex Time (s)"),
                            ("ph_time", "PH Time (s)")])


if __name__ == "__main__":
    main()
