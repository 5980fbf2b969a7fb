"""Example 04: dataset featurization with Flood persistent homology.

Counterpart of ``examples/example_04_featurization.py``: procedurally
generated swiss-cheese clouds whose label is their number of voids; for
every cloud the Flood complex (FPS landmarks, grid sampling), persistence
diagrams in dimensions 0-2, simple stable statistics per diagram, and a
nearest-centroid classifier of the void count on the standardized
features.

Run: ``python -m flooder_tpu_torch.examples.example_04_featurization
--small`` (``--device cpu`` without CUDA).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import (flood_complex, generate_landmarks,
                generate_swiss_cheese_points)
from ..cli import validate_device
from ._common import add_device_flag, use_kernel


def diagram_features(diagrams, thresholds=(0.05, 0.1, 0.2)):
    """Stable summary statistics per diagram dimension."""
    feats = []
    for d in diagrams:
        if len(d) == 0:
            feats.extend([0.0] * (3 + len(thresholds)))
            continue
        finite = d[np.isfinite(d[:, 1])]
        pers = finite[:, 1] - finite[:, 0] if len(finite) else np.zeros(1)
        feats.append(float(pers.sum()))
        feats.append(float(pers.max()) if len(pers) else 0.0)
        feats.append(float(len(d)))
        feats.extend(float((pers > t).sum()) for t in thresholds)
    return np.asarray(feats)


def flood_diagrams(points, n_landmarks):
    lms = generate_landmarks(points, n_landmarks, start_idx=0,
                             device=points.device)
    st = flood_complex(points, lms, return_simplex_tree=True,
                       use_pallas=use_kernel(points.device),
                       device=points.device)
    st.compute_persistence()
    return [st.persistence_intervals_in_dimension(i) for i in range(3)]


def nearest_centroid_accuracy(X, y, n_folds=4, seed=0):
    """Leave-groups-out nearest-centroid classification accuracy."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    folds = np.array_split(idx, n_folds)
    mu = X.mean(0)
    sd = X.std(0) + 1e-9
    Xs = (X - mu) / sd
    correct = 0
    for f in folds:
        trn = np.setdiff1d(idx, f)
        cents = {c: Xs[trn][y[trn] == c].mean(0) for c in np.unique(y[trn])}
        for i in f:
            pred = min(cents, key=lambda c: np.linalg.norm(Xs[i] - cents[c]))
            correct += int(pred == y[i])
    return correct / len(X)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--num-points", type=int, default=None)
    ap.add_argument("--per-class", type=int, default=None)
    ap.add_argument("--landmarks", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = validate_device(args.device)

    n_pts = args.num_points or (20_000 if args.small else 100_000)
    per_class = args.per_class or (3 if args.small else 10)
    n_lms = args.landmarks or (200 if args.small else 500)
    ks = (2, 8)  # void counts = the class labels

    X, y = [], []
    t0 = time.perf_counter()
    for label, k in enumerate(ks):
        for rep in range(per_class):
            pts, _, _ = generate_swiss_cheese_points(
                n_pts, k=k, void_radius_range=(0.08, 0.15),
                seed=1000 * label + rep, device=dev,
            )
            dgms = flood_diagrams(pts, n_lms)
            X.append(diagram_features(dgms))
            y.append(label)
            print(
                f"cloud k={k} rep={rep}: "
                f"H2 bars > 0.05: {int(X[-1][2 * 6 + 3])}",
                flush=True,
            )
    X = np.stack(X)
    y = np.asarray(y)
    elapsed = time.perf_counter() - t0

    acc = nearest_centroid_accuracy(X, y)
    n = len(X)
    print(
        f"\nfeaturized {n} clouds x {n_pts} pts on {dev} in {elapsed:.1f}s "
        f"({elapsed / n:.2f}s/cloud incl. PH)"
    )
    print(f"nearest-centroid void-count accuracy: {acc:.2f} (chance 0.50)")
    if not args.small and acc < 0.9:
        raise RuntimeError(
            f"featurization should separate 2-void vs 8-void (accuracy {acc})")


if __name__ == "__main__":
    main()
