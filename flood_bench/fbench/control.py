"""The control: the reference in bfloat16, in the program's place.

The configurations state float32, so the control computes in bfloat16 what
the comparison reads: FPS (distances and running minima) and the sampled
simplices' values (samples, witnesses and distances). It does not
triangulate the whole complex at bfloat16 values or reduce it: its
diagram would agree with its own filtration by construction, and the
control has to fail one number, not each. Its readings, beside the
program's, set the limits in ``compare.LIMITS``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import compare, reference


def control_readings(cloud: torch.Tensor, n_landmarks: int,
                     sampling: dict, per_dim: int,
                     rng: np.random.Generator) -> Dict[str, float]:
    """The control's readings on one cloud."""
    ref = compare.ReferenceComplex(cloud, n_landmarks)
    low = compare.ReferenceComplex(cloud, n_landmarks,
                                   fps_dtype=torch.bfloat16)
    mismatch = len(ref.simplex_set() ^ low.simplex_set())
    universe = {s: 0.0 for s in ref.simplex_set()}
    sampled = compare.sample_simplices(ref.levels, universe, per_dim, rng)
    exact = reference.intervals(cloud, ref.landmarks, ref.cells, ref.levels,
                                sampling).values(sampled)
    coarse = reference.intervals(cloud, ref.landmarks, ref.cells, ref.levels,
                                 sampling, dtype=torch.bfloat16).values(sampled)
    gap = max(compare.relative_gap(c_lo, lo, hi)
              for (c_lo, _), (lo, hi) in zip(coarse, exact))
    return {"simplex_mismatch": mismatch, "filtration_gap": gap,
            "diagram_mismatch": 0, "checked_simplices": len(sampled)}
