"""Simplex bounding balls (plain PyTorch).

Counterpart of ``flooder_tpu.ops.flood.simplex_bounding_balls``. The dense
flood engine of that module (``DenseFloodEngine``, ``flood_min_distances``,
``batch_windows``) is not ported yet.
"""

from __future__ import annotations

import torch


def simplex_bounding_balls(simplex_vertices: torch.Tensor):
    """Bounding-ball centers and radii of a batch of simplices.

    The center is the midpoint of the farthest vertex pair (the first such
    pair on a tie); the radius is the max center-to-vertex distance
    inflated by 1.42 for dim > 1 (1.01 otherwise) plus a 1e-3 slack.

    Args:
        simplex_vertices: (S, k, d) vertex coordinates (k = dim + 1).

    Returns:
        (centers (S, d), radii (S,)).
    """
    v = simplex_vertices
    s, k, d = v.shape
    diffs = v[:, :, None, :] - v[:, None, :, :]
    d2 = diffs[..., 0] * diffs[..., 0]
    for i in range(1, d):
        d2 = d2 + diffs[..., i] * diffs[..., i]
    flat_idx = torch.argmax(d2.reshape(s, k * k), dim=1)
    i0, i1 = flat_idx // k, flat_idx % k
    rows = torch.arange(s, device=v.device)
    centers = (v[rows, i0] + v[rows, i1]) / 2.0
    radial = torch.linalg.vector_norm(v - centers[:, None, :], dim=-1)
    factor = 1.42 if (k - 1) > 1 else 1.01
    radii = torch.amax(radial, dim=1) * factor + 1e-3
    return centers, radii
