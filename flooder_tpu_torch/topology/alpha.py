"""Alpha complex with vectorized filtration computation (numpy only).

Counterpart of ``flooder_tpu.topology.alpha``, and like it the oracle of
the flood complex's correctness test (gudhi is not a dependency): the alpha
filtration on the Qhull Delaunay triangulation with batched float64 linear
algebra,

- circumcenter and circumradius of every k-simplex by one batched Gram
  solve per dimension,
- Gabriel tests and coface-min propagation as vectorized scatter passes
  from dimension k+1 down to 0 (the order-independent fixed point of
  gudhi's propagation rule).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ._keys import find_rows
from .delaunay import delaunay_cells, faces_by_dim
from .simplex_tree import SimplexTree


def circumspheres(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Circumcenters and squared circumradii of a batch of k-simplices.

    Args:
        verts: (m, k+1, d) float64 vertex coordinates, k <= d.

    Returns:
        (centers (m, d), r2 (m,)): the center/squared radius of the unique
        sphere through the k+1 vertices within their affine hull.
    """
    verts = np.asarray(verts, dtype=np.float64)
    m, k1, d = verts.shape
    k = k1 - 1
    if k == 0:
        return verts[:, 0, :].copy(), np.zeros(m)
    e = verts[:, 1:, :] - verts[:, :1, :]  # (m, k, d)
    gram = np.einsum("mid,mjd->mij", e, e)  # (m, k, k)
    b = 0.5 * np.einsum("mii->mi", gram).copy()  # 0.5 * |e_i|^2
    try:
        x = np.linalg.solve(gram, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        # degenerate (sliver) simplices: ridge-regularized solve
        ridge = 1e-12 * np.eye(k)[None] * np.maximum(
            np.einsum("mii->m", gram)[:, None, None], 1e-300
        )
        x = np.linalg.solve(gram + ridge, b[..., None])[..., 0]
    centers = verts[:, 0, :] + np.einsum("mk,mkd->md", x, e)
    r2 = np.einsum("md,md->m", centers - verts[:, 0, :], centers - verts[:, 0, :])
    return centers, r2


class AlphaComplex:
    """Alpha filtration over the Delaunay triangulation of a point cloud."""

    def __init__(self, points=None):
        self._points = np.asarray(points, dtype=np.float64)
        if self._points.ndim != 2:
            raise ValueError("points must be (N, d)")

    def get_point(self, idx: int) -> np.ndarray:
        return self._points[idx]

    def create_simplex_tree(
        self,
        max_alpha_square: float = float("inf"),
        output_squared_values: bool = True,
        default_filtration_value: bool = False,
    ) -> SimplexTree:
        """Build the alpha-filtered SimplexTree.

        Args:
            max_alpha_square: prune simplices with alpha² above this value.
            output_squared_values: if False, filtrations are radii (gudhi's
                ``output_squared_values=False``, used by the reference tests
                to compare against flood covering radii).
            default_filtration_value: if True, skip filtration computation
                and leave NaNs (gudhi semantics).
        """
        pts = self._points
        cells = delaunay_cells(pts)
        levels = faces_by_dim(cells)
        top = len(levels) - 1

        filt: List[np.ndarray] = [None] * (top + 1)  # alpha² per simplex
        centers: List[np.ndarray] = [None] * (top + 1)
        r2s: List[np.ndarray] = [None] * (top + 1)

        if default_filtration_value:
            filts = [np.full(v.shape[0], np.nan) for v in levels]
            return SimplexTree.from_columns(levels, filts)

        for d in range(1, top + 1):
            c, r2 = circumspheres(pts[levels[d]])
            centers[d], r2s[d] = c, r2

        # top level: alpha² = circumradius²
        filt[top] = r2s[top].copy() if top >= 1 else np.zeros(levels[0].shape[0])

        # descending propagation: for each d-simplex, min over coface values;
        # Gabriel simplices take their own circumradius² instead.
        for d in range(top - 1, 0, -1):
            nd = levels[d].shape[0]
            cof_min = np.full(nd, np.inf)
            non_gabriel = np.zeros(nd, dtype=bool)
            up = levels[d + 1]  # (n_{d+1}, d+2)
            for j in range(d + 2):
                facet = np.ascontiguousarray(np.delete(up, j, axis=1))
                pos = find_rows(levels[d], facet)
                p = pts[up[:, j]]  # opposite vertex of each coface
                dist2 = np.einsum(
                    "md,md->m", p - centers[d][pos], p - centers[d][pos]
                )
                inside = dist2 < r2s[d][pos] * (1.0 - 1e-12)
                np.logical_or.at(non_gabriel, pos, inside)
                np.minimum.at(cof_min, pos, filt[d + 1])
            filt[d] = np.where(non_gabriel, cof_min, np.minimum(r2s[d], cof_min))

        filt[0] = np.zeros(levels[0].shape[0])

        if np.isfinite(max_alpha_square):
            levels = [v[f <= max_alpha_square] for v, f in zip(levels, filt)]
            filt = [f[f <= max_alpha_square] for f in filt]

        if not output_squared_values:
            filt = [np.sqrt(np.maximum(f, 0.0)) for f in filt]

        return SimplexTree.from_columns(levels, filt)
