"""Delaunay triangulation → simplicial complex (host combinatorics).

The reference calls ``gudhi.DelaunayComplex(landmarks).create_simplex_tree()``
(reference core.py:130-132, CGAL-backed). Here the triangulation comes from
scipy's Qhull binding and the face lattice is enumerated with vectorized
numpy (per SURVEY §7: the host owns combinatorics over the ~1k landmarks;
the device owns dense geometry).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.spatial import Delaunay as _SciDelaunay
from scipy.spatial import QhullError

from ._keys import row_keys
from .simplex_tree import SimplexTree


def delaunay_cells(points: np.ndarray) -> np.ndarray:
    """Top-dimensional Delaunay cells of a point set.

    Returns:
        (n_cells, d+1) int32 vertex-index array (indices into ``points``).

    Degenerate inputs retry with joggle (QJ); inputs with at most d+1
    points degrade to the single full simplex.
    """
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    if n <= d + 1:
        return np.arange(n, dtype=np.int32).reshape(1, -1)
    try:
        tri = _SciDelaunay(pts)
    except QhullError:
        tri = _SciDelaunay(pts, qhull_options="QJ")
    return np.ascontiguousarray(tri.simplices.astype(np.int32))


def faces_by_dim(cells: np.ndarray, max_dimension: Optional[int] = None) -> List[np.ndarray]:
    """All unique faces of a cell array, grouped by dimension.

    Each level is the unique facets of the level above, from the cells
    down: a d-face of a cell lies in one of its (d+1)-faces, and the
    unique (d+1)-faces are far fewer than a cell's (d+2)-subsets summed
    over cells (at 10-D, 12M subsets of 5,918 cells against 4M facets).

    Args:
        cells: (n_cells, k) vertex-index array.
        max_dimension: highest face dimension to return (default: k-1).
            Every level from the cells down is built all the same (each
            comes from the one above); this only trims the returned list.

    Returns:
        list ``out`` with ``out[d]`` an (n_d, d+1) int32 array of per-row
        sorted, lex-sorted unique faces.
    """
    level = np.sort(np.asarray(cells, dtype=np.int32), axis=1)
    top = level.shape[1] - 1
    if max_dimension is None:
        max_dimension = top
    out: List[np.ndarray] = [level] * (top + 1)
    for d in range(top, -1, -1):
        if d < top:  # rows stay sorted when a column is dropped
            level = np.concatenate(
                [np.delete(out[d + 1], j, axis=1) for j in range(d + 2)])
        _, first = np.unique(row_keys(level), return_index=True)
        out[d] = np.ascontiguousarray(level[first])
    return out[: min(max_dimension, top) + 1]


class DelaunayComplex:
    """Delaunay triangulation as a (filtration-less) simplicial complex.

    Mirrors ``gudhi.DelaunayComplex``: ``create_simplex_tree()`` returns a
    SimplexTree whose simplices carry NaN filtration values, to be assigned
    by the caller (the flood pipeline assigns all of them and then repairs
    monotonicity, reference core.py:278-280).
    """

    def __init__(self, points):
        self._points = np.asarray(points, dtype=np.float64)
        if self._points.ndim != 2:
            raise ValueError("points must be (N, d)")

    def get_point(self, idx: int) -> np.ndarray:
        return self._points[idx]

    def create_simplex_tree(self) -> SimplexTree:
        cells = delaunay_cells(self._points)
        levels = faces_by_dim(cells)
        filts = [np.full(v.shape[0], np.nan) for v in levels]
        return SimplexTree.from_columns(levels, filts)
