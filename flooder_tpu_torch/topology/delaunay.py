"""Delaunay triangulation → simplicial complex (host combinatorics).

The reference calls ``gudhi.DelaunayComplex(landmarks).create_simplex_tree()``
(reference core.py:130-132, CGAL-backed). Here the triangulation comes from
scipy's Qhull binding and the face lattice is enumerated with vectorized
numpy (per SURVEY §7: the host owns combinatorics over the ~1k landmarks;
the device owns dense geometry).
"""

from __future__ import annotations

import itertools
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

    Args:
        cells: (n_cells, k) vertex-index array.
        max_dimension: highest face dimension to enumerate (default: k-1).

    Returns:
        list ``out`` with ``out[d]`` an (n_d, d+1) int32 array of per-row
        sorted, lex-sorted unique faces.
    """
    cells = np.asarray(cells, dtype=np.int32)
    k = cells.shape[1]
    top = k - 1
    if max_dimension is None:
        max_dimension = top
    out: List[np.ndarray] = []
    for d in range(min(max_dimension, top) + 1):
        rows = []
        for comb in itertools.combinations(range(k), d + 1):
            rows.append(cells[:, comb])
        stacked = np.sort(np.concatenate(rows, axis=0), axis=1)
        keys = row_keys(stacked)
        _, first = np.unique(keys, return_index=True)
        out.append(np.ascontiguousarray(stacked[first]))
    return out


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
