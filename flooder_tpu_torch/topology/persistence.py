"""Boundary-matrix reduction for persistence (native C++).

The SimplexTree hands this module the boundary matrix of a filtered complex
(CSR over simplices pre-sorted by (filtration, dimension)); it returns the
persistence pairing. The reduction is the native twist/clearing code in
``flooder_tpu_torch/native/src/persistence.cpp``. A failed build raises:
nothing falls back. ``_reduce_py`` is the plain version of the same
algorithm, kept for the test that holds the native reduction against it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..native.build import load_persistence


def _reduce_py(
    dims: np.ndarray, offsets: np.ndarray, indices: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-Python twist/clearing reduction (the plain version)."""
    n = len(dims)
    if n == 0:
        return np.empty((0, 2), dtype=np.int64), np.empty(0, dtype=np.int64)
    maxdim = int(dims.max())
    by_dim = [np.flatnonzero(dims == d) for d in range(maxdim + 1)]
    low_inv = np.full(n, -1, dtype=np.int64)
    cleared = np.zeros(n, dtype=bool)
    is_death = np.zeros(n, dtype=bool)
    reduced = {}
    pairs = []

    for d in range(maxdim, 0, -1):
        for j in by_dim[d]:
            if cleared[j]:
                continue
            col = sorted(indices[offsets[j] : offsets[j + 1]].tolist())
            while col:
                low = col[-1]
                k = low_inv[low]
                if k < 0:
                    break
                other = reduced[k]
                # symmetric difference of two sorted lists
                out = []
                i1 = i2 = 0
                while i1 < len(col) and i2 < len(other):
                    a, b = col[i1], other[i2]
                    if a < b:
                        out.append(a)
                        i1 += 1
                    elif a > b:
                        out.append(b)
                        i2 += 1
                    else:
                        i1 += 1
                        i2 += 1
                out.extend(col[i1:])
                out.extend(other[i2:])
                col = out
            if col:
                low = col[-1]
                low_inv[low] = j
                cleared[low] = True
                is_death[j] = True
                reduced[j] = col
                pairs.append((low, j))

    essential = np.flatnonzero(~cleared & ~is_death)
    pairs_arr = (
        np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if pairs
        else np.empty((0, 2), dtype=np.int64)
    )
    return pairs_arr, essential.astype(np.int64)


def reduce_filtration(
    dims: np.ndarray, offsets: np.ndarray, indices: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce a filtration-ordered boundary matrix.

    Args:
        dims: (n,) int8 simplex dimensions, in filtration order.
        offsets: (n+1,) int64 CSR offsets.
        indices: int64 facet positions (filtration order ids).

    Returns:
        (pairs (m, 2) int64 [birth, death], essential (e,) int64).
    """
    dims = np.ascontiguousarray(dims, dtype=np.int8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n = len(dims)

    lib = load_persistence()

    out_pairs = np.empty(2 * max(n, 1), dtype=np.int64)
    out_ess = np.empty(max(n, 1), dtype=np.int64)
    out_counts = np.zeros(2, dtype=np.int64)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.flood_reduce(
        ctypes.c_int64(n),
        ptr(dims, ctypes.c_int8),
        ptr(offsets, ctypes.c_int64),
        ptr(indices, ctypes.c_int64),
        ptr(out_pairs, ctypes.c_int64),
        ptr(out_ess, ctypes.c_int64),
        ptr(out_counts, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"native persistence reduction returned {rc}")
    npairs, ness = int(out_counts[0]), int(out_counts[1])
    return (
        out_pairs[: 2 * npairs].reshape(-1, 2).copy(),
        out_ess[:ness].copy(),
    )
