"""Vectorized row-key utilities for simplex arrays.

Simplices live in columnar form: an (n, k) int32 array of per-row-sorted
vertex ids. Set operations (unique, membership, facet lookup) reduce to
operations on a 1D "row key" view: rows are byte-packed big-endian so that
memcmp order equals lexicographic numeric order for non-negative vertex ids.
This keeps every simplex-tree bulk operation a vectorized numpy call instead
of the per-simplex Python/C++ tree walks the reference inherits from gudhi.
"""

from __future__ import annotations

import numpy as np


def row_keys(arr: np.ndarray) -> np.ndarray:
    """Pack each row of an (n, k) non-negative int array into one void key.

    memcmp ordering of the keys == lexicographic ordering of the rows.
    """
    if arr.ndim != 2:
        raise ValueError(f"expected 2D array, got shape {arr.shape}")
    n, k = arr.shape
    be = np.ascontiguousarray(arr.astype(">i4", copy=False))
    return be.view(np.dtype((np.void, 4 * k))).reshape(n)


def sort_rows_within(arr: np.ndarray) -> np.ndarray:
    """Sort vertex ids within each row (canonical simplex form)."""
    return np.sort(arr, axis=1)


def lex_order(arr: np.ndarray) -> np.ndarray:
    """Indices that lex-sort the rows of ``arr``."""
    return np.argsort(row_keys(arr), kind="stable")


def unique_rows(arr: np.ndarray):
    """Unique rows (lex-sorted) and the inverse map.

    Returns:
        (uniq (m, k), inverse (n,)) such that uniq[inverse] == arr row-wise.
    """
    keys = row_keys(arr)
    uniq_keys, first_idx, inverse = np.unique(
        keys, return_index=True, return_inverse=True
    )
    return arr[first_idx], inverse


def find_rows(haystack_sorted: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Locate each row of ``needles`` in lex-sorted ``haystack_sorted``.

    Returns:
        (n,) int64 positions; -1 where a needle row is absent.
    """
    hk = row_keys(haystack_sorted)
    nk = row_keys(needles)
    pos = np.searchsorted(hk, nk)
    pos_clipped = np.minimum(pos, len(hk) - 1) if len(hk) else np.zeros_like(pos)
    if len(hk) == 0:
        return np.full(len(nk), -1, dtype=np.int64)
    found = hk[pos_clipped] == nk
    out = np.where(found, pos_clipped, -1)
    return out.astype(np.int64)
