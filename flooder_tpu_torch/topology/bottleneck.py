"""Exact bottleneck distance between persistence diagrams (numpy, scipy).

Counterpart of ``flooder_tpu.topology.bottleneck`` and a drop-in for
``gudhi.bottleneck_distance``: binary search over the discrete set of
candidate distances, each tested for feasibility with a maximum bipartite
matching on the doubled graph (points plus anonymous diagonal proxies), by
scipy's Hopcroft-Karp.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching


def _clean(diag) -> np.ndarray:
    d = np.asarray(diag, dtype=np.float64).reshape(-1, 2)
    # zero-persistence points sit on the diagonal and never affect the value
    keep = d[:, 1] != d[:, 0]
    return d[keep]


def _feasible(D: np.ndarray, gap1: np.ndarray, gap2: np.ndarray, eps: float) -> bool:
    """Perfect-matching feasibility at tolerance eps.

    U = points1 ∪ diag-proxies(n2); V = points2 ∪ diag-proxies(n1).
    """
    n1, n2 = D.shape
    n = n1 + n2
    rows, cols = [], []

    r, c = np.nonzero(D <= eps)
    rows.append(r)
    cols.append(c)

    # point1 -> its diagonal projection (any proxy; proxies are anonymous)
    ok1 = np.flatnonzero(gap1 <= eps)
    if len(ok1) and n1:
        r = np.repeat(ok1, n1)
        c = n2 + np.tile(np.arange(n1), len(ok1))
        rows.append(r)
        cols.append(c)

    # proxies of side 2 (U rows n1..n1+n2) connect to near-diagonal points2
    ok2 = np.flatnonzero(gap2 <= eps)
    if len(ok2) and n2:
        r = n1 + np.tile(np.arange(n2), len(ok2))
        c = np.repeat(ok2, n2)
        rows.append(r)
        cols.append(c)

    # proxy–proxy edges always allowed
    if n1 and n2:
        r = n1 + np.tile(np.arange(n2), n1)
        c = n2 + np.repeat(np.arange(n1), n2)
        rows.append(r)
        cols.append(c)

    if not rows:
        return True
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.ones(len(rows), dtype=np.int8)
    graph = csr_matrix((data, (rows, cols)), shape=(n, n))
    match = maximum_bipartite_matching(graph, perm_type="column")
    return int((match >= 0).sum()) == n


def bottleneck_distance(diagram_1, diagram_2, e: float = None) -> float:
    """Bottleneck distance between two persistence diagrams.

    Args:
        diagram_1 / diagram_2: (n, 2) arrays of (birth, death); death may be
            +inf for essential classes.
        e: optional approximation error; None/0 computes the exact value.

    Returns:
        The bottleneck distance (inf if essential-class counts differ).
    """
    d1 = _clean(diagram_1)
    d2 = _clean(diagram_2)

    inf1 = np.isinf(d1[:, 1])
    inf2 = np.isinf(d2[:, 1])
    ess = 0.0
    if inf1.sum() != inf2.sum():
        return float("inf")
    if inf1.any():
        b1 = np.sort(d1[inf1, 0])
        b2 = np.sort(d2[inf2, 0])
        ess = float(np.max(np.abs(b1 - b2))) if len(b1) else 0.0
    f1 = d1[~inf1]
    f2 = d2[~inf2]
    n1, n2 = len(f1), len(f2)

    if n1 == 0 and n2 == 0:
        return ess
    gap1 = (f1[:, 1] - f1[:, 0]) / 2.0 if n1 else np.empty(0)
    gap2 = (f2[:, 1] - f2[:, 0]) / 2.0 if n2 else np.empty(0)
    if n1 == 0:
        return max(ess, float(gap2.max(initial=0.0)))
    if n2 == 0:
        return max(ess, float(gap1.max(initial=0.0)))

    D = np.maximum(
        np.abs(f1[:, 0][:, None] - f2[:, 0][None, :]),
        np.abs(f1[:, 1][:, None] - f2[:, 1][None, :]),
    )

    candidates = np.unique(
        np.concatenate([D.reshape(-1), gap1, gap2, [0.0]])
    )

    if e is not None and e > 0:
        # approximate: bisect on the continuous interval
        lo, hi = 0.0, float(candidates[-1])
        while hi - lo > e:
            mid = (lo + hi) / 2
            if _feasible(D, gap1, gap2, mid):
                hi = mid
            else:
                lo = mid
        return max(ess, hi)

    lo, hi = 0, len(candidates) - 1
    if _feasible(D, gap1, gap2, float(candidates[0])):
        return max(ess, float(candidates[0]))
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _feasible(D, gap1, gap2, float(candidates[mid])):
            hi = mid
        else:
            lo = mid
    return max(ess, float(candidates[hi]))
