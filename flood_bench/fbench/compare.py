"""The program's outputs for a cloud, judged against the reference.

Each number compared has its limit here (``LIMITS``), set from the
program's readings and the control's (PERF.md gives both):

- ``simplex_mismatch``: simplices in the program's complex or in the
  reference's (the Delaunay complex of the reference's FPS landmarks, in
  FPS order, any greedy pick allowed at an exact tie) but not in both. A
  landmark picked wrongly moves the vertex ids and the triangulation, so
  FPS is judged here too. Exact: 0.
- ``filtration_gap``: over a sample of simplices drawn from the seed, of
  every dimension past 0 (a vertex's value is 0 by definition), with each
  dimension's largest value among them, how far the program's value lies
  outside the reference's interval, as a share of the interval's upper
  end.
- ``diagram_mismatch``: pairs in the program's diagram or in the
  reference's reduction of the program's own filtration but not in both.
  Exact: 0.
- ``bad_answers``: clouds of the window whose answer breaks what every
  answer must hold (one vertex a landmark, one essential class, in
  dimension 0, every value finite). Exact: 0.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import reference

LIMITS = {
    "simplex_mismatch": 0,
    "filtration_gap": 1e-3,
    "diagram_mismatch": 0,
    "bad_answers": 0,
}


def diagram_counter(pairs) -> Counter:
    """A diagram as ``st.persistence()`` gives it, as a multiset of
    (dim, birth, death)."""
    return Counter((int(d), float(b), float(e)) for d, (b, e) in pairs)


def bad_answer(n_vertices: int, n_landmarks: int, pairs) -> bool:
    """Whether a cloud's answer breaks what any answer holds: one vertex a
    landmark, one essential class, in dimension 0, and finite births and
    deaths otherwise. ``pairs`` is ``st.persistence()``'s list."""
    inf = float("inf")
    essential = [d for d, (_, e) in pairs if e == inf]
    finite = all(math.isfinite(b) and (math.isfinite(e) or e == inf)
                 for _, (b, e) in pairs)
    return n_vertices != n_landmarks or essential != [0] or not finite


def relative_gap(value: float, lo: float, hi: float) -> float:
    """How far ``value`` lies outside [lo, hi], over ``hi`` (0 inside)."""
    if lo <= value <= hi:
        return 0.0
    dist = lo - value if value < lo else value - hi
    return float(dist / max(hi, 1e-12))


def sample_simplices(levels: Sequence[np.ndarray], values: Dict, per_dim: int,
                     rng: np.random.Generator) -> List[Tuple[int, ...]]:
    """``per_dim`` simplices of each dimension past 0 present in
    ``values``, drawn by ``rng``, plus each dimension's largest value
    among ``values``."""
    out = []
    for level in levels[1:]:
        rows = [tuple(int(v) for v in r) for r in level]
        rows = [r for r in rows if r in values]
        if not rows:
            continue
        pick = rng.choice(len(rows), size=min(per_dim, len(rows)),
                          replace=False)
        chosen = {rows[i] for i in pick}
        chosen.add(max(rows, key=lambda r: values[r]))
        out.extend(sorted(chosen))
    return out


class ReferenceComplex:
    """The reference's landmarks and Delaunay complex of one cloud.

    Where FPS meets an exact tie, every tied point is a greedy pick. When
    the tied points are the next picks, each at the tied value, their order
    is free: the complex may carry their vertex ids in any order
    (``groups``). Otherwise each other tied point starts a sequence of its
    own (at most ``MAX_BRANCHES``). ``match`` takes the sequence and order
    closest to the program's complex.
    """

    MAX_BRANCHES = 4

    def __init__(self, cloud: torch.Tensor, n_landmarks: int,
                 fps_dtype=torch.float32, count_updates: bool = False):
        self.cloud = cloud
        idx, self.fps_updates, ties, values = reference.fps(
            cloud, n_landmarks, 0, dtype=fps_dtype,
            count_updates=count_updates)
        self.picks = [idx]
        self.groups: List[Tuple[int, int]] = []
        steps = torch.nonzero(ties > 1).flatten().tolist()
        if steps and fps_dtype == torch.float32:
            self._resolve_ties(idx, values.tolist(), steps, n_landmarks)
        self._build(0, fps_dtype)

    def _resolve_ties(self, idx, values, steps, n_landmarks):
        picks = idx.tolist()
        for k, cands in reference.tie_candidates(self.cloud, idx,
                                                 steps).items():
            t = len(cands)
            if (1 < t <= 4 and sorted(picks[k:k + t]) == cands
                    and values[k:k + t] == [values[k]] * t):
                self.groups.append((k, t))
                continue
            for c in cands:
                if c != picks[k] and len(self.picks) <= self.MAX_BRANCHES:
                    self.picks.append(reference.fps(
                        self.cloud, n_landmarks, 0, forced={k: c})[0])

    def _build(self, which: int, fps_dtype=torch.float32):
        self.landmarks = self.cloud[self.picks[which]]
        if fps_dtype != torch.float32:
            self.landmarks = self.landmarks.to(fps_dtype).float()
        self.cells = reference.delaunay_cells(
            self.landmarks.double().cpu().numpy())
        self.levels = reference.delaunay_levels(self.cells)

    def simplex_set(self, relabel: Optional[np.ndarray] = None):
        out = set()
        for lv in self.levels:
            rows = lv if relabel is None else np.sort(relabel[lv], axis=1)
            out.update(tuple(int(v) for v in r) for r in rows)
        return out

    def _relabel(self, perms) -> np.ndarray:
        ids = np.arange(len(self.landmarks))
        for (k, t), perm in zip(self.groups, perms):
            ids[k:k + t] = k + np.asarray(perm)
        return ids

    def match(self, prog: set) -> int:
        """Settle on the pick sequence and the order of tied picks whose
        complex is closest to ``prog``; returns its simplices in one and
        not the other. Afterwards ``landmarks`` and ``cells`` are those of
        that complex, in the program's vertex ids."""
        best = None
        for which in range(len(self.picks)):
            if which:
                self._build(which)
            orders = itertools.product(*(itertools.permutations(range(t))
                                         for _, t in self.groups))
            for perms in itertools.islice(orders, 64):
                ids = self._relabel(perms)
                miss = len(self.simplex_set(ids) ^ prog)
                if best is None or miss < best[0]:
                    best = (miss, which, ids)
        miss, which, ids = best
        self._build(which)
        inverse = np.argsort(ids)
        self.landmarks = self.landmarks[torch.as_tensor(inverse,
                                                        device=self.cloud.device)]
        self.cells = np.sort(ids[self.cells], axis=1)
        self.levels = [np.unique(np.sort(ids[lv], axis=1), axis=0)
                       for lv in self.levels]
        return miss


def check_cloud(cloud: torch.Tensor, n_landmarks: int, sampling: dict,
                prog_values: Dict[Tuple[int, ...], float], prog_diag: Counter,
                per_dim: int, rng: np.random.Generator) -> Dict[str, float]:
    """The numbers of one cloud: the program's complex, a sample of its
    values and its diagram against the reference. ``sampling`` is the
    cloud's sampling (``reference.intervals``)."""
    t0 = time.perf_counter()
    ref = ReferenceComplex(cloud, n_landmarks)
    mismatch = ref.match(set(prog_values))
    t1 = time.perf_counter()
    sampled = sample_simplices(ref.levels, prog_values, per_dim, rng)
    bounds = reference.intervals(cloud, ref.landmarks, ref.cells, ref.levels,
                                 sampling).values(sampled)
    t2 = time.perf_counter()
    gap = max((relative_gap(prog_values[s], lo, hi)
               for s, (lo, hi) in zip(sampled, bounds)), default=0.0)
    try:
        ref_diag = reference.diagram(prog_values.items())
        diag_mismatch = sum(((ref_diag - prog_diag) + (prog_diag - ref_diag))
                            .values())
    except KeyError:  # a face missing from the program's complex
        diag_mismatch = float("inf")
    return {"simplex_mismatch": mismatch, "filtration_gap": gap,
            "diagram_mismatch": diag_mismatch, "checked_simplices": len(sampled),
            "complex_s": t1 - t0, "values_s": t2 - t1,
            "diagram_s": time.perf_counter() - t2}


def verdict(readings: Dict[str, float]) -> bool:
    """Whether every number is within its limit."""
    return all(readings[k] <= LIMITS[k] for k in LIMITS)
