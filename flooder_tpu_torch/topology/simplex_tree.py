"""Columnar SimplexTree with a gudhi-compatible surface.

The reference leans on ``gudhi.SimplexTree`` (C++ pointer-tree) for
filtration bookkeeping and persistence (reference core.py:130-132, 278-288;
cli.py:466-479; tests use insert/assign_filtration/get_boundaries/
compute_persistence/persistence_intervals_in_dimension). This rebuild stores
the complex **columnarly** — one (n_d, d+1) int32 vertex array plus one
(n_d,) float64 filtration array per dimension, rows lex-sorted — so every
bulk operation (assembly from device output, monotonicity repair, boundary
matrix construction) is a handful of vectorized numpy calls, and the hot
persistence reduction runs in native C++ (``flooder_tpu_torch/native``).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.stagetimer import stage
from ._keys import find_rows, lex_order, row_keys
from .persistence import reduce_filtration


class SimplexTree:
    """A filtered simplicial complex over integer vertex ids."""

    def __init__(self):
        self._verts: List[np.ndarray] = []  # dim -> (n_d, d+1) int32 lex-sorted
        self._filt: List[np.ndarray] = []  # dim -> (n_d,) float64
        # Lazy op log: ("ins"|"asg", vertex-tuple, filtration). Single-simplex
        # mutations are queued and folded into the columnar store in one
        # vectorized pass, so the reference's insert/assign loops stay O(n).
        self._pending: List[Tuple[str, Tuple[int, ...], float]] = []
        self._pairs: Optional[np.ndarray] = None  # (m, 3): dim, birth, death
        self._maybe_non_monotone = False

    # -- construction -----------------------------------------------------

    @classmethod
    def from_columns(
        cls,
        verts_by_dim: Sequence[np.ndarray],
        filt_by_dim: Sequence[np.ndarray],
    ) -> "SimplexTree":
        """Bulk-build from per-dimension vertex/filtration arrays.

        Rows need not be sorted; duplicates are collapsed (first wins).
        """
        st = cls()
        for d, (v, f) in enumerate(zip(verts_by_dim, filt_by_dim)):
            v = np.asarray(v, dtype=np.int32).reshape(-1, d + 1)
            f = np.asarray(f, dtype=np.float64).reshape(-1)
            if v.shape[0] != f.shape[0]:
                raise ValueError("verts/filt length mismatch")
            v = np.sort(v, axis=1)
            keys = row_keys(v)
            uniq, first, _ = np.unique(keys, return_index=True, return_inverse=True)
            st._verts.append(np.ascontiguousarray(v[first]))
            st._filt.append(np.ascontiguousarray(f[first]))
        st._trim_empty_top()
        return st

    def _trim_empty_top(self):
        while self._verts and self._verts[-1].shape[0] == 0:
            self._verts.pop()
            self._filt.pop()

    def _flush(self):
        """Fold pending single-simplex ops into the columnar store."""
        if not self._pending:
            return
        pending = self._pending
        self._pending = []

        inserts: Dict[int, List[Tuple[Tuple[int, ...], float]]] = {}
        assigns: List[Tuple[Tuple[int, ...], float]] = []
        for op, simplex, filt in pending:
            if op == "ins":
                inserts.setdefault(len(simplex) - 1, []).append((simplex, filt))
            else:
                assigns.append((simplex, filt))

        if inserts:
            max_d = max(inserts)
            while len(self._verts) <= max_d:
                k = len(self._verts) + 1
                self._verts.append(np.empty((0, k), dtype=np.int32))
                self._filt.append(np.empty((0,), dtype=np.float64))
            for d, items in inserts.items():
                new_v = np.sort(
                    np.asarray([s for s, _ in items], dtype=np.int32).reshape(
                        -1, d + 1
                    ),
                    axis=1,
                )
                new_f = np.asarray([f for _, f in items], dtype=np.float64)
                # first occurrence wins among the new rows (gudhi insert is a
                # no-op for already-present simplices)
                keys = row_keys(new_v)
                _, first = np.unique(keys, return_index=True)
                new_v_u, new_f_u = new_v[first], new_f[first]
                existing = find_rows(self._verts[d], new_v_u)
                fresh = existing < 0
                if not np.any(fresh):
                    continue
                merged_v = np.concatenate([self._verts[d], new_v_u[fresh]], axis=0)
                merged_f = np.concatenate([self._filt[d], new_f_u[fresh]], axis=0)
                order = lex_order(merged_v)
                self._verts[d] = np.ascontiguousarray(merged_v[order])
                self._filt[d] = np.ascontiguousarray(merged_f[order])

        if assigns:
            by_dim: Dict[int, List[Tuple[Tuple[int, ...], float]]] = {}
            for simplex, filt in assigns:
                by_dim.setdefault(len(simplex) - 1, []).append((simplex, filt))
            for d, items in by_dim.items():
                if d >= len(self._verts):
                    raise KeyError(
                        f"assign_filtration on missing simplex {items[0][0]}"
                    )
                v = np.sort(
                    np.asarray([s for s, _ in items], dtype=np.int32).reshape(
                        -1, d + 1
                    ),
                    axis=1,
                )
                f = np.asarray([x for _, x in items], dtype=np.float64)
                pos = find_rows(self._verts[d], v)
                if np.any(pos < 0):
                    bad = v[pos < 0][0]
                    raise KeyError(
                        f"assign_filtration on missing simplex {tuple(bad)}"
                    )
                # later assigns win: positions repeated => np scatter applies
                # in index order, which is op order here
                self._filt[d][pos] = f
            self._maybe_non_monotone = True
        self._pairs = None

    # -- single-simplex ops (gudhi-compatible) ----------------------------

    def insert(self, simplex: Iterable[int], filtration: float = 0.0) -> None:
        """Insert a simplex and all its faces (faces inherit ``filtration``
        when absent). Present simplices keep their filtration (gudhi
        semantics). Lazy: folded into the columnar store on next read."""
        simplex = tuple(sorted(int(v) for v in simplex))
        for k in range(1, len(simplex) + 1):
            for face in itertools.combinations(simplex, k):
                self._pending.append(("ins", face, float(filtration)))
        self._pairs = None

    def find(self, simplex: Iterable[int]) -> bool:
        self._flush()
        simplex = tuple(sorted(int(v) for v in simplex))
        d = len(simplex) - 1
        if d < 0 or d >= len(self._verts):
            return False
        row = np.asarray(simplex, dtype=np.int32).reshape(1, -1)
        return bool(find_rows(self._verts[d], row)[0] >= 0)

    def filtration(self, simplex: Iterable[int]) -> float:
        self._flush()
        simplex = tuple(sorted(int(v) for v in simplex))
        d = len(simplex) - 1
        if d < 0 or d >= len(self._verts):
            raise KeyError(f"simplex {simplex} not in complex")
        row = np.asarray(simplex, dtype=np.int32).reshape(1, -1)
        pos = find_rows(self._verts[d], row)[0]
        if pos < 0:
            raise KeyError(f"simplex {simplex} not in complex")
        return float(self._filt[d][pos])

    def assign_filtration(self, simplex: Iterable[int], filtration: float) -> None:
        """Set the filtration value of an existing simplex (gudhi
        assign_filtration; reference flow core.py:278-279). Lazy: folded
        into the columnar store on next read; raises KeyError at that point
        if the simplex is absent."""
        simplex = tuple(sorted(int(v) for v in simplex))
        self._pending.append(("asg", simplex, float(filtration)))
        self._pairs = None

    def assign_filtrations(self, dim: int, verts: np.ndarray, values: np.ndarray):
        """Vectorized bulk assign: set filtration of many dim-``dim``
        simplices at once (rows absent from the complex are ignored).

        This replaces the reference's per-simplex Python dict/assign loop
        (core.py:258-279) with one searchsorted + scatter.
        """
        self._flush()
        if dim >= len(self._verts):
            return
        verts = np.sort(np.asarray(verts, dtype=np.int32).reshape(-1, dim + 1), axis=1)
        pos = find_rows(self._verts[dim], verts)
        ok = pos >= 0
        self._filt[dim][pos[ok]] = np.asarray(values, dtype=np.float64).reshape(-1)[ok]
        self._pairs = None
        self._maybe_non_monotone = True

    # -- iteration --------------------------------------------------------

    def get_simplices(self):
        """Yield (vertex_list, filtration) for every simplex."""
        self._flush()
        for d in range(len(self._verts)):
            v, f = self._verts[d], self._filt[d]
            vl = v.tolist()
            fl = f.tolist()
            for row, filt in zip(vl, fl):
                yield row, filt

    def get_filtration(self):
        """Yield (vertex_list, filtration) sorted by (filtration, dim)."""
        self._flush()
        order, dims, rows = self._filtration_order()
        for d, r in zip(dims, rows):
            yield self._verts[d][r].tolist(), float(self._filt[d][r])

    def get_boundaries(self, simplex: Iterable[int]):
        """Yield (facet_vertex_list, filtration) for each facet."""
        self._flush()
        simplex = tuple(sorted(int(v) for v in simplex))
        if len(simplex) <= 1:
            return
        for j in range(len(simplex)):
            face = simplex[:j] + simplex[j + 1 :]
            yield list(face), self.filtration(face)

    def get_skeleton(self, dimension: int):
        self._flush()
        for d in range(min(dimension, len(self._verts) - 1) + 1):
            v, f = self._verts[d], self._filt[d]
            for row, filt in zip(v.tolist(), f.tolist()):
                yield row, filt

    # -- stats ------------------------------------------------------------

    def num_simplices(self) -> int:
        self._flush()
        return int(sum(v.shape[0] for v in self._verts))

    def num_vertices(self) -> int:
        self._flush()
        return int(self._verts[0].shape[0]) if self._verts else 0

    def dimension(self) -> int:
        self._flush()
        return len(self._verts) - 1

    def upper_bound_dimension(self) -> int:
        return self.dimension()

    # -- filtration repair ------------------------------------------------

    def make_filtration_non_decreasing(self) -> bool:
        """Raise each simplex's filtration to at least the max of its facets
        (gudhi make_filtration_non_decreasing; the reference calls this after
        bulk assignment to repair grid-edge effects, core.py:280).

        NaN filtrations are treated as "unset" and replaced by the facet max.
        Vectorized: one facet-lookup + fmax pass per (dimension, facet slot).
        """
        self._flush()
        changed = False
        for d in range(1, len(self._verts)):
            v = self._verts[d]
            if v.shape[0] == 0:
                continue
            face_max = np.full(v.shape[0], -np.inf)
            for j in range(d + 1):
                facet = np.ascontiguousarray(np.delete(v, j, axis=1))
                pos = find_rows(self._verts[d - 1], facet)
                vals = np.where(pos >= 0, self._filt[d - 1][np.maximum(pos, 0)], -np.inf)
                vals = np.where(np.isnan(vals), -np.inf, vals)
                face_max = np.maximum(face_max, vals)
            cur = self._filt[d]
            new = np.where(np.isnan(cur), face_max, np.maximum(cur, face_max))
            new = np.where(np.isneginf(face_max), cur, new)
            if not np.array_equal(new, cur, equal_nan=True):
                changed = True
                self._filt[d] = new
                self._pairs = None
        self._maybe_non_monotone = False
        return changed

    # -- persistence ------------------------------------------------------

    def _filtration_order(self):
        """Global filtration order over all simplices.

        Returns:
            (order, dims, rows): ``order[i]`` is the global rank; ``dims``/
            ``rows`` give, for each rank, the (dimension, row) location.
        """
        filts = np.concatenate(self._filt) if self._filt else np.empty(0)
        dims = np.concatenate(
            [np.full(v.shape[0], d, dtype=np.int8) for d, v in enumerate(self._verts)]
        ) if self._verts else np.empty(0, dtype=np.int8)
        order = np.lexsort((dims, filts))
        # rows: local row index within each dim block
        local = np.concatenate(
            [np.arange(v.shape[0], dtype=np.int64) for v in self._verts]
        ) if self._verts else np.empty(0, dtype=np.int64)
        return order, dims[order], local[order]

    def compute_persistence(
        self, homology_coeff_field: int = 2, min_persistence: float = 0.0
    ) -> None:
        """Compute persistent homology (Z/2 reduction with twist/clearing).

        ``homology_coeff_field`` is accepted for gudhi API compatibility; the
        reduction is over Z/2 (diagrams over different fields coincide for
        the geometric complexes this library builds in low dimension).
        """
        with stage("persistence"):
            self._compute_persistence(homology_coeff_field, min_persistence)

    def _compute_persistence(self, homology_coeff_field: int,
                             min_persistence: float) -> None:
        if homology_coeff_field != 2:
            import warnings

            warnings.warn(
                f"homology_coeff_field={homology_coeff_field} requested but "
                "the reduction runs over Z/2; diagrams can differ in the "
                "presence of torsion",
                RuntimeWarning,
                stacklevel=3,
            )
        self._flush()
        self._min_persistence = float(min_persistence)
        n = self.num_simplices()
        if n == 0:
            self._pairs = np.empty((0, 3))
            return

        order, dims_sorted, rows_sorted = self._filtration_order()

        # global position of (dim, row)
        offsets = np.zeros(len(self._verts) + 1, dtype=np.int64)
        for d, v in enumerate(self._verts):
            offsets[d + 1] = offsets[d] + v.shape[0]
        rank_of_global = np.empty(n, dtype=np.int64)
        global_sorted = offsets[dims_sorted.astype(np.int64)] + rows_sorted
        rank_of_global[global_sorted] = np.arange(n, dtype=np.int64)

        # boundary CSR in filtration order
        col_counts = (dims_sorted.astype(np.int64) + 1) * (dims_sorted > 0)
        bnd_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(col_counts, out=bnd_offsets[1:])
        bnd_indices = np.empty(bnd_offsets[-1], dtype=np.int64)
        for d in range(1, len(self._verts)):
            v = self._verts[d]
            if v.shape[0] == 0:
                continue
            facet_ranks = np.empty((v.shape[0], d + 1), dtype=np.int64)
            for j in range(d + 1):
                facet = np.ascontiguousarray(np.delete(v, j, axis=1))
                pos = find_rows(self._verts[d - 1], facet)
                if np.any(pos < 0):
                    raise ValueError(
                        "complex is not closed under taking faces; "
                        "persistence is undefined"
                    )
                facet_ranks[:, j] = rank_of_global[offsets[d - 1] + pos]
            facet_ranks.sort(axis=1)
            # scatter into CSR at the ranks of these d-simplices
            ranks_here = rank_of_global[offsets[d] + np.arange(v.shape[0])]
            starts = bnd_offsets[ranks_here]
            idx = starts[:, None] + np.arange(d + 1)[None, :]
            bnd_indices[idx.reshape(-1)] = facet_ranks.reshape(-1)

        filts_sorted = np.concatenate(self._filt)[global_sorted]
        pairs, essential = reduce_filtration(
            dims_sorted.astype(np.int8), bnd_offsets, bnd_indices
        )

        rows = []
        if len(pairs):
            b, dth = pairs[:, 0], pairs[:, 1]
            rows.append(
                np.stack(
                    [
                        dims_sorted[b].astype(np.float64),
                        filts_sorted[b],
                        filts_sorted[dth],
                    ],
                    axis=1,
                )
            )
        if len(essential):
            rows.append(
                np.stack(
                    [
                        dims_sorted[essential].astype(np.float64),
                        filts_sorted[essential],
                        np.full(len(essential), np.inf),
                    ],
                    axis=1,
                )
            )
        self._pairs = (
            np.concatenate(rows, axis=0) if rows else np.empty((0, 3))
        )

    def _diagram(self) -> np.ndarray:
        if self._pairs is None:
            raise RuntimeError(
                "compute_persistence() must be called before accessing "
                "persistence results"
            )
        p = self._pairs
        keep = (p[:, 2] - p[:, 1]) > self._min_persistence
        keep |= np.isinf(p[:, 2])
        return p[keep]

    def persistence(
        self, homology_coeff_field: int = 2, min_persistence: float = 0.0
    ):
        """Compute and return the diagram as [(dim, (birth, death)), ...],
        sorted by decreasing persistence (gudhi convention)."""
        with stage("persistence"):
            self._compute_persistence(homology_coeff_field, min_persistence)
            p = self._diagram()
            pers = p[:, 2] - p[:, 1]
            order = np.argsort(-pers, kind="stable")
            return [
                (int(p[i, 0]), (float(p[i, 1]), float(p[i, 2])))
                for i in order
            ]

    def persistence_intervals_in_dimension(self, dimension: int) -> np.ndarray:
        p = self._diagram()
        sel = p[p[:, 0] == dimension][:, 1:3]
        return np.ascontiguousarray(sel) if len(sel) else np.empty((0, 2))

    def betti_numbers(self) -> List[int]:
        """Betti numbers of the final complex (count of essential classes)."""
        p = self._diagram()
        ess = p[np.isinf(p[:, 2])]
        if len(ess) == 0:
            return [0] * (self.dimension() + 1)
        out = [0] * (self.dimension() + 1)
        for d in ess[:, 0].astype(int):
            out[d] += 1
        return out

    # -- gudhi interop ------------------------------------------------------

    def to_gudhi(self):
        """Convert to a ``gudhi.SimplexTree`` (requires gudhi).

        The reference returns a gudhi SimplexTree directly
        (reference core.py:278-288), so its users can hand the result to
        any gudhi ecosystem function; this escape hatch restores that
        drop-in workflow. Inserting in increasing dimension order
        preserves every filtration value exactly: gudhi's ``insert``
        keeps the existing value of already-present faces, and all faces
        are present here by construction.
        """
        import gudhi  # hard dep of this method only

        self._flush()
        gst = gudhi.SimplexTree()
        for d, (v, f) in enumerate(zip(self._verts, self._filt)):
            if v.shape[0] == 0:
                continue
            if hasattr(gst, "insert_batch"):
                # (dim+1, n) vertex layout per gudhi's batch API
                gst.insert_batch(
                    np.ascontiguousarray(v.T, dtype=np.int32),
                    np.ascontiguousarray(f, dtype=np.float64),
                )
            else:  # pragma: no cover - gudhi < 3.5
                for row, val in zip(v.tolist(), f.tolist()):
                    gst.insert(row, float(val))
        return gst

    @classmethod
    def from_gudhi(cls, gst) -> "SimplexTree":
        """Build from a ``gudhi.SimplexTree`` (values copied verbatim)."""
        verts: Dict[int, List[Tuple[int, ...]]] = {}
        filts: Dict[int, List[float]] = {}
        for simplex, filt in gst.get_simplices():
            d = len(simplex) - 1
            verts.setdefault(d, []).append(tuple(simplex))
            filts.setdefault(d, []).append(float(filt))
        if not verts:
            return cls()
        max_d = max(verts)
        cols_v = [
            np.asarray(verts.get(d, []), dtype=np.int32).reshape(-1, d + 1)
            for d in range(max_d + 1)
        ]
        cols_f = [
            np.asarray(filts.get(d, []), dtype=np.float64)
            for d in range(max_d + 1)
        ]
        return cls.from_columns(cols_v, cols_f)

    def __repr__(self):
        self._flush()
        sizes = ", ".join(
            f"dim{d}:{v.shape[0]}" for d, v in enumerate(self._verts)
        )
        return f"SimplexTree({self.num_simplices()} simplices; {sizes})"
