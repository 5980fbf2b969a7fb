"""The plain reference of the Flood complex and its persistence.

Plain PyTorch, NumPy and SciPy (Qhull), written from the definition; it
imports nothing of the program, and takes nothing that the program made
except the outputs it judges. What it computes:

- ``fps``: exact greedy farthest-point sampling from a start index. In
  float32 it adds each squared distance coordinate by coordinate with a
  rounded multiply and a rounded add, the arithmetic the configuration
  states, so a tie in float32 is a tie here too. Exact ties do occur
  (two far-apart points of a 40M-point cloud at one float32 distance):
  any of the tied points is a greedy pick, so ``fps`` counts the ties of
  each step and ``tie_candidates`` names the tied points.
- ``delaunay_levels``: the Delaunay triangulation of the landmarks (Qhull,
  joggled on a degenerate input) and every face of it, by dimension.
- ``bounding_balls``: a simplex's ball, centred on the midpoint of its
  farthest vertex pair, radius the farthest vertex times 1.42 (1.01 for an
  edge) plus 1e-3.
- ``grid_weights``: the barycentric grid of ``points_per_edge`` points an
  edge.
- ``FloodIntervals``: for a simplex in grid mode, the filtration value as
  an interval: the max over its grid samples of the min distance to the
  witnesses in its ball, with the ball's boundary widened and narrowed by
  ``BAND`` of r^2 (a witness on the boundary may fall either way in
  float32); a face takes the min over its top-dimensional cofaces, and a
  simplex the max over its faces (the program makes its filtration
  non-decreasing).
- ``RandomIntervals``: the same in random mode, each simplex sampled at
  its own random barycentric points (``random_weights``, from the host
  seed the benchmark gave the program) in its own ball.
- ``diagram``: the persistence diagram of a filtered complex, by a Z/2
  column reduction with clearing on Python integers as bit columns.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.spatial import Delaunay, QhullError

# Relative band of r^2 around a ball's boundary (see FloodIntervals).
BAND = 1e-4
# Bytes of one block of the (samples x witnesses) distance matrix.
BLOCK_BYTES = 256 << 20


# ---------------------------------------------------------------------------
# farthest-point sampling
# ---------------------------------------------------------------------------


def _sq_dist_cols(cols: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Squared distances of the columns of ``cols`` (dim, N) to ``point``
    (dim,), added in coordinate order, one rounded operation each."""
    diff = cols - point[:, None]
    diff.mul_(diff)
    d2 = diff[0].clone()
    for j in range(1, diff.shape[0]):
        d2.add_(diff[j])
    return d2


def fps(points: torch.Tensor, n_samples: int, start_idx: int = 0,
        dtype: torch.dtype = torch.float32, count_updates: bool = False,
        forced: Optional[Dict[int, int]] = None):
    """Greedy FPS in ``dtype`` arithmetic; the first index wins a tie,
    except at the steps that ``forced`` maps to the index to take there.

    Returns (indices (n_samples,) int64, updates, ties, values), all on
    the points' device: ``updates`` counts the (step, point) pairs whose
    running minimum fell (None unless ``count_updates``); ``ties[i]`` is how
    many points shared step i's largest minimum (1: no tie), and
    ``values[i]`` is that minimum (0 at the start).
    """
    forced = forced or {}
    cols = points.t().to(dtype).contiguous()
    dev = points.device
    idx = torch.empty(n_samples, dtype=torch.int64, device=dev)
    idx[0] = int(start_idx)
    ties = torch.ones(n_samples, dtype=torch.int64, device=dev)
    values = torch.zeros(n_samples, dtype=dtype, device=dev)
    mind = _sq_dist_cols(cols, cols[:, int(start_idx)])
    updates = (torch.full((), points.shape[0], dtype=torch.int64, device=dev)
               if count_updates else None)
    for i in range(1, n_samples):
        nxt = (torch.argmax(mind) if i not in forced
               else torch.tensor(forced[i], device=dev))
        idx[i] = nxt
        top = mind.index_select(0, nxt.view(1))
        values[i:i + 1] = top
        ties[i] = (mind == top).sum()
        d2 = _sq_dist_cols(cols, torch.index_select(cols, 1, nxt.view(1))[:, 0])
        if count_updates:
            updates += (d2 < mind).sum()
        torch.minimum(mind, d2, out=mind)
    return idx, updates, ties, values


def tie_candidates(points: torch.Tensor, picks: torch.Tensor,
                   steps: Sequence[int]) -> Dict[int, List[int]]:
    """For each of ``steps``, the points that shared that step's largest
    running minimum, after the picks before it (float32, as ``fps``)."""
    cols = points.t().contiguous()
    out: Dict[int, List[int]] = {}
    mind = _sq_dist_cols(cols, cols[:, int(picks[0])])
    for i in range(1, max(steps) + 1):
        if i in steps:
            at_max = mind == torch.amax(mind)
            out[i] = sorted(torch.nonzero(at_max).flatten().tolist())
        d2 = _sq_dist_cols(cols, torch.index_select(cols, 1, picks[i].view(1))[:, 0])
        torch.minimum(mind, d2, out=mind)
    return out


# ---------------------------------------------------------------------------
# Delaunay complex
# ---------------------------------------------------------------------------


def delaunay_cells(landmarks: np.ndarray) -> np.ndarray:
    """Top cells (n_cells, d + 1) of the landmarks' Delaunay
    triangulation, each row sorted; Qhull is joggled if it refuses the
    input, and at most d + 1 points are one simplex."""
    pts = np.asarray(landmarks, dtype=np.float64)
    n, d = pts.shape
    if n <= d + 1:
        return np.arange(n, dtype=np.int64).reshape(1, -1)
    try:
        tri = Delaunay(pts)
    except QhullError:
        tri = Delaunay(pts, qhull_options="QJ")
    return np.sort(tri.simplices.astype(np.int64), axis=1)


def delaunay_levels(cells: np.ndarray) -> List[np.ndarray]:
    """Every face of the cells, by dimension: ``out[d]`` is the (n_d, d+1)
    array of unique sorted rows, in lexicographic order."""
    k = cells.shape[1]
    out = []
    for d in range(k):
        faces = np.concatenate(
            [cells[:, list(c)] for c in itertools.combinations(range(k), d + 1)])
        out.append(np.unique(faces, axis=0))
    return out


# ---------------------------------------------------------------------------
# balls and grids
# ---------------------------------------------------------------------------


def bounding_balls(verts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balls of simplices ``verts`` (S, k, dim) float32: the farthest
    vertex pair is picked in float32 (coordinate-order sums, the first pair
    on a tie), the centre and radius are float64."""
    s, k, _ = verts.shape
    diff = verts[:, :, None, :] - verts[:, None, :, :]
    d2 = diff[..., 0] * diff[..., 0]
    for j in range(1, verts.shape[-1]):
        d2 = d2 + diff[..., j] * diff[..., j]
    flat = torch.argmax(d2.reshape(s, k * k), dim=1)
    i0, i1 = flat // k, flat % k
    rows = torch.arange(s, device=verts.device)
    v64 = verts.double()
    centres = (v64[rows, i0] + v64[rows, i1]) / 2.0
    radial = torch.linalg.vector_norm(v64 - centres[:, None, :], dim=-1)
    factor = 1.42 if k - 1 > 1 else 1.01
    return centres, radial.amax(dim=1) * factor + 1e-3


def grid_weights(points_per_edge: int, k: int) -> np.ndarray:
    """Barycentric grid (R, k) float64 on a simplex of ``k`` vertices:
    every vector of ``k`` non-negative integers summing to
    ``points_per_edge - 1``, over ``points_per_edge - 1``."""
    m = points_per_edge - 1
    rows = []
    for bars in itertools.combinations(range(m + k - 1), k - 1):
        edges = (-1,) + bars + (m + k - 1,)
        rows.append([edges[j + 1] - edges[j] - 1 for j in range(k)])
    return np.asarray(rows, dtype=np.float64) / m


# ---------------------------------------------------------------------------
# flood values as intervals
# ---------------------------------------------------------------------------


def _morton_order(points: np.ndarray) -> np.ndarray:
    """An order of ``points`` (R, dim) along a Morton curve over their box,
    so that runs of it are compact."""
    r, dim = points.shape
    bits = max(1, min(10, 63 // max(dim, 1)))
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-300) * ((1 << bits) - 1))
    q = q.astype(np.int64)
    code = np.zeros(r, dtype=np.int64)
    for bit in range(bits):
        for j in range(dim):
            code |= ((q[:, j] >> bit) & 1) << (bit * dim + j)
    return np.argsort(code, kind="stable")


class _Witnesses:
    """The cloud in a binned index, and the distances from samples to the
    witnesses of a ball.

    The index bins the first dim - 1 coordinates on a grid whose cells are
    half the landmarks' mean spacing wide, and sorts each bin's points by
    the last coordinate, so a ball's witnesses are among those of a few
    runs of the sorted cloud: one run a bin of the ball's box, cut to the
    box on the last coordinate by a binary search.

    ``minima`` takes the balls ``JOBS`` at a time. In float64 the minima
    are exact and pruned: the samples go in tiles of ``TILE`` along a
    Morton curve; a probe of every ``PROBE``-th inner witness bounds each
    sample's distance from above; a tile then meets only the witnesses
    inside its box widened by its largest bound, which hold every sample's
    nearest witness and nearest inner witness.

    Args:
        cloud: (N, dim) float32 witnesses on the device.
        landmarks: (L, dim) float32 landmark coordinates (cloud rows).
        dtype: the arithmetic of the distances (float64 for the
            reference, bfloat16 for the control, which is not pruned).
    """

    MAX_BINS = 1 << 20
    TILE = 128
    PROBE = 32
    # balls a chunk, and (tiles x witnesses) a group of tiles
    JOBS = 48
    PAIRS = 1 << 22

    def __init__(self, cloud, landmarks, dtype=torch.float64):
        self.dev = cloud.device
        self.dtype = dtype
        self.landmarks = landmarks
        self.lms = landmarks.double().cpu().numpy()
        c64 = cloud.double()
        lo = c64.amin(0)
        extent = (c64.amax(0) - lo).clamp_(min=1e-12)
        dim = cloud.shape[1]
        spacing = float(extent.prod() / max(len(landmarks), 1)) ** (1.0 / dim)
        self.grid = 1
        if dim > 1:
            cap = int(self.MAX_BINS ** (1.0 / (dim - 1)))
            self.grid = max(1, min(cap, int(float(extent[:-1].max())
                                            / (spacing / 2.0))))
        self.lo = lo.cpu().numpy()
        self.width = (extent[:-1] / self.grid).cpu().numpy()
        self.top = float(extent[-1])
        b = ((c64[:, :-1] - lo[:-1]) / torch.as_tensor(
            self.width, device=self.dev)).floor_().long().clamp_(0, self.grid - 1)
        bins = torch.zeros(cloud.shape[0], dtype=torch.int64, device=self.dev)
        for j in range(dim - 1):
            bins = bins * self.grid + b[:, j]
        key = bins.double() + self._frac(c64[:, -1])
        self.key, perm = torch.sort(key)
        self.sorted = cloud[perm]

    def _frac(self, last):
        """The last coordinate mapped monotonically into [0, 0.5]."""
        return ((last - self.lo[-1]) / self.top).clip(0.0, 1.0) * 0.5

    def _box_queries(self, c: np.ndarray, reach: float):
        """Keys bounding the runs of the sorted cloud in the box of
        half-side ``reach`` around ``c`` (host float64): one run a bin."""
        bins = np.zeros(1, dtype=np.int64)
        for j in range(len(c) - 1):
            a, z = (np.floor((c[j] + np.array([-reach, reach]) - self.lo[j])
                             / self.width[j]).astype(np.int64)
                    .clip(0, self.grid - 1))
            bins = (bins[:, None] * self.grid
                    + np.arange(a, z + 1)[None, :]).reshape(-1)
        f0, f1 = self._frac(np.array([c[-1] - reach, c[-1] + reach]))
        return bins + f0, bins + f1

    def minima(self, jobs: Sequence[Tuple[np.ndarray, float, np.ndarray]]
               ) -> List[np.ndarray]:
        """For each ball (``c``, ``r``) and its ball-local samples
        ``local`` (R, dim) float64 of ``jobs``: (R, 2) the min squared
        distances of the samples over the ball's witnesses (lo) and over
        those inside the ball narrowed by ``BAND`` (hi)."""
        out: List[np.ndarray] = []
        for a in range(0, len(jobs), self.JOBS):
            out.extend(self._chunk(jobs[a:a + self.JOBS]))
        return out

    def _chunk(self, jobs) -> List[np.ndarray]:
        """``minima`` of a few balls at once."""
        dev, f64, inf = self.dev, torch.float64, float("inf")
        n_j, dim = len(jobs), jobs[0][2].shape[1]
        # the balls' witnesses, ball-local and grouped by ball
        q0, q1, qj = [], [], []
        for j, (c, r, _) in enumerate(jobs):
            b0, b1 = self._box_queries(c, r * (1.0 + BAND) + 1e-12)
            q0.append(b0)
            q1.append(b1)
            qj.append(np.full(len(b0), j))
        q = torch.as_tensor(np.stack([np.concatenate(q0), np.concatenate(q1)]),
                            device=dev)
        first = torch.searchsorted(self.key, q[0])
        n = torch.searchsorted(self.key, q[1], right=True) - first
        total = int(n.sum())
        rows = (torch.repeat_interleave(first - (torch.cumsum(n, 0) - n), n,
                                        output_size=total)
                + torch.arange(total, device=dev))
        job = torch.repeat_interleave(torch.as_tensor(np.concatenate(qj),
                                                      device=dev), n,
                                      output_size=total)
        centres = torch.as_tensor(np.stack([c for c, _, _ in jobs]), device=dev)
        r2 = torch.as_tensor([r * r for _, r, _ in jobs], device=dev, dtype=f64)
        w = self.sorted[rows].double() - centres[job]
        d2c = (w * w).sum(1)
        keep = d2c <= r2[job] * (1.0 + BAND)
        w, d2c, job = w[keep], d2c[keep], job[keep]
        inner = d2c <= r2[job] * (1.0 - BAND)
        if self.dtype != f64:
            counts = torch.bincount(job, minlength=n_j).tolist()
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            return [self._plain(torch.as_tensor(local, device=dev),
                                w[s0:s0 + k], inner[s0:s0 + k]).cpu().numpy()
                    for (_, _, local), s0, k in zip(jobs, starts, counts)]
        b_hi = d2c.masked_fill(~inner, inf)
        wcount = torch.bincount(job, minlength=n_j)
        wstart = torch.cumsum(wcount, 0) - wcount
        # the samples in tiles along a Morton curve, ball by ball
        tiles, tile_job, orders = [], [], []
        for j, (_, _, local) in enumerate(jobs):
            order = _morton_order(local)
            n_t = -(-len(order) // self.TILE)
            slots = np.concatenate([order, np.repeat(order[-1:], n_t
                                                     * self.TILE - len(order))])
            tiles.append(local[slots].reshape(n_t, self.TILE, dim))
            tile_job.append(np.full(n_t, j))
            orders.append(order)
        tiles_h = np.concatenate(tiles)
        tile_job_h = np.concatenate(tile_job)
        s = torch.as_tensor(tiles_h, device=dev)
        s2 = (s * s).sum(-1)
        box = torch.as_tensor(np.stack([tiles_h.min(1), tiles_h.max(1)], 1),
                              device=dev)
        tj = torch.as_tensor(tile_job_h, device=dev)
        res = torch.full((len(tiles_h), self.TILE, 2), inf, device=dev,
                         dtype=f64)
        wcount_h = wcount.cpu().numpy()
        per_tile = wcount_h[tile_job_h]
        by_width = np.argsort(-per_tile, kind="stable")
        at = 0
        while at < len(by_width) and per_tile[by_width[at]] > 0:
            width = int(per_tile[by_width[at]])
            part = by_width[at:at + max(1, self.PAIRS // width)]
            at += len(part)
            self._tiles(torch.as_tensor(part, device=dev), width, s, s2, box,
                        w, d2c, b_hi, wstart[tj[torch.as_tensor(part,
                                                                device=dev)]],
                        wcount[tj[torch.as_tensor(part, device=dev)]], res)
        res_h = res.cpu().numpy()
        out, t0 = [], 0
        for order, t in zip(orders, tiles):
            got = np.empty((len(order), 2))
            got[order] = res_h[t0:t0 + len(t)].reshape(-1, 2)[:len(order)]
            out.append(got)
            t0 += len(t)
        return out

    def _tiles(self, t, width, s, s2, box, w, d2c, b_hi, start, count, res):
        """Exact minima of the tiles ``t``, whose balls' witnesses are
        ``w[start:start + count]`` (at most ``width``), into ``res``."""
        inf = float("inf")
        dev = self.dev
        # an upper bound of each sample's distance: every PROBE-th witness
        k = torch.arange(0, width, self.PROBE, device=dev)
        valid = k[None, :] < count[:, None]
        idx = torch.where(valid, start[:, None] + k[None, :], 0)
        bias = b_hi[idx].masked_fill_(~valid, inf)[:, None, :]
        ub = torch.baddbmm(bias, s[t], w[idx].transpose(1, 2),
                           alpha=-2.0).amin(2)
        ub = (ub + s2[t]).clamp_(min=0.0).amax(1)
        reach = (ub.sqrt() * (1.0 + 1e-9) + 1e-12)[:, None]
        lo_box, hi_box = box[t, 0] - reach, box[t, 1] + reach
        # the witnesses in each tile's box widened by its bound
        k = torch.arange(width, device=dev)
        valid = k[None, :] < count[:, None]
        idx = torch.where(valid, start[:, None] + k[None, :], 0)
        wt = w[idx]
        near = valid & ((wt >= lo_box[:, None, :])
                        & (wt <= hi_box[:, None, :])).all(-1)
        hits = near.sum(1)
        keep_idx = idx[near]
        n_h = hits.cpu().numpy()
        h_start = torch.cumsum(hits, 0) - hits
        order = np.argsort(-n_h, kind="stable")
        at = 0
        while at < len(order):
            wid = int(n_h[order[at]])
            part = order[at:at + max(1, BLOCK_BYTES // (8 * self.TILE
                                                       * max(wid, 1)))]
            at += len(part)
            pt = torch.as_tensor(part, device=dev)
            kk = torch.arange(wid, device=dev)
            ok = kk[None, :] < hits[pt][:, None]
            ii = keep_idx[torch.where(ok, h_start[pt][:, None] + kk[None, :],
                                      0)]
            wv = w[ii].transpose(1, 2)
            for col, b in ((0, d2c), (1, b_hi)):
                bb = b[ii].masked_fill_(~ok, inf)[:, None, :]
                m = torch.baddbmm(bb, s[t[pt]], wv, alpha=-2.0).amin(2)
                res[t[pt], :, col] = (m + s2[t[pt]]).clamp_(min=0.0)

    def _plain(self, s, w, inner) -> torch.Tensor:
        """(R, 2) minima over every witness, in ``dtype``: the control's
        differences and squares in its own type."""
        s, w = s.to(self.dtype), w.to(self.dtype)
        lo = torch.full((s.shape[0],), float("inf"), device=self.dev,
                        dtype=torch.float64)
        hi = lo.clone()
        step = max(1, BLOCK_BYTES // (8 * max(s.shape[0], 1)))
        for a in range(0, w.shape[0], step):
            diff = s[:, None, :] - w[None, a:a + step, :]
            d2 = (diff * diff).sum(-1).double()
            torch.minimum(lo, d2.amin(1), out=lo)
            d2.masked_fill_(~inner[None, a:a + step], float("inf"))
            torch.minimum(hi, d2.amin(1), out=hi)
        return torch.stack([lo, hi], 1)


def _balls(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``bounding_balls`` of simplices ``verts`` (S, k, dim), on the host."""
    c, r = bounding_balls(torch.as_tensor(verts, dtype=torch.float32))
    return c.numpy(), r.numpy()


def _faces(s: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """Every face of ``s`` with two vertices or more, ``s`` included."""
    return [f for m in range(2, len(s) + 1)
            for f in itertools.combinations(s, m)]


class FloodIntervals(_Witnesses):
    """Filtration values of a cloud's Flood complex in grid mode, as
    intervals.

    Args:
        cloud: (N, dim) float32 witnesses on the device.
        landmarks: (L, dim) float32 landmark coordinates (cloud rows).
        cells: (n_cells, dim + 1) top cells, rows sorted.
        points_per_edge: the grid's points an edge.
        dtype: the arithmetic of the distances (float64 for the
            reference, bfloat16 for the control).
    """

    def __init__(self, cloud, landmarks, cells, points_per_edge: int,
                 dtype=torch.float64):
        super().__init__(cloud, landmarks, dtype)
        self.cells = cells
        self.k = cells.shape[1]
        self.weights = grid_weights(points_per_edge, self.k)
        self.centres, self.radii = _balls(
            landmarks.float().cpu().numpy()[cells])
        self.of_vertex: Dict[int, set] = {}
        for i, row in enumerate(cells.tolist()):
            for v in row:
                self.of_vertex.setdefault(v, set()).add(i)
        self._facemax: Dict[Tuple[int, Tuple[int, ...]], Tuple[float, float]] = {}

    def _cofaces(self, face: Tuple[int, ...]) -> List[int]:
        return sorted(set.intersection(*(self.of_vertex.get(v, set())
                                         for v in face)))

    def _job(self, cell: int, faces: Sequence[Tuple[int, ...]]):
        """The rows of ``faces``' samples in ``cell``'s grid, each face's
        rows, and the ball job of those samples."""
        verts = self.cells[cell].tolist()
        rows_of = []
        for f in faces:
            off = [j for j, v in enumerate(verts) if v not in f]
            rows_of.append(np.flatnonzero(
                (self.weights[:, off] == 0).all(axis=1)))
        rows = np.unique(np.concatenate(rows_of))
        centre = self.centres[cell]
        local = self.weights[rows] @ (self.lms[verts] - centre)
        return rows, rows_of, (centre, float(self.radii[cell]), local)

    def values(self, simplices: Sequence[Tuple[int, ...]]):
        """(lo, hi) bounds of each simplex's filtration value (a
        distance): the max over its faces of their raw values, where a
        face's raw value is the min over its top cofaces of the max over
        its samples in the coface's ball. A vertex is a witness inside
        every ball that holds it, so its raw value is 0."""
        simplices = [tuple(sorted(s)) for s in simplices]
        faces_of = {s: _faces(s) for s in simplices}
        cofaces = {f: self._cofaces(f)
                   for f in {f for fs in faces_of.values() for f in fs}}
        by_cell: Dict[int, List[Tuple[int, ...]]] = {}
        for f, cells in cofaces.items():
            for cell in cells:
                if (cell, f) not in self._facemax:
                    by_cell.setdefault(cell, []).append(f)
        jobs = {c: self._job(c, fs) for c, fs in by_cell.items()}
        got_all = self.minima([job for _, _, job in jobs.values()])
        for (cell, (rows, rows_of, _)), got in zip(jobs.items(), got_all):
            for f, r in zip(by_cell[cell], rows_of):
                m = got[np.searchsorted(rows, r)].max(0)
                self._facemax[(cell, f)] = (float(m[0]), float(m[1]))
        out = []
        for s in simplices:
            lo = hi = 0.0
            for f in faces_of[s]:
                if not cofaces[f]:
                    lo = hi = float("inf")
                    continue
                lo = max(lo, min(self._facemax[(c, f)][0] for c in cofaces[f]))
                hi = max(hi, min(self._facemax[(c, f)][1] for c in cofaces[f]))
            out.append((float(np.sqrt(lo)), float(np.sqrt(hi))))
        return out


def random_weights(host_seed: int, num_rand: int,
                   dims: Sequence[int]) -> Dict[int, np.ndarray]:
    """The random mode's barycentric samples (num_rand, d + 1) float64 of
    each simplex dimension d of ``dims`` (in increasing order, as the
    passes run), drawn from a numpy ``RandomState(host_seed)``: uniform
    on the simplex as normalised exponentials ``-log(1 - U)``, one draw of
    ``(num_rand, d + 1)`` a dimension past 0. A vertex is its own single
    sample."""
    rs = np.random.RandomState(int(host_seed))
    out = {}
    for d in sorted(dims):
        if d == 0:
            out[d] = np.ones((num_rand, 1))
            continue
        w = -np.log(1.0 - rs.rand(num_rand, d + 1))
        out[d] = w / w.sum(axis=1, keepdims=True)
    return out


class RandomIntervals(_Witnesses):
    """Filtration values of a cloud's Flood complex in random mode, as
    intervals: each simplex's raw value is the max over its own random
    samples of the min distance to the witnesses in its own ball; its
    value is the max over its faces' raw values (a vertex's is 0).

    Args:
        cloud, landmarks, dtype: as ``FloodIntervals``.
        weights: {d: (R, d + 1)} the samples of each dimension
            (``random_weights``).
    """

    def __init__(self, cloud, landmarks, weights: Dict[int, np.ndarray],
                 dtype=torch.float64):
        super().__init__(cloud, landmarks, dtype)
        self.weights = weights
        self._raw: Dict[Tuple[int, ...], Tuple[float, float]] = {}

    def values(self, simplices: Sequence[Tuple[int, ...]]):
        """(lo, hi) bounds of each simplex's filtration value."""
        simplices = [tuple(sorted(s)) for s in simplices]
        todo = sorted({f for s in simplices for f in _faces(s)}
                      - set(self._raw), key=len)
        lms32 = self.landmarks.float().cpu().numpy()
        jobs = []
        for k in sorted({len(f) for f in todo}):
            faces = [f for f in todo if len(f) == k]
            centres, radii = _balls(lms32[np.asarray(faces)])
            jobs += [(c, float(r), self.weights[k - 1] @ (self.lms[list(f)] - c))
                     for f, c, r in zip(faces, centres, radii)]
        for f, got in zip(todo, self.minima(jobs)):
            m = got.max(0)
            self._raw[f] = (float(m[0]), float(m[1]))
        out = []
        for s in simplices:
            lo = hi = 0.0
            for f in _faces(s):
                lo, hi = max(lo, self._raw[f][0]), max(hi, self._raw[f][1])
            out.append((float(np.sqrt(lo)), float(np.sqrt(hi))))
        return out


def intervals(cloud, landmarks, cells, levels, sampling: dict,
              dtype=torch.float64):
    """The intervals of a cloud's values under a traffic mix's sampling:
    ``{"mode": "grid", "points_per_edge": n}`` or ``{"mode": "random",
    "num_rand": n, "host_seed": s}``."""
    if sampling["mode"] == "grid":
        return FloodIntervals(cloud, landmarks, cells,
                              int(sampling["points_per_edge"]), dtype)
    dims = [d for d, lv in enumerate(levels) if len(lv)]
    return RandomIntervals(cloud, landmarks, random_weights(
        sampling["host_seed"], int(sampling["num_rand"]), dims), dtype)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def diagram(simplices: Iterable[Tuple[Sequence[int], float]]) -> Counter:
    """Persistence diagram of a filtered complex over Z/2, as a multiset
    of (dim, birth, death): pairs of positive persistence and the
    essential classes (death inf). ``simplices`` are (vertices, value);
    the order is by value, then dimension, then vertices."""
    items = sorted(((float(f), len(v) - 1, tuple(sorted(v)))
                    for v, f in simplices))
    rank = {s: i for i, (_, _, s) in enumerate(items)}
    values = [f for f, _, _ in items]
    dims = [d for _, d, _ in items]
    top = max(dims) if dims else 0
    pivot_of: Dict[int, int] = {}
    columns: Dict[int, int] = {}
    cleared = set()
    paired = set()
    pairs = []
    for d in range(top, 0, -1):
        for j, (_, dj, s) in enumerate(items):
            if dj != d or j in cleared:
                continue
            col = 0
            for m in range(len(s)):
                col |= 1 << rank[s[:m] + s[m + 1:]]
            while col:
                low = col.bit_length() - 1
                p = pivot_of.get(low)
                if p is None:
                    break
                col ^= columns[p]
            if col:
                low = col.bit_length() - 1
                pivot_of[low] = j
                columns[j] = col
                cleared.add(low)
                paired.update((low, j))
                pairs.append((low, j))
    out = Counter()
    for b, j in pairs:
        if values[j] - values[b] > 0:
            out[(dims[b], values[b], values[j])] += 1
    for i in range(len(items)):
        if i not in paired:
            out[(dims[i], values[i], float("inf"))] += 1
    return out
