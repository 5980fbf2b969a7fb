"""Simplex bounding balls and the dense flood engine (plain PyTorch).

Counterpart of ``flooder_tpu.ops.flood``. ``simplex_bounding_balls`` feeds
every engine. The dense engine (``DenseFloodEngine``, with
``flood_min_distances`` and ``batch_windows``) is the reference's route
for ``use_pallas=False`` and for float64 clouds: witnesses sorted along
the widest axis and padded to whole chunks of ``wchunk`` with
``WITNESS_PAD``; per batch of simplices a window of that sorted axis,
rounded down to a chunk; per chunk of the window a masked min over the
witnesses in each simplex's ball. In the reference it is one ``jax.jit``
with ``lax.scan`` and ``fori_loop``, not a Pallas kernel, so here it is
torch ops, on the card for a CUDA cloud. A CPU cloud of at most 16
coordinates runs the native reduction ``native/src/flood_cpu.cpp``
instead, a CPU cloud of more the torch ops: the reference's routing by
dimension. A failed native build or a nonzero return code raises (the
reference falls back to its XLA path without a word).

Every distance is the coordinate-difference form on ball-local
coordinates, ``sum_i (x_i - y_i)^2`` added in coordinate order; the
expanded |x|^2 - 2x.y + |y|^2 is never used. Sample points are an explicit
weighted sum of the ball-local vertices, not a matmul, so no TF32 setting
can touch them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

# Coordinate used to pad the witness array: far enough that padded rows
# fail every ball test, small enough that its square stays finite in fp32.
WITNESS_PAD = 1.0e15
# The native reduction takes at most this many coordinates
# (flood_cpu.cpp's kMaxDim); past it a CPU cloud runs the torch ops.
NATIVE_MAX_DIM = 16
# Cap of the (B, R, C) distance intermediate, and of the native path's
# (B, dim, R) samples, in bytes.
INTERMEDIATE_BYTES = 256 << 20


def _sqsum(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, added in coordinate order with a
    separate multiply and add (the kernels' order and rounding)."""
    s = x[..., 0] * x[..., 0]
    for d in range(1, x.shape[-1]):
        s = s + x[..., d] * x[..., d]
    return s


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
    s, k, _ = v.shape
    d2 = _sqsum(v[:, :, None, :] - v[:, None, :, :])
    flat_idx = torch.argmax(d2.reshape(s, k * k), dim=1)
    i0, i1 = flat_idx // k, flat_idx % k
    rows = torch.arange(s, device=v.device)
    centers = (v[rows, i0] + v[rows, i1]) / 2.0
    radial = torch.linalg.vector_norm(v - centers[:, None, :], dim=-1)
    factor = 1.42 if (k - 1) > 1 else 1.01
    radii = torch.amax(radial, dim=1) * factor + 1e-3
    return centers, radii


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def local_samples(verts_local: torch.Tensor, weights: torch.Tensor):
    """(B, R, dim) sample points in ball-local coordinates: the barycentric
    weights (R, k) times the ball-local vertices (B, k, dim), summed over k
    in order. The weights sum to 1, so this is samples - center, computed at
    the ball's scale instead of the cloud's."""
    w = weights[None, :, :, None]  # (1, R, k, 1)
    v = verts_local[:, None, :, :]  # (B, 1, k, dim)
    out = w[:, :, 0] * v[:, :, 0]
    for j in range(1, weights.shape[1]):
        out = out + w[:, :, j] * v[:, :, j]
    return out


def _masked_chunk_min(x_local, r2, bcent, w_chunk, acc):
    """Fold witnesses ``w_chunk`` (C, dim) into the running (B, R) min-d²
    ``acc``: d² from each ball-local sample (B, R, dim) to each witness
    inside the simplex's ball (|w - c|² <= r2), +inf for the others."""
    y_local = w_chunk[None, :, :] - bcent[:, None, :]  # (B, C, dim)
    outside = _sqsum(y_local) > r2[:, None]  # (B, C)
    d2 = x_local[:, :, None, 0] - y_local[:, None, :, 0]
    d2.mul_(d2)
    diff = torch.empty_like(d2)
    for i in range(1, y_local.shape[-1]):
        torch.sub(x_local[:, :, None, i], y_local[:, None, :, i], out=diff)
        d2.add_(diff.mul_(diff))
    d2.masked_fill_(outside[:, None, :], float("inf"))
    return torch.minimum(acc, d2.amin(-1))


def flood_min_distances(verts, weights, centers, radii, witnesses, imin,
                        imax, wchunk: int = 2048):
    """Min distance from every simplex sample point to the witnesses in the
    simplex's bounding ball (+inf where the ball holds none).

    Args:
        verts: (nb, B, k, d) batched simplex vertex coordinates.
        weights: (R, k) barycentric sample weights (grid or random).
        centers: (nb, B, d) bounding-ball centers.
        radii: (nb, B) bounding-ball radii.
        witnesses: (W, d) witnesses sorted along the widest axis, padded to
            a multiple of ``wchunk`` with ``WITNESS_PAD``.
        imin / imax: (nb,) per-batch window bounds into ``witnesses``
            (``batch_windows``).
        wchunk: witness chunk length.

    Returns:
        (nb, B, R) distances. Each batch first keeps the witnesses of its
        window that lie in at least one of its balls (the others give +inf
        to every sample), then folds them in pieces of as many chunks as
        keep the (B, R, piece) intermediate within ``INTERMEDIATE_BYTES``.
    """
    nb, bsz, _, _ = verts.shape
    r_count = weights.shape[0]
    out = torch.empty((nb, bsz, r_count), dtype=witnesses.dtype,
                      device=witnesses.device)
    per_chunk = bsz * r_count * wchunk * witnesses.element_size()
    piece = wchunk * max(1, INTERMEDIATE_BYTES // max(1, per_chunk))
    windows = zip(imin.tolist(), imax.tolist())  # one device sync
    for b, (lo, hi) in enumerate(windows):
        x_local = local_samples(verts[b] - centers[b][:, None, :], weights)
        r2 = radii[b] * radii[b]
        acc = torch.full((bsz, r_count), float("inf"),
                         dtype=witnesses.dtype, device=witnesses.device)
        win = witnesses[lo:lo + max(0, -(-(hi - lo) // wchunk)) * wchunk]
        in_some_ball = (
            _sqsum(win[None, :, :] - centers[b][:, None, :]) <= r2[:, None]
        ).any(0)
        win = win[in_some_ball]  # one device sync
        for s in range(0, win.shape[0], piece):
            acc = _masked_chunk_min(x_local, r2, centers[b], win[s:s + piece],
                                    acc)
        out[b] = torch.sqrt(acc)
    return out


def batch_windows(centers_axis, radii, witness_axis, wchunk: int = 2048):
    """Per-batch witness windows along the sorted axis: for each batch of
    simplices (rows of ``centers_axis`` / ``radii``, (nb, B)), the index
    range of the witnesses whose sorted coordinate lies within
    [min(center - r), max(center + r)], its start rounded down to a chunk.

    Returns (imin, imax), (nb,) int64 each.
    """
    vmin = torch.amin(centers_axis - radii, dim=1)
    vmax = torch.amax(centers_axis + radii, dim=1)
    imin = torch.searchsorted(witness_axis, vmin, side="left")
    imax = torch.searchsorted(witness_axis, vmax, side="right")
    return (imin // wchunk) * wchunk, imax


def _pad_rows(arr: torch.Tensor, total: int) -> torch.Tensor:
    """Pad to ``total`` rows by repeating the last row."""
    if arr.shape[0] == total:
        return arr
    reps = arr[-1:].expand(total - arr.shape[0], *arr.shape[1:])
    return torch.cat([arr, reps], dim=0)


class AxisSortedEngine:
    """What the dense engines share: witnesses sorted along their widest
    axis ``mrd`` in chunks of ``wchunk``, and the engine interface of
    ``CudaFloodEngine`` on top of their ``min_distances``."""

    def order(self, centers: torch.Tensor) -> np.ndarray:
        """Processing order of the simplices: by center along the sorted
        axis, so a batch's window stays narrow."""
        key = centers[:, self.mrd].detach().cpu().numpy()
        return np.argsort(key, kind="stable")

    def _weights(self, weights) -> torch.Tensor:
        if not isinstance(weights, torch.Tensor):
            weights = torch.as_tensor(np.asarray(weights))
        return weights.to(dtype=self.dtype, device=self.witnesses.device)

    def _batch_size(self, num: int, batch_size: Optional[int],
                    r_count: int) -> int:
        """Simplices a batch: ``batch_size`` (None: all) clamped to [1,
        num], and small enough that one chunk's (B, R, C) intermediate
        stays within ``INTERMEDIATE_BYTES``."""
        bsz = num if batch_size is None else int(batch_size)
        bsz = max(1, min(bsz, num))
        max_b = INTERMEDIATE_BYTES // max(
            1, r_count * self.wchunk * self.witnesses.element_size())
        return min(bsz, max(1, max_b))

    def min_distances_facemax(self, verts, weights, centers, radii,
                              batch_size: Optional[int] = 64,
                              tight: bool = False, face_tables=None):
        """``min_distances`` reduced to the max over each face's sample
        columns: a tuple of (S, F_c) tensors, one per (F_c, m_c) index
        table of ``face_tables``, or one (S,) max over all samples without
        them."""
        dists = self.min_distances(verts, weights, centers, radii,
                                   batch_size, tight)
        if face_tables is None:
            return dists.amax(-1)
        return tuple(dists[:, torch.as_tensor(t, device=dists.device)]
                     .amax(-1) for t in face_tables)


class DenseFloodEngine(AxisSortedEngine):
    """Axis-sorted witnesses and batched windows: the engine of
    ``use_pallas=False`` and of float64 clouds, built once per cloud."""

    def __init__(self, points: torch.Tensor, wchunk: int):
        self.wchunk = int(wchunk)
        self.dtype = points.dtype
        n_pts, dim = points.shape
        # the widest axis (one small device sync)
        self.mrd = int(torch.argmax(points.amax(0) - points.amin(0)))
        order = torch.argsort(points[:, self.mrd], stable=True)
        pts_sorted = points[order]
        self._native = None
        if points.device.type == "cpu" and dim <= NATIVE_MAX_DIM:
            from ..native.build import load_flood_cpu

            self._native = load_flood_cpu()  # raises if it cannot build
            self._wit_np = np.ascontiguousarray(pts_sorted.numpy())
            self._waxis_np = np.ascontiguousarray(self._wit_np[:, self.mrd])
        total = _round_up(max(n_pts, self.wchunk), self.wchunk)
        if total != n_pts:
            pad = pts_sorted.new_full((total - n_pts, dim), WITNESS_PAD)
            pts_sorted = torch.cat([pts_sorted, pad])
        self.witnesses = pts_sorted.contiguous()
        self.witness_axis = self.witnesses[:, self.mrd].contiguous()

    def _native_min_distances(self, verts, weights, centers, radii):
        """The native reduction, over slices of simplices whose (B, dim, R)
        samples stay within ``INTERMEDIATE_BYTES``. Raises on a nonzero
        return code."""
        f64 = self.dtype == torch.float64
        fn = (self._native.flood_min_dist_f64 if f64
              else self._native.flood_min_dist_f32)
        cptr = ctypes.POINTER(ctypes.c_double if f64 else ctypes.c_float)

        def p(a):
            return a.ctypes.data_as(cptr)

        s_count, _, dim = verts.shape
        r_count = weights.shape[0]
        out = torch.empty((s_count, r_count), dtype=self.dtype)
        per_simplex = r_count * (dim + 1) * out.element_size()
        max_b = max(1, INTERMEDIATE_BYTES // max(1, per_simplex))
        for start in range(0, s_count, max_b):
            end = min(start + max_b, s_count)
            cen = centers[start:end]
            samples = local_samples(verts[start:end] - cen[:, None, :],
                                    weights)
            # (B, dim, R): the C++ inner loop runs over R
            samples_np = np.ascontiguousarray(
                samples.transpose(1, 2).numpy())
            cen_np = np.ascontiguousarray(cen.numpy())
            rad_np = np.ascontiguousarray(radii[start:end].numpy())
            chunk_out = np.empty((end - start, r_count),
                                 dtype=samples_np.dtype)
            rc = fn(end - start, r_count, dim, len(self._wit_np),
                    p(samples_np), p(cen_np), p(rad_np), p(self._wit_np),
                    p(self._waxis_np), self.mrd, p(chunk_out))
            if rc != 0:
                raise RuntimeError(
                    f"native flood reduction returned {rc} (dim {dim})"
                )
            out[start:end] = torch.from_numpy(chunk_out)
        return out

    def min_distances(self, verts, weights, centers, radii,
                      batch_size: Optional[int] = 64, tight: bool = False):
        """(S, R) min distances, rows in the input order.

        ``tight`` (landmarks lie in the cloud) is a pruning hint of the
        kernel engine; the dense reduction needs none and ignores it.
        """
        del tight
        weights = self._weights(weights)
        num = verts.shape[0]
        if self._native is not None:
            return self._native_min_distances(verts, weights, centers, radii)
        bsz = self._batch_size(num, batch_size, weights.shape[0])
        nb = -(-num // bsz)
        total = nb * bsz
        dim = verts.shape[-1]
        verts_b = _pad_rows(verts, total).reshape(nb, bsz, -1, dim)
        centers_b = _pad_rows(centers, total).reshape(nb, bsz, dim)
        radii_b = _pad_rows(radii, total).reshape(nb, bsz)
        imin, imax = batch_windows(centers_b[..., self.mrd], radii_b,
                                   self.witness_axis, self.wchunk)
        out = flood_min_distances(verts_b, weights, centers_b, radii_b,
                                  self.witnesses, imin, imax, self.wchunk)
        return out.reshape(total, -1)[:num]
