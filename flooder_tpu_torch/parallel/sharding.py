"""Multi-device meshes: one process drives a ("simplex", "witness") grid.

Counterpart of ``flooder_tpu.parallel.sharding``. The reference is
single-controller: one ``flood_complex(..., mesh=mesh)`` call drives every
device and returns one result, and ``shard_map`` with ``lax.pmin`` combines
the shards. The port keeps that API in one process:

- ``"simplex"`` axis: simplex blocks are split over its devices (no
  combine needed);
- ``"witness"`` axis: the ordered cloud is split over its devices; each
  device min-reduces over its witness shard, and the partial minima are
  copied to the simplex shard's first device and combined there with
  ``torch.minimum`` (min is associative, so the result is exact).

Launches are asynchronous, so shards on distinct cards run at once; a
device-to-device copy waits on the current streams of both devices, so
the combine needs no side stream. A mesh may name one device several
times (``make_mesh(["cpu"] * 8)``, ``make_mesh(["cuda:0"] * 4)``): the
same shards then run one after another on that device.

Mechanisms of the reference that existed for SPMD or the TPU are not
carried over: per-shard padding pairs and launch segments, power-of-two
bucketing of per-shard chunk and block counts, the gather limit of a
GSPMD all-gather, and host k-d ordering for a witness axis whose size is
not a power of two (here shards are whole chunks of the cloud ordered once
on its device, so every witness count takes the same path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_flood as cf
from ..ops.flood import (WITNESS_PAD, AxisSortedEngine, _pad_rows,
                         _round_up, batch_windows, flood_min_distances)
from ..utils.device import DeviceLike, resolve_device
from ..utils.stagetimer import stage

SIMPLEX_AXIS = "simplex"
WITNESS_AXIS = "witness"


def balance_chunk_assignment(loads: np.ndarray, n_bins: int) -> np.ndarray:
    """Capacity-constrained LPT assignment of chunks to shards.

    Contiguous slices of an ordered cloud (or of Hilbert-ordered simplex
    blocks) do not carry equal loads: dense regions cluster. Chunk identity
    is arbitrary (each chunk is min-reduced on its own), so chunks can be
    permuted freely before slicing. Greedy longest-processing-time with
    equal bin capacity: sort chunks by load, descending and stable, and
    place each in the lightest bin with space (ties: the lowest bin).

    Args:
        loads: (n_chunks,) per-chunk load (active-pair count).
        n_bins: number of shards; must divide n_chunks.

    Returns:
        (n_chunks,) int32 permutation ``perm``: new position j holds old
        chunk ``perm[j]``, and positions [i*cap, (i+1)*cap) form shard i.
    """
    n_chunks = len(loads)
    if n_chunks % n_bins:
        raise ValueError(f"{n_bins} bins do not divide {n_chunks} chunks")
    cap = n_chunks // n_bins
    bins = [[] for _ in range(n_bins)]
    bin_load = np.zeros(n_bins)
    for c in np.argsort(-np.asarray(loads), kind="stable"):
        open_bins = [b for b in range(n_bins) if len(bins[b]) < cap]
        b = min(open_bins, key=lambda i: (bin_load[i], i))
        bins[b].append(int(c))
        bin_load[b] += loads[c]
    return np.asarray([c for b in bins for c in b], dtype=np.int32)


def _shard_groups(loads: torch.Tensor, n_bins: int) -> List[np.ndarray]:
    """Split ``len(loads)`` items over ``n_bins`` shards with
    ``balance_chunk_assignment``: the loads are padded with zero-load
    placeholders to a multiple of ``n_bins``, which are dropped after the
    assignment, so shards may hold unequal counts. Each shard's items are
    returned in ascending order (the cloud's k-d order, the blocks'
    Hilbert order)."""
    n = loads.shape[0]
    padded = np.zeros(_round_up(n, n_bins), dtype=np.int64)
    padded[:n] = loads.cpu().numpy()
    cap = len(padded) // n_bins
    perm = balance_chunk_assignment(padded, n_bins)
    return [np.sort(g[g < n]) for g in perm.reshape(n_bins, cap)]


def mesh_device(d: DeviceLike) -> torch.device:
    """A resolved device with an explicit index on CUDA."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """An (n_ss, n_ws) grid of devices: row i is simplex shard i, column j
    witness shard j. Frozen and hashable (it keys the engine cache)."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {SIMPLEX_AXIS: len(self.devices),
                WITNESS_AXIS: len(self.devices[0])}

    @property
    def first_device(self) -> torch.device:
        """The device that holds the inputs and the result."""
        return self.devices[0][0]


def make_mesh(
    devices: Optional[Sequence[DeviceLike]] = None,
    simplex_parallel: Optional[int] = None,
) -> Mesh:
    """Build a ("simplex", "witness") mesh over the given devices.

    Args:
        devices: devices to use (default: every visible CUDA device). They
            may repeat, and must all be CUDA or all be the CPU.
        simplex_parallel: requested size of the simplex axis; the witness
            axis gets the remaining factor. Clamped to the largest divisor
            of the device count that is <= the request. Default: all
            devices on the simplex axis (no combine needed).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices uses every CUDA device, but "
                "torch.cuda.is_available() is False; pass devices=['cpu'] * n "
                "for a mesh on the host"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if len({torch.device(d).type for d in devices}) != 1:
        raise ValueError(f"a mesh takes CUDA devices or the CPU, not both: "
                         f"{[str(d) for d in devices]}")
    devs = [mesh_device(d) for d in devices]
    if simplex_parallel is None:
        simplex_parallel = n
    simplex_parallel = max(1, min(int(simplex_parallel), n))
    while n % simplex_parallel != 0:
        simplex_parallel -= 1
    n_ws = n // simplex_parallel
    return Mesh(tuple(tuple(devs[i * n_ws:(i + 1) * n_ws])
                      for i in range(simplex_parallel)))


def sharded_flood_min_distances(
    verts: torch.Tensor,
    weights: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    witnesses: torch.Tensor,
    *,
    mesh: Mesh,
    wchunk: int = 1024,
    sort_axis: int = 0,
) -> torch.Tensor:
    """Sharded version of the dense flood min-distance reduction.

    Simplex shard i takes batches [i*nb/n_ss, (i+1)*nb/n_ss); witness shard
    j takes the contiguous slice j of ``witnesses``. Each (i, j) runs
    ``batch_windows`` and ``flood_min_distances`` on ``mesh.devices[i][j]``;
    the partial minima are combined on ``mesh.devices[i][0]``.

    Args:
        verts: (nb, B, k, d); ``nb`` must divide by the simplex-axis size.
        weights: (R, k) sample weights.
        centers/radii: (nb, B, d) / (nb, B).
        witnesses: (W, d) sorted along ``sort_axis`` and padded so that W
            divides by (witness-axis size x wchunk).
        mesh: ("simplex", "witness") mesh.
        wchunk: witness chunk length.
        sort_axis: coordinate axis the witnesses are sorted along.

    Returns:
        (nb, B, R) distances on the device of ``verts``.
    """
    n_ss, n_ws = mesh.shape[SIMPLEX_AXIS], mesh.shape[WITNESS_AXIS]
    nb = verts.shape[0]
    if nb % n_ss or witnesses.shape[0] % (n_ws * wchunk):
        raise ValueError("batches must divide by the simplex axis and "
                         "witnesses by (witness axis x wchunk)")
    nb_l, w_l = nb // n_ss, witnesses.shape[0] // n_ws
    parts = []
    for si, row in enumerate(mesh.devices):
        b = slice(si * nb_l, (si + 1) * nb_l)
        local = []
        for wi, dev in enumerate(row):
            wit = witnesses[wi * w_l:(wi + 1) * w_l].to(dev)
            cen, rad = centers[b].to(dev), radii[b].to(dev)
            imin, imax = batch_windows(cen[..., sort_axis], rad,
                                       wit[:, sort_axis].contiguous(), wchunk)
            local.append(flood_min_distances(
                verts[b].to(dev), weights.to(dev), cen, rad, wit, imin, imax,
                wchunk=wchunk))
        parts.append(_min_combine(local, row[0]))
    return torch.cat([p.to(verts.device) for p in parts])


def _min_combine(partials: Sequence[torch.Tensor], device: torch.device):
    """Elementwise min of per-witness-shard partials, on ``device``."""
    out = partials[0].to(device)
    for p in partials[1:]:
        out = torch.minimum(out, p.to(device))
    return out


class MeshCudaFloodEngine(cf.CudaFloodEngine):
    """The kernel engine (K1) under a ("simplex", "witness") mesh.

    Everything of a pass but its launches is ``CudaFloodEngine``'s: the
    cloud ordered once on the input device, the operands and the (block,
    chunk) admission built once per pass on that device, the ``kernel``
    stage and the epilogues. This class only splits a pass (``_launches``):
    chunks go to witness shards and blocks to simplex shards by
    ``balance_chunk_assignment`` of their admitted pairs, so a chunk of
    padding rows alone carries none; each (simplex shard, witness shard)
    gets its gathered witnesses, rows and a work-list in local chunk ids,
    nearest first, on its device, and one K1 launch. The partial minima
    are combined by min and the block assignment is undone on the input
    device.
    """

    def __init__(self, points: torch.Tensor, mesh: Mesh):
        super().__init__(points)
        self.mesh = mesh
        # K1's stats of the last pass, per (simplex shard, witness shard)
        self.last_stats: Optional[List[List[torch.Tensor]]] = None

    def shard_operands(self, verts, weights, centers, radii, tight):
        """K1's operands of one pass, per shard.

        Returns (shards, blocks, sperm, num, s_total): ``shards[i][j]`` is
        the operand tuple of ``flood_min`` on ``mesh.devices[i][j]``,
        ``blocks[i]`` the blocks of simplex shard i (ascending), ``sperm``
        the sample permutation, ``num`` the real and ``s_total`` the padded
        simplex count.
        """
        per_simplex, active, dist, sperm, num = self._pass_operands(
            verts, weights, centers, radii, tight)
        shards, blocks = self._split(per_simplex, active, dist)
        return shards, blocks, sperm, num, per_simplex[0].shape[0]

    def _split(self, per_simplex, active, dist):
        """(shards, block_groups) of one pass, as ``shard_operands``."""
        with stage("prep:shards"):
            n_ss = self.mesh.shape[SIMPLEX_AXIS]
            n_ws = self.mesh.shape[WITNESS_AXIS]
            chunk_groups = _shard_groups(active.sum(0), n_ws)
            block_groups = _shard_groups(active.sum(1), n_ss)
            dim, spc = self.dim, cf.WCHUNK // cf.SUB
            wit_chunks = self.witnesses.reshape(-1, cf.WCHUNK, dim)
            sub_lo = self.sub_lo.reshape(-1, spc, dim)
            sub_hi = self.sub_hi.reshape(-1, spc, dim)
            dev = active.device
            shards = []
            for blocks, row in zip(block_groups, self.mesh.devices):
                blk = torch.as_tensor(blocks, device=dev)
                rows = (blk[:, None] * cf.BS
                        + torch.arange(cf.BS, device=dev)).reshape(-1)
                smp, cen, rad, tlo, thi, u2 = [t[rows] for t in per_simplex]
                shard_row = []
                for chunks, shard_dev in zip(chunk_groups, row):
                    ch = torch.as_tensor(chunks, device=dev)
                    blk_ptr, blk_chunks = cf._worklist(
                        active[blk][:, ch], dist[blk][:, ch])
                    ops = (smp, wit_chunks[ch].reshape(-1, dim),
                           sub_lo[ch].reshape(-1, dim),
                           sub_hi[ch].reshape(-1, dim), cen, rad, tlo, thi,
                           u2, blk_ptr, blk_chunks)
                    shard_row.append(tuple(t.to(shard_dev).contiguous()
                                           for t in ops))
                shards.append(shard_row)
        return shards, block_groups

    def _launches(self, per_simplex, active, dist):
        """One K1 launch per (simplex shard, witness shard); the combine
        takes the min over each simplex shard's witness shards and puts its
        blocks back in place."""
        shards, block_groups = self._split(per_simplex, active, dist)
        s_total, nr, rt, _ = per_simplex[0].shape
        dev = active.device

        def combine(outs):
            acc = torch.empty((s_total, nr, rt), dtype=torch.float32,
                              device=dev)
            for blocks, row, devs in zip(block_groups, outs,
                                         self.mesh.devices):
                if len(blocks) == 0:  # more simplex shards than blocks
                    continue
                part = _min_combine([o for o, _ in row], devs[0])
                acc.view(-1, cf.BS, nr, rt)[
                    torch.as_tensor(blocks, device=dev)
                ] = part.view(-1, cf.BS, nr, rt).to(dev)
            return acc, [[s for _, s in row] for row in outs]

        return shards, combine


class MeshFloodEngine(AxisSortedEngine):
    """The dense engine under a mesh (``use_pallas=False`` and float64).

    Witnesses are sorted along the widest axis, padded with
    ``WITNESS_PAD`` to whole chunks on every witness shard, and split
    contiguously over the witness axis; simplex batches are split over the
    simplex axis (``sharded_flood_min_distances``).
    """

    def __init__(self, points: torch.Tensor, wchunk: int, mesh: Mesh):
        self.mesh = mesh
        self.wchunk = int(wchunk)
        self.dtype = points.dtype
        n_pts, dim = points.shape
        self.mrd = int(torch.argmax(points.amax(0) - points.amin(0)))
        pts_sorted = points[torch.argsort(points[:, self.mrd], stable=True)]
        n_ws = mesh.shape[WITNESS_AXIS]
        total = _round_up(max(n_pts, self.wchunk), self.wchunk * n_ws)
        if total != n_pts:
            pad = pts_sorted.new_full((total - n_pts, dim), WITNESS_PAD)
            pts_sorted = torch.cat([pts_sorted, pad])
        self.witnesses = pts_sorted.contiguous()

    def min_distances(self, verts, weights, centers, radii,
                      batch_size: Optional[int] = 64, tight: bool = False):
        """(S, R) min distances, rows in the input order (``tight`` is the
        kernel engine's pruning hint and is ignored)."""
        del tight
        weights = self._weights(weights)
        num, k, dim = verts.shape
        r_count = weights.shape[0]
        bsz = self._batch_size(num, batch_size, r_count)
        nb = _round_up(-(-num // bsz), self.mesh.shape[SIMPLEX_AXIS])
        total = nb * bsz
        out = sharded_flood_min_distances(
            _pad_rows(verts, total).reshape(nb, bsz, k, dim), weights,
            _pad_rows(centers, total).reshape(nb, bsz, dim),
            _pad_rows(radii, total).reshape(nb, bsz), self.witnesses,
            mesh=self.mesh, wchunk=self.wchunk, sort_axis=self.mrd,
        )
        return out.reshape(total, r_count)[:num]
