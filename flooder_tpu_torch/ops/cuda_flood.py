"""Flood min-distances on the card: the CUDA engine around kernel K1.

Counterpart of ``flooder_tpu.ops.pallas_flood`` (its ``PallasFloodEngine``
and ``_flood_kernel``). What the engine does, per call:

1. Once per cloud (cached by the caller): pad the witnesses with rows at
   ``WITNESS_PAD``, which fail every ball test, order them by a balanced
   k-d split (``kd_order``), and keep the boxes of every chunk of
   ``WCHUNK`` and every sub-chunk of ``SUB`` witnesses.
2. Per dimension pass: curve-order the sample rows, build ball-local
   sample tiles, tile boxes and the static bound ``ub2`` (``_prep``), the
   (block, chunk) admission ``active`` with the block-to-chunk distance
   (``_active_pairs_matrix``), and from them a per-block CSR work-list,
   nearest chunk first (``_worklist``), all as torch ops on the device.
3. Run ``flood_min``: the hand-written CUDA kernel ``csrc/flood.cu`` for
   CUDA tensors, its plain PyTorch version ``flood_pairs_reference`` for
   CPU tensors, and nothing else.
4. Reduce with the epilogues (max, inf mask, sqrt, face maxima).

Mechanisms of the TPU engine that existed for the TPU or its host link are
not carried over: u8/f16 admission packing, launch segments sized to the
TPU's scalar memory, the aliased accumulator, power-of-two compile-key
bucketing and transposed witness storage. ``active`` is a bool and
``dist`` a float, so no pair is ever dropped by a packing.

Tiles of 128 samples (``FEW_RT``, ``_tile_geometry``): at 1-8 coordinates
every pass, and past 8 up to 384 samples a simplex (random mode, coarse
grids). They take K1's few-sample instances, one warp a (simplex, tile):
``flood_min_few<DIM>`` at 1-8 coordinates, ``flood_min_few_wide`` at 9-16
and ``flood_min_few_slabs`` past 16 (``k1_instance`` says which instance a
launch takes). Past 384 samples a simplex at 1-8 coordinates (grid mode)
the tiles are 128-sample patches of the curve-ordered sample rows, so each
patch is a tight piece of its simplex with its own box, its own static
bound ``ub2`` and its own largest running min: K1's tile test (skip 2)
admits a sub-chunk for a patch only where its box comes within
``min(pm, ub2)`` of the patch's, the same lossless test as on a tile of
512 samples, one patch at a time. It leaves out the pairs that could not
lower a minimum of that patch, about half of a 512-sample tile's on a
cheese cloud of 10M points, with the same minima. Every instance walks a
tile's list twice, nearest first both times: a seed pass admits the
sub-chunks whose box meets the tile's (gap 0), so ``pm`` falls to the
witnesses on the tile before skip 2 tests the rest in the second pass. The
two passes admit a subset of the units of one pass, with the same minima
(``csrc/flood.cu``); K1's ``stats`` count the seed pass's in-ball pairs in
a third column. At 1-8 coordinates no other tile is made, and
``flood_min`` refuses one. Past 8 coordinates the tiles of more than 384
samples hold ``RT`` = 512 (``flood_min_wide``).

The kernel takes float32 clouds of any width, as the Pallas engine does:
template instances for 1-8 coordinates and runtime-width instances past 8,
which read the samples coordinate-major (``kernel_samples``); their shared
memory does not grow past 16 coordinates, so no width is capped.
Like the template instances they sum each d^2 with one FMA a coordinate:
their output matches ``flood_pairs_reference`` within 2 * dim * 2**-24 * d^2
(two fp32 summation orders), with every count and inf exact. CPU tensors run
the plain version, and float64 and ``use_pallas=False`` take the dense
engine (``ops/flood.py``).

Curve codes are int64. Past ``63 // bits`` coordinates a code's bit shift
would pass its sign bit, so the codes take the first ``63 // bits``
coordinates only (``_coded_axes``); up to 63 coordinates that is every
coordinate, the same codes as ``flooder_tpu``. An order decides which
simplices share a block, never a filtration value.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import stagetimer
from ..utils.stagetimer import fence, stage
from .flood import WITNESS_PAD, _sqsum, local_samples

BS = 8  # simplices per block
RT = 512  # sample points per tile (at most)
# Tiles of few-sample passes: one warp of K1's few-sample instances a tile
FEW_RT = 128
FEW_WARPS = 2  # its tiles a CTA at 1-8 coordinates
FEW_WIDE_WARPS = 4  # and past 8
WCHUNK = 2048  # witnesses per work-list chunk
SUB = 512  # witnesses per sub-chunk (the kernel's shared-memory tile)
MORTON_BITS_TOTAL = 24
MASK = 3e18  # out-of-ball witnesses move here
# Squared distances at or above this mean "no witness in the ball"
# (a sub-chunk with every witness masked yields >= 9e36).
_MASKED_D2 = 1e30
# The widest template instance of K1 and K3; past it the runtime-width one.
KERNEL_MAX_DIM = 8
# The widest one-slab few-sample instance; past it the slab one.
FEW_ONE_SLAB_DIM = 16

# Kernel launches through ``flood_min`` (CUDA tensors only), as counted by
# ``flood_min_launch`` and ``flood_min_few_launch`` while they enqueue them;
# FEW_LAUNCHES counts those of the few-sample instances alone.
LAUNCHES = 0
FEW_LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# space-filling curves and the k-d witness order
# ---------------------------------------------------------------------------


def _coded_axes(dim: int, bits: int) -> int:
    """How many leading coordinates an int64 curve code of ``bits`` bits per
    axis holds: all ``dim`` up to ``63 // bits``, so that no shift passes
    the sign bit (a shift of 64 or more is not defined alike on the CPU and
    the card)."""
    return min(dim, 63 // bits)


def _hilbert_from_quantized(q_cols, bits: int, where):
    """Hilbert index from quantized integer coordinates (Skilling's
    transpose algorithm, vectorized; ``where`` is ``np.where`` or
    ``torch.where`` so host and device callers share the code). Codes the
    first ``_coded_axes`` columns."""
    X = list(q_cols)[: _coded_axes(len(q_cols), bits)]
    d = len(X)
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(d):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            X0_new = where(cond, X[0] ^ P, X[0] ^ t)
            if i != 0:
                X[i] = where(cond, X[i], X[i] ^ t)
            X[0] = X0_new
        Q >>= 1
    for i in range(1, d):
        X[i] = X[i] ^ X[i - 1]
    t = X[0] * 0
    Q = 1 << (bits - 1)
    while Q > 1:
        t = where((X[d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    code = X[0] * 0
    for b in range(bits):
        for i in range(d):
            code = code | (((X[i] >> b) & 1) << (b * d + (d - 1 - i)))
    return code


def _quantize(points: torch.Tensor, bits: int) -> torch.Tensor:
    lo = points.amin(0)
    extent = torch.clamp(points.amax(0) - lo, min=1e-30)
    q = ((points - lo) / extent * (2**bits - 1e-3)).to(torch.int64)
    return torch.clamp(q, 0, 2**bits - 1)


def hilbert_codes(points: torch.Tensor, bits: int) -> torch.Tensor:
    """Hilbert curve codes of points, ``bits`` bits per axis (torch)."""
    q = _quantize(points, bits)
    cols = [q[:, i] for i in range(points.shape[1])]
    return _hilbert_from_quantized(cols, bits, torch.where)


def morton_codes(points: torch.Tensor, bits: int) -> torch.Tensor:
    """Morton (Z-order) codes of points, ``bits`` bits per axis (torch)."""
    q = _quantize(points, bits)
    n = points.shape[0]
    d = _coded_axes(points.shape[1], bits)
    code = torch.zeros(n, dtype=torch.int64, device=points.device)
    for b in range(bits):
        for ax in range(d):
            code = code | (((q[:, ax] >> b) & 1) << (b * d + ax))
    return code


def hilbert_codes_np(points: np.ndarray, bits: int) -> np.ndarray:
    """Hilbert curve codes (host numpy; for small arrays like simplex
    centers and sample weights)."""
    lo = points.min(axis=0)
    extent = np.maximum(points.max(axis=0) - lo, 1e-30)
    q = ((points - lo) / extent * (2**bits - 1e-3)).astype(np.int64)
    q = np.clip(q, 0, 2**bits - 1)
    cols = [q[:, i].copy() for i in range(points.shape[1])]
    return _hilbert_from_quantized(cols, bits, np.where)


def spatial_order_np(centers, bits: int) -> np.ndarray:
    """Hilbert processing order of simplices (host numpy: the centers are
    few). Consecutive simplices, and so each block, stay spatially tight."""
    c = np.asarray(centers)
    code = hilbert_codes_np(c, bits) if c.shape[1] > 1 else c[:, 0]
    return np.argsort(code, kind="stable")


def _sample_morton_order(weights_np: np.ndarray) -> np.ndarray:
    """Space-filling-curve order of barycentric sample rows, so that every
    tile of consecutive rows is a tight patch of its simplex (Hilbert; a
    Z-order code for a single column, where the two coincide)."""
    k = weights_np.shape[1]
    bits = max(1, min(10, 24 // max(1, k)))
    if k > 1:
        code = hilbert_codes_np(weights_np.astype(np.float64), bits)
        return np.argsort(code, kind="stable").astype(np.int32)
    q = np.clip(
        (weights_np * (2**bits - 1)).astype(np.int64), 0, 2**bits - 1
    )
    code = np.zeros(len(weights_np), dtype=np.int64)
    for b in range(bits):
        for ax in range(k):
            code |= ((q[:, ax] >> b) & 1) << (b * k + ax)
    return np.argsort(code, kind="stable").astype(np.int32)


def kd_order(points: torch.Tensor, leaf: int) -> torch.Tensor:
    """Balanced k-d ordering: at every level, each of the ``2**lvl`` equal
    segments is stably sorted along its widest axis, until segments reach
    about ``leaf`` points. Batched stable ``torch.sort`` over (nseg, m) row
    views; the permutation equals ``flooder_tpu``'s ``kd_order_np``.

    ``points`` must have a row count that every level's segment count
    divides (see ``witness_total``).
    """
    n, dim = points.shape
    levels = max(0, (n // leaf - 1).bit_length())
    order = torch.arange(n, dtype=torch.int64, device=points.device)
    pts = points
    for lvl in range(levels):
        nseg = 1 << lvl
        m = n // nseg
        seg = pts.reshape(nseg, m, dim)
        ax = torch.argmax(seg.amax(1) - seg.amin(1), dim=1)
        keys = torch.gather(seg, 2, ax[:, None, None].expand(nseg, m, 1))
        idx = torch.sort(keys[:, :, 0], dim=1, stable=True).indices
        pts = torch.gather(seg, 1, idx[:, :, None].expand(nseg, m, dim))
        pts = pts.reshape(n, dim)
        order = torch.gather(order.reshape(nseg, m), 1, idx).reshape(n)
    return order


def witness_total(n: int) -> int:
    """Padded witness count: a power-of-two number of ``SUB``-point leaves
    (at least one chunk). ``kd_order`` splits into equal halves, so only a
    power-of-two leaf count puts every split on a sub-chunk boundary and
    makes every sub-chunk box a k-d leaf box; any other count leaves
    sub-chunks that straddle two leaves, with loose boxes and more
    admitted work (measured on the card by chip_smoke.py). The engine's
    rows past ``n`` sit at ``WITNESS_PAD``: ``kd_order`` sorts them after
    every real row, so all leaves but one hold real rows alone or padding
    rows alone, and no ball meets a leaf of padding rows."""
    leaves = -(-max(n, WCHUNK) // SUB)
    return SUB << max(0, leaves - 1).bit_length()


# ---------------------------------------------------------------------------
# operand preparation
# ---------------------------------------------------------------------------


def _tile_geometry(r_count: int, dim: int):
    """Sample-tile geometry: (rt samples per tile, nr tiles, padded total).
    At 1-8 coordinates every tile holds FEW_RT samples (K1's few-sample
    instances, a warp a tile): past 384 samples a simplex its tiles are
    128-sample patches, each admitting work for itself. Past 8 coordinates
    the tiles hold FEW_RT up to 384 samples and RT above, with the same
    padded total either way (the count rounded up to 128, then to RT past
    RT)."""
    few = dim <= KERNEL_MAX_DIM or r_count <= RT - FEW_RT
    rt = FEW_RT if few else RT
    nr = -(-r_count // rt)
    return rt, nr, nr * rt


def _pad_simplices(verts, centers, radii, s_total: int):
    """Pad to ``s_total`` rows with far-away zero-radius balls: they meet no
    chunk, so they add no work (their rows are sliced off by the caller)."""
    num = verts.shape[0]
    if s_total == num:
        return verts, centers, radii
    pad_n = s_total - num
    _, k, dim = verts.shape
    verts = torch.cat([verts, verts.new_full((pad_n, k, dim), 8e14)])
    centers = torch.cat([centers, centers.new_full((pad_n, dim), 8e14)])
    radii = torch.cat([radii, radii.new_zeros(pad_n)])
    return verts, centers, radii


def _prepare_sample_weights(weights, r2_total: int):
    """Curve-sort the sample weight rows and pad them to the tile grid by
    repeating the last row. Returns (float32 numpy weights (r2_total, k),
    sperm), where output column i holds original sample ``sperm[i]``."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    weights_np = np.asarray(weights, dtype=np.float32)
    return _prepare_sample_weights_cached(
        weights_np.tobytes(), weights_np.shape, r2_total
    )


@functools.lru_cache(maxsize=32)
def _prepare_sample_weights_cached(wbytes: bytes, shape, r2_total: int):
    weights_np = np.frombuffer(wbytes, dtype=np.float32).reshape(shape)
    sperm = _sample_morton_order(weights_np)
    ws = weights_np[sperm]
    if r2_total != len(ws):
        ws = np.concatenate(
            [ws, np.repeat(ws[-1:], r2_total - len(ws), axis=0)]
        )
    ws.setflags(write=False)
    return ws, sperm


def _active_pairs_matrix(
    centers, radii, samp_lo, samp_hi, ub2max, chunk_lo, chunk_hi, bs: int
):
    """Per (simplex block, witness chunk): can the chunk matter, and how
    close is it?

    A chunk is active for a simplex when its box meets the simplex's ball
    (strictly positive radius: padding balls have radius 0) and its gap to
    the simplex's sample box does not exceed the simplex's static bound.

    Returns:
        (active (n_blk, n_chunks) bool, dist (n_blk, n_chunks) float): the
        min over the block's centers of the squared center-to-box distance,
        the key of the nearest-first visit order.
    """
    n_blk = centers.shape[0] // bs
    c = centers.reshape(n_blk, bs, 1, -1)
    r = radii.reshape(n_blk, bs, 1)
    nearest = torch.minimum(torch.maximum(c, chunk_lo), chunk_hi)
    d2 = _sqsum(c - nearest)  # (n_blk, bs, n_chunks)
    hit = (d2 <= r * r) & (r > 0)
    slo = samp_lo.reshape(n_blk, bs, 1, -1)
    shi = samp_hi.reshape(n_blk, bs, 1, -1)
    gap = torch.clamp(
        torch.maximum(chunk_lo - shi, slo - chunk_hi), min=0.0
    )
    hit = hit & (_sqsum(gap) <= ub2max.reshape(n_blk, bs, 1))
    return hit.any(dim=1), d2.amin(dim=1)


def _prep(verts_local, weights_p, centers, radii, chunk_lo, chunk_hi,
          *, bs: int, nr: int, rt: int, tight: bool):
    """All kernel operands of one dimension pass, as torch ops.

    Args:
        verts_local: (S, k, dim) ball-local vertex coordinates.
        weights_p: (R2, k) curve-ordered, padded sample weights.
        centers: (S, dim); radii: (S,).
        chunk_lo / chunk_hi: (n_chunks, dim) witness chunk boxes.
        tight: landmarks are witnesses, so each sample's distance to its
            nearest vertex bounds its result (``ub2``); else ``ub2`` = inf.

    Returns:
        samples (S, nr, rt, dim) ball-local, tile_lo / tile_hi
        (S, nr, dim), ub2 (S, nr), active (n_blk, n_chunks) bool and
        dist (n_blk, n_chunks).
    """
    s_total, k, dim = verts_local.shape
    samples_flat = local_samples(verts_local, weights_p)  # (S, R2, dim)
    samples = samples_flat.reshape(s_total, nr, rt, dim)
    tile_lo = samples.amin(2)
    tile_hi = samples.amax(2)
    if tight:
        dv2 = None
        for j in range(k):
            dj2 = _sqsum(samples_flat - verts_local[:, j : j + 1, :])
            dv2 = dj2 if dv2 is None else torch.minimum(dv2, dj2)
        ub2 = dv2.reshape(s_total, nr, rt).amax(2)
    else:
        ub2 = torch.full(
            (s_total, nr), float("inf"), device=centers.device
        )
    samp_lo = tile_lo.amin(1) + centers
    samp_hi = tile_hi.amax(1) + centers
    active, dist = _active_pairs_matrix(
        centers, radii, samp_lo, samp_hi, ub2.amax(1), chunk_lo, chunk_hi,
        bs,
    )
    return samples, tile_lo, tile_hi, ub2, active, dist


def _worklist(active: torch.Tensor, dist: torch.Tensor):
    """Per-block CSR of active chunks, nearest first (ties: lower chunk).

    Returns (blk_ptr (n_blk + 1,) int32, blk_chunks (P,) int32)."""
    n_blk, n_chunks = active.shape
    key = torch.where(active, dist, torch.full_like(dist, float("inf")))
    idx = torch.sort(key, dim=1, stable=True).indices
    counts = active.sum(dim=1)
    blk_ptr = torch.zeros(n_blk + 1, dtype=torch.int32, device=active.device)
    blk_ptr[1:] = torch.cumsum(counts, 0)
    keep = (
        torch.arange(n_chunks, device=active.device)[None, :]
        < counts[:, None]
    )
    return blk_ptr, idx[keep].to(torch.int32)


# ---------------------------------------------------------------------------
# kernel K1 and its plain version
# ---------------------------------------------------------------------------


def _walk_tests(sub_lo, sub_hi, subs, c, r2, tlo, thi):
    """K1's two tests on sub-chunks ``subs`` (P,) of one block, in the
    kernels' arithmetic: (hit (P, BS), the ball test of skip 1; g2 (P, BS,
    nr), the squared gap between each sub-chunk's box and each tile's box,
    both ball-local, for skip 2 and the seed pass)."""
    lo, hi = sub_lo[subs][:, None], sub_hi[subs][:, None]  # (P, 1, dim)
    hit = _sqsum(torch.minimum(torch.maximum(c, lo), hi) - c) <= r2
    gap = torch.clamp(
        torch.maximum((lo - c)[:, :, None] - thi,
                      tlo - (hi - c)[:, :, None]),
        min=0.0,
    )
    return hit, _sqsum(gap)


def flood_pairs_reference(samples, witnesses, sub_lo, sub_hi, centers,
                          radii, tile_lo, tile_hi, ub2, blk_ptr, blk_chunks):
    """The plain PyTorch version of K1: the same work-list walk in the same
    two passes, the same two admission tests, the same 3e18 mask and
    arithmetic, vectorized over the simplices and tiles of a block.

    Each (simplex, tile) walks its block's list twice, nearest first: the
    seed pass admits the sub-chunks that pass the ball test and whose box
    meets the tile's (squared gap 0), the second pass those that pass it at
    a gap above 0 and within ``min(pm, ub2)`` (skip 2: ``pm`` the tile's
    largest running min, ``ub2`` its static bound).

    Returns (out (S, nr, rt) min d^2, stats (n_blk * nr, 3) int64 with
    admitted (simplex, sub-chunk) units, in-ball pairs, and the in-ball
    pairs of the seed pass per tile).
    """
    s_total, nr, rt, dim = samples.shape
    n_blk = s_total // BS
    spc = WCHUNK // SUB
    dev = samples.device
    out = torch.full((s_total, nr, rt), float("inf"), device=dev)
    stats = torch.zeros((n_blk, nr, 3), dtype=torch.int64, device=dev)
    ptr = blk_ptr.tolist()
    # positions whose tests are held at once: at most about 2**20 gaps
    group = max(1, (1 << 20) // (BS * nr * dim))
    for b in range(n_blk):
        sl = slice(b * BS, (b + 1) * BS)
        x, c, rad = samples[sl], centers[sl], radii[sl]
        r2 = rad * rad
        tlo, thi, ub = tile_lo[sl], tile_hi[sl], ub2[sl]
        acc = out[sl]  # a view: updates land in ``out``
        subs = (blk_chunks[ptr[b]:ptr[b + 1]].long()[:, None] * spc
                + torch.arange(spc, device=dev)).reshape(-1)
        for seed in (True, False):
            for g0 in range(0, subs.numel(), group):
                part = subs[g0:g0 + group]
                hit, g2 = _walk_tests(sub_lo, sub_hi, part, c, r2, tlo, thi)
                # the pass's sub-chunks, less those the bound already skips
                # (it only falls)
                want = hit[..., None] & ((g2 == 0) if seed else (g2 > 0))
                want &= g2 <= torch.minimum(acc.amax(-1), ub)
                for j in want.any(2).any(1).nonzero()[:, 0].tolist():
                    bound = torch.minimum(acc.amax(-1), ub)  # (BS, nr)
                    ok = want[j] & (g2[j] <= bound)
                    if not bool(ok.any()):
                        continue
                    sub = int(part[j])
                    yl = (witnesses[sub * SUB : (sub + 1) * SUB][None]
                          - c[:, None])
                    inb = _sqsum(yl) <= r2[:, None]  # (BS, SUB)
                    ym = torch.where(inb[..., None], yl,
                                     torch.full_like(yl, MASK))
                    si, ri = ok.nonzero(as_tuple=True)
                    xs, ys = x[si, ri], ym[si]  # (U, rt, dim), (U, SUB, dim)
                    d2 = None
                    for d in range(dim):
                        diff = ys[:, None, :, d] - xs[:, :, None, d]
                        d2 = diff * diff if d2 is None else d2 + diff * diff
                    acc[si, ri] = torch.minimum(acc[si, ri], d2.amin(-1))
                    okl = ok.long()
                    pairs = (okl * inb.sum(1)[:, None]).sum(0) * rt
                    stats[b, :, 0] += okl.sum(0)
                    stats[b, :, 1] += pairs
                    if seed:
                        stats[b, :, 2] += pairs
    return out, stats.reshape(n_blk * nr, 3)


def _check_flood_operands(operands, what: str):
    """The checks K1's and K3's wrappers share: one CUDA device, contiguous
    float32 operands with an int32 work-list, at least one coordinate,
    whole blocks of BS simplices, whole witness chunks, witnesses 16-byte
    aligned. Raises on what the kernels do not take; returns (s_total, nr,
    rt, dim, n_blk)."""
    samples, witnesses = operands[0], operands[1]
    floats, ints = operands[:9], operands[9:]
    s_total, nr, rt, dim = samples.shape
    n_blk = s_total // BS
    for t in operands:
        if t.device != samples.device:
            raise ValueError(f"{what} operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what} takes float32 operands")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{what} takes an int32 work-list")
    if dim < 1:
        raise ValueError(f"{what} takes at least one coordinate, got {dim}")
    if s_total % BS or operands[9].numel() != n_blk + 1:
        raise ValueError("simplex rows must fill whole blocks of BS")
    if witnesses.shape[0] % WCHUNK or witnesses.shape[1] != dim:
        raise ValueError("witnesses must be (whole chunks, dim)")
    if witnesses.data_ptr() % 16:
        raise ValueError(f"{what}: witnesses must be 16-byte aligned")
    return s_total, nr, rt, dim, n_blk


def kernel_samples(samples: torch.Tensor) -> torch.Tensor:
    """The samples as K1 and K3 read them: (S, nr, rt, dim) for the template
    instances, a coordinate-major copy (S, nr, dim, rt) past
    KERNEL_MAX_DIM coordinates (the runtime-width instances)."""
    if samples.shape[-1] <= KERNEL_MAX_DIM:
        return samples
    return samples.transpose(2, 3).contiguous()


def k1_instance(rt: int, dim: int) -> str:
    """The instance of K1 that ``flood_min`` launches on tiles of ``rt``
    samples at ``dim`` coordinates: tiles of FEW_RT take the few-sample
    instances (a warp a tile), at 1-8 coordinates the template one and past
    KERNEL_MAX_DIM the runtime-width one in two forms (one 16-coordinate
    slab, and slabs); larger tiles take ``flood_min_wide`` (a CTA a block
    and tile) past KERNEL_MAX_DIM and raise ValueError at 1-8 coordinates,
    where ``_tile_geometry`` makes none."""
    if rt != FEW_RT:
        if dim <= KERNEL_MAX_DIM:
            raise ValueError(f"K1 takes tiles of {FEW_RT} samples at 1-"
                             f"{KERNEL_MAX_DIM} coordinates, not {rt}")
        return "flood_min_wide"
    if dim <= KERNEL_MAX_DIM:
        return f"flood_min_few<{dim}>"
    return ("flood_min_few_wide" if dim <= FEW_ONE_SLAB_DIM
            else "flood_min_few_slabs")


def _cta_order(blk_ptr: torch.Tensor) -> torch.Tensor:
    """K1's launch order: the blocks by decreasing work-list length, ties
    by block index (int32). CTA row i of the grid runs block ``order[i]``,
    so the longest blocks start in the first wave."""
    lens = blk_ptr[1:] - blk_ptr[:-1]
    return torch.sort(-lens, stable=True).indices.to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


@functools.lru_cache(maxsize=None)
def _lib():
    from ..native.build import load_cuda

    lib = load_cuda("flood")
    for fn in (lib.flood_min_launch, lib.flood_min_few_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    lib.flooder_cuda_error_string.restype = ctypes.c_char_p
    lib.flooder_cuda_error_string.argtypes = [ctypes.c_int]
    lib.flood_sub.restype = ctypes.c_int
    lib.flood_sub.argtypes = []
    for fn in (lib.flood_few_warps, lib.flood_few_wide_warps):
        fn.restype = ctypes.c_int
        fn.argtypes = []
    if (lib.flood_sub(), lib.flood_few_warps(), lib.flood_few_wide_warps()
            ) != (SUB, FEW_WARPS, FEW_WIDE_WARPS):
        raise RuntimeError("csrc/flood.cu was built with another SUB, "
                           "FEW_WARPS or FEW_WIDE_WARPS")
    return lib


def flood_min(samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo,
              tile_hi, ub2, blk_ptr, blk_chunks):
    """K1: min d^2 from every sample to the in-ball witnesses.

    CPU tensors go to ``flood_pairs_reference``; CUDA tensors launch
    ``csrc/flood.cu`` (blocks longest work-list first) or raise: the
    instance ``k1_instance(rt, dim)`` names, so tiles of FEW_RT samples
    take its few-sample instances (a warp a tile) at every width, and
    larger tiles at 1-8 coordinates raise ValueError. While tracing it
    counts the sample slots it runs (``k1_samples``) and those in tiles of
    FEW_RT, each admitting work for itself (``k1_patch_samples``; every
    slot at 1-8 coordinates), and keeps the in-ball pairs of ``stats``
    (``k1_inball_pairs``) and of its seed pass (``k1_seed_pairs``).
    Returns (out (S, nr, rt), stats (n_blk * nr, 3)).
    """
    operands = (samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo,
                tile_hi, ub2, blk_ptr, blk_chunks)
    s_total, nr, rt, dim = samples.shape
    n = s_total * nr * rt
    stagetimer.count("k1_samples", n)
    if rt == FEW_RT:
        stagetimer.count("k1_patch_samples", n)
    if samples.device.type == "cpu":
        out, stats = flood_pairs_reference(*operands)
    else:
        out, stats = _launch(operands, k1_instance(rt, dim).startswith(
            "flood_min_few"))
    stagetimer.keep("k1_inball_pairs", stats, column=1)
    stagetimer.keep("k1_seed_pairs", stats, column=2)
    return out, stats


def _launch(operands, few: bool):
    """K1's launch on CUDA operands: (out, stats)."""
    global LAUNCHES, FEW_LAUNCHES
    samples = operands[0]
    s_total, nr, rt, dim, n_blk = _check_flood_operands(operands,
                                                        "flood_min")
    lib = _lib()
    launch = lib.flood_min_few_launch if few else lib.flood_min_launch
    cta_order = _cta_order(operands[9])
    out = torch.empty((s_total, nr, rt), dtype=torch.float32,
                      device=samples.device)
    stats = torch.empty((n_blk * nr, 3), dtype=torch.int64,
                        device=samples.device)
    launched = ctypes.c_longlong(0)
    kernel_ops = (kernel_samples(samples),) + operands[1:]
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            *(t.data_ptr() for t in kernel_ops), cta_order.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n_blk, nr, rt, dim, BS,
            WCHUNK // SUB, stream, ctypes.byref(launched),
        )
    if rc != 0:
        raise RuntimeError(
            "flood kernel launch failed: "
            + lib.flooder_cuda_error_string(rc).decode()
        )
    LAUNCHES += launched.value
    if few:
        FEW_LAUNCHES += launched.value
    return out, stats


# ---------------------------------------------------------------------------
# epilogues
# ---------------------------------------------------------------------------


def _inf_masked(acc2):
    return torch.where(
        acc2 >= _MASKED_D2, torch.full_like(acc2, float("inf")), acc2
    )


def _max_sqrt_epilogue(acc2):
    return torch.sqrt(_inf_masked(acc2.amax(-1)))


def _facemax_epilogue(acc2, tables):
    return tuple(
        torch.sqrt(_inf_masked(acc2[:, t].amax(-1))) for t in tables
    )


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class CudaFloodEngine:
    """k-d-ordered, work-list-driven flood engine around kernel K1."""

    def __init__(self, points: torch.Tensor):
        if points.dtype != torch.float32:
            raise TypeError("the CUDA flood engine takes float32 only")
        n, dim = points.shape
        self.dim = dim
        self._bits = max(1, min(10, MORTON_BITS_TOTAL // dim))
        total = witness_total(n)
        stagetimer.count("witnesses_real", n)
        stagetimer.count("witnesses_padded", total)
        pts = points
        if total != n:
            # padding rows fail every ball test, so K1 computes no pair of
            # theirs; being equal and largest on every axis, they stay a
            # tail of the k-d order, and only one leaf mixes them with
            # real rows
            pts = torch.cat([points, points.new_full((total - n, dim),
                                                     WITNESS_PAD)])
        with stage("engine-init:kd-order"):
            order = kd_order(pts, leaf=SUB)
            fence(order)
        with stage("engine-init:permute+boxes"):
            self.witnesses = pts[order].contiguous()
            # (n_chunks,) bool: the chunk holds a padding row
            self.padded_chunks = (order >= n).reshape(-1, WCHUNK).any(1)
            chunks = self.witnesses.reshape(-1, WCHUNK, dim)
            self.chunk_lo = chunks.amin(1)
            self.chunk_hi = chunks.amax(1)
            subs = self.witnesses.reshape(-1, SUB, dim)
            self.sub_lo = subs.amin(1).contiguous()
            self.sub_hi = subs.amax(1).contiguous()
            fence(self.witnesses)
        self.last_stats: Optional[torch.Tensor] = None

    def order(self, centers: torch.Tensor) -> np.ndarray:
        return spatial_order_np(centers.detach().cpu().numpy(), self._bits)

    def min_distances(self, verts, weights, centers, radii, batch_size=None,
                      tight=False):
        """(S, R) min distances, columns in the original sample order."""
        del batch_size  # the block geometry is fixed by the kernel
        acc, sperm, num = self._run_kernel(verts, weights, centers, radii,
                                           tight)
        acc2 = acc.reshape(acc.shape[0], -1)[:num]
        inv = torch.as_tensor(np.argsort(sperm), device=acc.device)
        return torch.sqrt(_inf_masked(acc2[:, inv]))

    def min_distances_facemax(self, verts, weights, centers, radii,
                              batch_size=None, tight=False,
                              face_tables: Optional[Sequence] = None):
        """Run the kernel and reduce to per-face maxima on the squared
        accumulator (max and sqrt commute).

        Args:
            face_tables: one (F_c, m_c) index table per codimension into
                the ORIGINAL sample rows, or None for one max over all
                samples (random mode).

        Returns:
            a tuple of (S, F_c) tensors, or one (S,) tensor.
        """
        del batch_size
        acc, sperm, num = self._run_kernel(verts, weights, centers, radii,
                                           tight)
        acc2 = acc.reshape(acc.shape[0], -1)
        if face_tables is None:
            # padded sample columns repeat a real row: harmless under max
            return _max_sqrt_epilogue(acc2)[:num]
        inv = np.argsort(sperm)
        tables = [
            torch.as_tensor(inv[np.asarray(t, dtype=np.int64)],
                            device=acc.device)
            for t in face_tables
        ]
        return tuple(o[:num] for o in _facemax_epilogue(acc2, tables))

    def prepare(self, verts, weights, centers, radii, tight):
        """Kernel operands of one pass: returns (operands tuple for
        ``flood_min``, sperm, number of real simplices)."""
        per_simplex, active, dist, sperm, num = self._pass_operands(
            verts, weights, centers, radii, tight)
        return self._operands(per_simplex, active, dist), sperm, num

    def _pass_operands(self, verts, weights, centers, radii, tight):
        """One pass up to its work-lists, on the input device: (per_simplex
        = (samples, centers, radii, tile_lo, tile_hi, ub2) over the padded
        simplex rows, active, dist, sperm, num real simplices)."""
        num = verts.shape[0]
        s_total = _round_up(max(num, 1), BS)
        rt, nr, r2_total = _tile_geometry(weights.shape[0], self.dim)
        verts, centers, radii = _pad_simplices(verts, centers, radii,
                                               s_total)
        ws, sperm = _prepare_sample_weights(weights, r2_total)
        weights_p = torch.tensor(ws, device=verts.device)
        verts_local = verts - centers[:, None, :]
        with stage("prep:operands"):
            samples, tile_lo, tile_hi, ub2, active, dist = _prep(
                verts_local, weights_p, centers, radii, self.chunk_lo,
                self.chunk_hi, bs=BS, nr=nr, rt=rt, tight=tight,
            )
            self.keep_admission(active)
            fence(samples)
        return ((samples, centers, radii, tile_lo, tile_hi, ub2), active,
                dist, sperm, num)

    def _operands(self, per_simplex, active, dist):
        """``flood_min``'s operand tuple over every block and chunk."""
        with stage("prep:worklist"):
            blk_ptr, blk_chunks = _worklist(active, dist)
            fence(blk_chunks)
        samples, centers, radii, tile_lo, tile_hi, ub2 = per_simplex
        return (
            samples.contiguous(), self.witnesses, self.sub_lo, self.sub_hi,
            centers.contiguous(), radii.contiguous(),
            tile_lo.contiguous(), tile_hi.contiguous(), ub2.contiguous(),
            blk_ptr, blk_chunks,
        )

    def _launches(self, per_simplex, active, dist):
        """(grid, combine) of one pass: rows of ``flood_min`` operand tuples
        (here one launch over the whole work-list), and a function from the
        rows of their (out, stats) to (acc, ``last_stats``)."""
        operands = self._operands(per_simplex, active, dist)
        return [[operands]], lambda outs: outs[0][0]

    def keep_admission(self, active: torch.Tensor) -> None:
        """While tracing, keep the admitted (block, chunk) entries of a
        pass (``k1_chunks_admitted``) and those on a chunk that holds a
        padding row (``k1_chunks_admitted_padded``) as device counters."""
        if stagetimer.tracing():
            stagetimer.keep("k1_chunks_admitted", active.sum())
            stagetimer.keep("k1_chunks_admitted_padded",
                            (active & self.padded_chunks).sum())

    def _run_kernel(self, verts, weights, centers, radii, tight):
        per_simplex, active, dist, sperm, num = self._pass_operands(
            verts, weights, centers, radii, tight)
        grid, combine = self._launches(per_simplex, active, dist)
        with stage("kernel"):
            # every launch is enqueued before the first combine, so shards
            # on distinct cards run at once
            outs = [[flood_min(*ops) for ops in row] for row in grid]
            for row in outs:
                for _, stats in row:
                    stagetimer.keep(pass_counter(verts), stats, column=1)
            acc, self.last_stats = combine(outs)
            fence(acc)
        return acc, sperm, num


def pass_counter(verts: torch.Tensor) -> str:
    """The counter that keeps K1's in-ball pairs of one pass a second
    time, by the pass's simplex dimension: ``k1_inball_pairs_d<d>``."""
    return f"k1_inball_pairs_d{verts.shape[1] - 1}"


def kernel_operations(stats: torch.Tensor) -> Tuple[int, int]:
    """(admitted units, in-ball pairs) summed over a launch's stats."""
    tot = stats.sum(0).tolist()
    return int(tot[0]), int(tot[1])

