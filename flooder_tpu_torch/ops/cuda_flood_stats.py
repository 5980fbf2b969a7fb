"""Flood min-distances with work counters: kernel K3 and its plain version.

Counterpart of ``tools/kernel_stats.py`` (``_flood_kernel_stats`` and its
launcher ``_flood_pairs_call_stats``): an instrumented flood kernel that
computes K1's values and also counts, for every simplex row,

- column 0: the work-list pairs its block visited,
- column 1: the admitted (simplex, sub-chunk) units,
- column 2: the computed (simplex, tile, sub-chunk) sample tiles.

A unit is admitted when the sub-chunk's box meets the simplex's ball
(``near^2 <= r^2``) and its gap to the simplex's sample box is within the
simplex's bound, the max of its running mins over all of its samples, taken
once at the start of each pair. Inside an admitted unit a tile is computed
when its gap is within ``min(tile's current max, ub2)``: K1's own tile
test, in one pass over the list. K1 walks each list twice, its seed pass
first, and admits a subset of these tiles (``csrc/flood.cu``): K3's values
equal K1's bit for bit, and in every block its column 2 is no less than
K1's admitted units.

It takes exactly the operand tuple of ``CudaFloodEngine.prepare``, at any
width (template instances for 1-8 coordinates, K1's runtime-width forms
past 8). CPU tensors run ``flood_stats_reference``; CUDA tensors launch
``csrc/flood_stats.cu`` or raise.

The kernel is one CTA per simplex, built as K1 is: each admitted sub-chunk
is staged once, compacted to its in-ball witnesses, with one barrier per
computed unit (the tile maxima of tests 2 and 3 are published with the
staging, the next candidate is fetched with cp.async meanwhile); the CTAs
run the simplices of the longest work-lists first (``_simplex_order``),
and the tile groups of a CTA share each staged sub-chunk (two at tiles of
512 samples, up to eight of a warp at the engine's tiles of 128). Like K1
it is bound by fp32 instruction issue: 7 instructions per in-ball (sample,
witness) pair of the computed tiles, in K1's inner loop. On
an NVIDIA H100 80GB HBM3 at 700 W it takes 35.7 ms on the 1M x 1k main
path's dimension-3 operands, against a 22.2 ms issue floor and a 14.3 ms
operations bound, and 1.21x K1's time (PERF.md).

Differences from the TPU tool, on purpose: the pair list is walked once
with no launch segments, so it is not padded to whole segments by
repeating its last pair. The TPU tool's padding inflates its column 0 and
walks the last pair again; here column 0 counts real pairs only, and the
visited pairs summed over blocks equal the work-list's length.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.device import DeviceLike, as_tensor
from .cuda_flood import (
    BS,
    MASK,
    SUB,
    WCHUNK,
    _check_flood_operands,
    _cta_order,
    _sqsum,
    kernel_samples,
)

# Kernel launches through ``flood_min_stats`` (CUDA tensors only), as
# counted by ``flood_stats_launch`` while it enqueues them.
LAUNCHES = 0

COL_PAIRS, COL_SUBCHUNKS, COL_TILES = 0, 1, 2


def flood_stats_reference(samples, witnesses, sub_lo, sub_hi, centers,
                          radii, tile_lo, tile_hi, ub2, blk_ptr, blk_chunks):
    """The plain PyTorch version of K3: the same work-list walk, the same
    three admission tests and the same arithmetic, vectorized over the
    simplices and tiles of a block.

    Returns (out (S, nr, rt) min d^2, stats (S, 3) int64).
    """
    s_total, nr, rt, dim = samples.shape
    n_blk = s_total // BS
    spc = WCHUNK // SUB
    dev = samples.device
    out = torch.full((s_total, nr, rt), float("inf"), device=dev)
    stats = torch.zeros((s_total, 3), dtype=torch.int64, device=dev)
    samp_lo = tile_lo.amin(1)  # (S, dim) ball-local sample boxes
    samp_hi = tile_hi.amax(1)
    ptr = blk_ptr.tolist()
    chunks = blk_chunks.tolist()
    for b in range(n_blk):
        sl = slice(b * BS, (b + 1) * BS)
        x, c, rad = samples[sl], centers[sl], radii[sl]
        r2 = rad * rad
        tlo, thi, ub = tile_lo[sl], tile_hi[sl], ub2[sl]
        slo, shi = samp_lo[sl], samp_hi[sl]
        acc, st = out[sl], stats[sl]  # views: updates land in the outputs
        st[:, COL_PAIRS] = ptr[b + 1] - ptr[b]
        for p in range(ptr[b], ptr[b + 1]):
            s_bound = acc.amax((1, 2))  # (BS,), once per pair
            for q in range(spc):
                sub = chunks[p] * spc + q
                lo, hi = sub_lo[sub], sub_hi[sub]
                near = torch.minimum(torch.maximum(c, lo), hi) - c
                blo, bhi = lo - c, hi - c  # (BS, dim) ball-local box
                sgap = torch.clamp(
                    torch.maximum(blo - shi, slo - bhi), min=0.0
                )
                unit = (_sqsum(near) <= r2) & (_sqsum(sgap) <= s_bound)
                gap = torch.clamp(
                    torch.maximum(blo[:, None] - thi, tlo - bhi[:, None]),
                    min=0.0,
                )
                bound = torch.minimum(acc.amax(-1), ub)  # (BS, nr)
                ok = unit[:, None] & (_sqsum(gap) <= bound)
                st[:, COL_SUBCHUNKS] += unit.long()
                st[:, COL_TILES] += ok.long().sum(1)
                si, ri = ok.nonzero(as_tuple=True)
                if si.numel() == 0:
                    continue
                yl = witnesses[sub * SUB : (sub + 1) * SUB][None] - c[:, None]
                inb = _sqsum(yl) <= r2[:, None]  # (BS, SUB)
                ym = torch.where(inb[..., None], yl, torch.full_like(yl, MASK))
                xs, ys = x[si, ri], ym[si]  # (U, rt, dim), (U, SUB, dim)
                d2 = None
                for d in range(dim):
                    diff = ys[:, None, :, d] - xs[:, :, None, d]
                    d2 = diff * diff if d2 is None else d2 + diff * diff
                acc[si, ri] = torch.minimum(acc[si, ri], d2.amin(-1))
    return out, stats


def _simplex_order(blk_ptr: torch.Tensor) -> torch.Tensor:
    """K3's launch order: CTA i runs simplex ``order[i]``. The blocks come
    in K1's order (``_cta_order``: longest work-list first, ties by index),
    and each block's BS simplices stay together, in row order (int32)."""
    blocks = _cta_order(blk_ptr).long()
    rows = torch.arange(BS, dtype=torch.long, device=blk_ptr.device)
    return (blocks[:, None] * BS + rows).reshape(-1).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


@functools.lru_cache(maxsize=None)
def _lib():
    from ..native.build import load_cuda

    lib = load_cuda("flood_stats")
    lib.flood_stats_launch.restype = ctypes.c_int
    lib.flood_stats_launch.argtypes = _ARGTYPES
    lib.flood_stats_error_string.restype = ctypes.c_char_p
    lib.flood_stats_error_string.argtypes = [ctypes.c_int]
    lib.flood_stats_sub.restype = ctypes.c_int
    lib.flood_stats_sub.argtypes = []
    if lib.flood_stats_sub() != SUB:
        raise RuntimeError("csrc/flood_stats.cu was built with another SUB")
    return lib


def flood_min_stats(samples, witnesses, sub_lo, sub_hi, centers, radii,
                    tile_lo, tile_hi, ub2, blk_ptr, blk_chunks):
    """K3: K1's min d^2 plus per-simplex work counters.

    Takes the operand tuple of ``CudaFloodEngine.prepare``. CPU tensors go
    to ``flood_stats_reference``; CUDA tensors launch
    ``csrc/flood_stats.cu`` or raise. Returns (out (S, nr, rt) f32,
    stats (S, 3) int64: visited pairs, admitted sub-chunks, computed
    tiles).
    """
    operands = (samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo,
                tile_hi, ub2, blk_ptr, blk_chunks)
    if samples.device.type == "cpu":
        return flood_stats_reference(*operands)
    global LAUNCHES
    s_total, nr, rt, dim, _ = _check_flood_operands(operands,
                                                    "flood_min_stats")
    lib = _lib()
    order = _simplex_order(blk_ptr)
    out = torch.empty((s_total, nr, rt), dtype=torch.float32,
                      device=samples.device)
    stats = torch.empty((s_total, 3), dtype=torch.int64,
                        device=samples.device)
    launched = ctypes.c_longlong(0)
    kernel_ops = (kernel_samples(samples),) + operands[1:]
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flood_stats_launch(
            *(t.data_ptr() for t in kernel_ops), order.data_ptr(),
            out.data_ptr(), stats.data_ptr(), s_total, nr, rt, dim, BS,
            WCHUNK // SUB, stream, ctypes.byref(launched),
        )
    LAUNCHES += launched.value
    if rc != 0:
        raise RuntimeError(
            "flood-stats kernel launch failed: "
            + lib.flood_stats_error_string(rc).decode()
        )
    return out, stats


def operands_from_jax(pair_s, pair_c, samples, witnesses, centers, radii,
                      tile_lo, tile_hi, ub2, device: DeviceLike = None):
    """K3's operand tuple from the TPU tool's operands (numpy arrays).

    Takes the TPU layout: the work-list as ``pair_s`` / ``pair_c`` (block
    and chunk of every pair, grouped by block in visit order), samples
    (S, NR, dim, RT), witnesses (dim, W), centers (S, dim), radii (S, 1),
    tile boxes (S, NR, dim) and ub2 (S, NR, 1). Returns the tuple that
    ``CudaFloodEngine.prepare`` returns, on ``device`` (default "cuda"):
    samples (S, NR, RT, dim), witnesses (W, dim), the sub-chunk boxes,
    centers, radii (S,), tile boxes, ub2 (S, NR) and the per-block CSR
    ``blk_ptr`` / ``blk_chunks``.
    """
    samples = np.asarray(samples, dtype=np.float32)
    s_total, _, dim, _ = samples.shape
    n_blk = s_total // BS
    pair_s = np.asarray(pair_s, dtype=np.int64)
    if np.any(np.diff(pair_s) < 0):
        raise ValueError("pairs must be grouped by block, in block order")
    wit = np.ascontiguousarray(np.asarray(witnesses, dtype=np.float32).T)
    subs = wit.reshape(-1, SUB, dim)
    blk_ptr = np.zeros(n_blk + 1, dtype=np.int32)
    blk_ptr[1:] = np.cumsum(np.bincount(pair_s, minlength=n_blk))
    floats = (
        samples.transpose(0, 1, 3, 2), wit, subs.min(1), subs.max(1),
        centers, np.reshape(radii, -1), tile_lo, tile_hi,
        np.asarray(ub2)[..., 0],
    )
    host = tuple(np.asarray(a, np.float32) for a in floats) + (
        blk_ptr, np.asarray(pair_c, np.int32),
    )
    return tuple(
        as_tensor(np.ascontiguousarray(a), device=device) for a in host
    )
