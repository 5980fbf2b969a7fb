"""One flood scene: the engine's operands for a cloud and a landmark count.

Counterpart of ``tools/pricing_common.py`` ``build_scene``, built from the
port's own pieces only: the generators, FPS landmarks from index 0, the
Delaunay top simplices, their bounding balls in the engine's visit order
(``core.pass_inputs``, as ``flood_complex`` makes them), the grid with 30
points per edge and ``CudaFloodEngine.prepare`` with the nearest-vertex
bound on. The operands are the ones ``flood_complex`` hands
kernel K1 in its top-dimension pass.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core import _grid_host, generate_landmarks, pass_inputs
from ..ops.cuda_flood import BS, CudaFloodEngine
from ..synthetic_data_generators import (
    generate_figure_eight_points_2d,
    generate_swiss_cheese_points,
)
from ..topology import DelaunayComplex
from ..utils.device import DeviceLike, resolve_device

POINTS_PER_EDGE = 30


def build_scene(points: int, landmarks: int, *, cloud: str = "cheese3d",
                seed: int = 42, device: DeviceLike = None) -> SimpleNamespace:
    """Build the flood scene of one configuration.

    Args:
        points: cloud size.
        landmarks: FPS landmark count.
        cloud: ``"cheese3d"`` (3-D swiss cheese, 6 voids) or ``"eight2d"``
            (2-D figure eight, Gaussian noise of 0.02), with the reference
            tool's parameters.
        seed: cloud seed.
        device: device to run on (default "cuda").

    Returns:
        a namespace with ``operands`` (the tuple for ``flood_min`` and
        ``flood_min_stats``), ``sperm``, ``num_simplices``, the ``engine``,
        the ordered ``sim_verts`` / ``centers`` / ``radii`` and ``weights``
        that ``engine.min_distances`` takes, and ``dim``, ``nr``, ``rt``.
    """
    dev = resolve_device(device)
    if cloud == "eight2d":
        pts = generate_figure_eight_points_2d(
            points, noise_std=0.02, noise_kind="gaussian", seed=seed,
            device=dev,
        )
    elif cloud == "cheese3d":
        pts = generate_swiss_cheese_points(points, k=6, seed=seed,
                                           device=dev)[0]
    else:
        raise ValueError(f"unknown cloud {cloud!r}")
    dim = pts.shape[1]
    lms = generate_landmarks(pts, landmarks, start_idx=0, device=dev)
    engine = CudaFloodEngine(pts)
    stree = DelaunayComplex(
        lms.cpu().numpy().astype(np.float64)
    ).create_simplex_tree()
    top = stree._verts[min(dim, len(stree._verts) - 1)]
    sim_verts, centers, radii, _ = pass_inputs(lms, top, engine)
    weights = _grid_host(POINTS_PER_EDGE, dim)[0]
    operands, sperm, num = engine.prepare(sim_verts, weights, centers, radii,
                                          tight=True)
    _, nr, rt, _ = operands[0].shape
    return SimpleNamespace(
        device=dev, dim=dim, engine=engine, operands=operands, sperm=sperm,
        num_simplices=num, sim_verts=sim_verts, centers=centers,
        radii=radii, weights=weights, nr=nr, rt=rt,
    )


def block_slice(operands, blocks):
    """The operands of some whole blocks of a ``prepare`` tuple.

    Blocks share nothing but their own pair lists, so a kernel run on the
    slice gives exactly the rows it gives those blocks in a run on the
    whole tuple. All witnesses and sub-chunk boxes are kept; ``blk_ptr``
    is rebased onto the blocks' pair lists, laid end to end.

    Args:
        operands: the tuple of ``CudaFloodEngine.prepare``.
        blocks: block indices, in the order the slice holds them.

    Returns:
        (the sliced operand tuple, the simplex rows it holds as a long
        tensor on the operands' device).
    """
    (samples, witnesses, sub_lo, sub_hi, centers, radii, tile_lo, tile_hi,
     ub2, blk_ptr, blk_chunks) = operands
    dev = samples.device
    blk = torch.as_tensor(blocks, dtype=torch.long, device=dev)
    rows = (blk[:, None] * BS + torch.arange(BS, device=dev)).reshape(-1)
    ptr = blk_ptr.long()
    pairs = torch.cat([
        torch.arange(lo, hi, device=dev)
        for lo, hi in zip(ptr[blk].tolist(), ptr[blk + 1].tolist())
    ])
    new_ptr = torch.zeros(len(blk) + 1, dtype=torch.int32, device=dev)
    new_ptr[1:] = (ptr[blk + 1] - ptr[blk]).cumsum(0)
    per_row = tuple(
        t[rows].contiguous()
        for t in (samples, centers, radii, tile_lo, tile_hi, ub2)
    )
    sliced = (per_row[0], witnesses, sub_lo, sub_hi, *per_row[1:], new_ptr,
              blk_chunks[pairs].contiguous())
    return sliced, rows
