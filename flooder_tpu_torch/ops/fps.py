"""Farthest-point sampling in plain PyTorch.

Exact greedy FPS over a running min-squared-distance array: each step takes
the argmax of the running distances (the first index wins a tie) and folds
the new landmark in with one distance-and-minimum pass over all N points.
It is the counterpart of ``flooder_tpu.ops.fps.farthest_point_sampling``
and the plain version of the CUDA kernel in ``ops/cuda_fps.py``; the
kernel's wrapper uses it for CPU tensors only.
"""

from __future__ import annotations

import torch


def dist2_to(cols, idx: int) -> torch.Tensor:
    """Squared distances of every point to point ``idx``, summed coordinate
    by coordinate in order (the kernel adds in the same order)."""
    d2 = None
    for c in cols:
        diff = c - c[idx]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def farthest_point_sampling(
    points: torch.Tensor, n_samples: int, start_idx: int = 0
) -> torch.Tensor:
    """Select ``n_samples`` indices by exact greedy farthest-point sampling.

    Args:
        points: (N, d) float tensor, on any device.
        n_samples: number of samples.
        start_idx: index of the first selected point.

    Returns:
        (n_samples,) int64 tensor of indices into ``points``.
    """
    if points.dtype in (torch.float16, torch.bfloat16):
        points = points.float()
    cols = [points[:, i].contiguous() for i in range(points.shape[1])]
    idxs = torch.empty(n_samples, dtype=torch.int64, device=points.device)
    idxs[0] = int(start_idx)
    min_d2 = dist2_to(cols, int(start_idx))
    for i in range(1, n_samples):
        nxt = torch.argmax(min_d2)
        idxs[i] = nxt
        min_d2 = torch.minimum(min_d2, dist2_to(cols, nxt))
    return idxs
