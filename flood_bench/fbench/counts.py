"""Peaks of one NVIDIA H100 and the work behind K2's roofline.

Peaks are the data sheet's (SXM, dense, at the 700 W limit): float32
outside the tensor cores and HBM bandwidth. The work is counted by the
benchmark's reference FPS on the same cloud, never read from a kernel's
counters.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# Operations of one squared distance, a coordinate: subtract, multiply,
# add.
OPS_PER_COORD = 3


def k2_bound_s(updates: int, dim: int) -> float:
    """K2's least time over one FPS run, from ``updates``, the (step,
    point) pairs whose running minimum falls: each needs its distance to
    the new landmark (operations), a read of the point and of its minimum,
    and a write of the minimum (bytes). The larger of the two. Points whose
    minimum stays need nothing, so chunks that a step skips cost
    nothing here."""
    ops = updates * OPS_PER_COORD * dim
    nbytes = updates * (4 * dim + 8)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
