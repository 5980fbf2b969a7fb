"""Synthetic point-cloud generators.

PyTorch counterparts of ``flooder_tpu.synthetic_data_generators``: the same
four shapes, signatures and numpy draws, so a seed gives bit-identical
points in both packages. Sampling runs on the host numpy RNG and the float32
result is moved to ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device


def _put(arr: np.ndarray, device: DeviceLike) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device)
    )


def generate_figure_eight_points_2d(
    n: int = 1000,
    r_bounds: Tuple[float, float] = (0.2, 0.3),
    centers: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (0.3, 0.5),
        (0.7, 0.5),
    ),
    noise_std: float = 0.0,
    noise_kind: Literal["gaussian", "uniform"] = "gaussian",
    seed: int = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate 2D points uniformly sampled in a figure-eight shape.

    Points are distributed across two annular lobes centered at ``centers``
    with radii in ``r_bounds``; optional Gaussian or uniform noise is added
    (reference synthetic_data_generators.py:13-69).

    Args:
        n: Number of points.
        r_bounds: (min_radius, max_radius) of each lobe.
        centers: Centers of the two lobes.
        noise_std: Noise std (Gaussian) or half-width (uniform); 0 disables.
        noise_kind: "gaussian" or "uniform".
        seed: RNG seed; None leaves global RNG state untouched.
        device: device for the result (default "cuda").

    Returns:
        (n, 2) float32 tensor.
    """
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()

    lobe_idx = rng.integers(0, 2, size=n)
    cx, cy = np.asarray(centers).T
    cx = cx[lobe_idx]
    cy = cy[lobe_idx]

    r_min, r_max = r_bounds
    r = np.sqrt(rng.uniform(r_min**2, r_max**2, size=n))
    theta = rng.uniform(0.0, 2 * np.pi, size=n)

    x = cx + r * np.cos(theta)
    y = cy + r * np.sin(theta)

    if noise_std > 0:
        if noise_kind == "gaussian":
            x = x + rng.normal(0.0, noise_std, size=n)
            y = y + rng.normal(0.0, noise_std, size=n)
        elif noise_kind == "uniform":
            x = x + rng.uniform(-noise_std, noise_std, size=n)
            y = y + rng.uniform(-noise_std, noise_std, size=n)
        else:
            raise ValueError("noise_kind must be 'gaussian' or 'uniform'")

    pts = np.stack((x, y), axis=1).astype(np.float32)
    return _put(pts, device)


def generate_swiss_cheese_points(
    n: int = 1000,
    rect_min: tuple = (0.0, 0.0, 0.0),
    rect_max: tuple = (1.0, 1.0, 1.0),
    k: int = 6,
    void_radius_range: tuple = (0.1, 0.2),
    seed: int = None,
    *,
    device: DeviceLike = None,
    batch_factor: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate points in a box with k non-overlapping spherical voids.

    Uniform rejection sampling inside ``[rect_min, rect_max]`` excluding k
    randomly placed balls whose radii are drawn from ``void_radius_range``
    (reference synthetic_data_generators.py:72-172, same two-phase
    vectorized rejection scheme). Note (faithful to the reference): void
    candidates accepted from the same batch are only checked against
    previously-accepted voids, not against each other, so voids can
    occasionally overlap and merge into larger cavities.

    Args:
        n: Number of points.
        rect_min / rect_max: Box corners (defines the ambient dimension).
        k: Number of voids.
        void_radius_range: (min_radius, max_radius) of the voids.
        seed: RNG seed.
        device: device for the result (default "cuda").
        batch_factor: Candidate multiplier per rejection round.

    Returns:
        (points (n, d), void_centres (k, d), void_radii (k,)) float32 tensors.
    """
    rng = np.random.default_rng(seed) if seed else np.random.default_rng()

    assert len(rect_min) == len(
        rect_max
    ), "rect_min and rect_max must have the same dimension."
    d = len(rect_min)
    r_min, r_max = void_radius_range
    lo = np.asarray(rect_min, dtype=np.float64)
    hi = np.asarray(rect_max, dtype=np.float64)

    # Phase 1: place k mutually disjoint voids (kept fully inside the box).
    centres = np.empty((0, d))
    radii = np.empty((0,))
    while centres.shape[0] < k:
        b = max(8, 2 * (k - centres.shape[0]))
        cand_c = (lo + r_max) + (hi - lo - 2 * r_max) * rng.random((b, d))
        cand_r = r_min + (r_max - r_min) * rng.random(b)
        if centres.shape[0] == 0:
            ok = np.ones(b, dtype=bool)
        else:
            dist = np.linalg.norm(cand_c[:, None, :] - centres[None, :, :], axis=2)
            ok = (dist >= (cand_r[:, None] + radii[None, :])).all(axis=1)
        keep = np.flatnonzero(ok)[: k - centres.shape[0]]
        centres = np.concatenate([centres, cand_c[keep]], axis=0)
        radii = np.concatenate([radii, cand_r[keep]], axis=0)

    # Phase 2: rejection-sample points outside every void, in large batches.
    chunks = []
    got = 0
    while got < n:
        todo = n - got
        b = batch_factor * todo
        cand = lo + (hi - lo) * rng.random((b, d))
        if k:
            good = np.ones(b, dtype=bool)
            for j in range(k):
                dj = np.linalg.norm(cand - centres[j], axis=1)
                good &= dj >= radii[j]
        else:
            good = np.ones(b, dtype=bool)
        accepted = cand[good][:todo]
        chunks.append(accepted)
        got += accepted.shape[0]

    pts = np.concatenate(chunks, axis=0).astype(np.float32)
    return (
        _put(pts, device),
        _put(centres.astype(np.float32), device),
        _put(radii.astype(np.float32), device),
    )


def generate_annulus_points_2d(
    n: int = 1000,
    center=(0.0, 0.0),
    radius: float = 1.0,
    width: float = 0.2,
    seed: int = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate 2D points uniformly distributed in an annulus.

    Samples uniformly in the ring between radius ``radius - width`` and
    ``radius`` via sqrt-uniform radii (reference
    synthetic_data_generators.py:175-217).

    Args:
        n: Number of points.
        center: Center of the annulus, shape (2,).
        radius: Outer radius (> 0).
        width: Ring thickness (> 0).
        seed: RNG seed.
        device: device for the result (default "cuda").

    Returns:
        (n, 2) float32 tensor.
    """
    center = np.asarray(center, dtype=np.float64).reshape(-1)
    assert center.shape == (2,), "Center must be a 2D point."
    assert radius > 0 and width > 0, "Radius and width must be positive."

    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()

    angles = rng.random(n) * 2 * np.pi
    r = radius - width + width * np.sqrt(rng.random(n))
    x = center[0] + r * np.cos(angles)
    y = center[1] + r * np.sin(angles)
    pts = np.stack((x, y), axis=1).astype(np.float32)
    return _put(pts, device)


def generate_noisy_torus_points_3d(
    n: int = 1000,
    R: float = 3.0,
    r: float = 1.0,
    noise_std: float = 0.02,
    seed: int = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate 3D points on a torus with added Gaussian noise.

    Uniform angle sampling on a torus with major radius ``R`` and minor
    radius ``r`` plus isotropic Gaussian noise (reference
    synthetic_data_generators.py:220-269).

    Args:
        n: Number of points.
        R: Major radius.
        r: Minor radius.
        noise_std: Gaussian noise std.
        seed: RNG seed.
        device: device for the result (default "cuda").

    Returns:
        (n, 3) float32 tensor.
    """
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()

    theta = rng.random(n) * 2 * np.pi
    phi = rng.random(n) * 2 * np.pi

    x = (R + r * np.cos(phi)) * np.cos(theta)
    y = (R + r * np.cos(phi)) * np.sin(theta)
    z = r * np.sin(phi)

    pts = np.stack((x, y, z), axis=1)
    pts = pts + rng.normal(0.0, 1.0, size=pts.shape) * noise_std
    return _put(pts.astype(np.float32), device)
