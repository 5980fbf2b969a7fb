"""The clouds, made on the device from ``(seed, cloud index)``.

Torch copies of upstream flooder's generators
(``flooder/synthetic_data_generators.py``) with the upstream parameters,
drawn with a ``torch.Generator`` on the cloud's device in a few large
calls, in float64 and returned as float32 as upstream returns them. The
same ``(seed, index)`` gives the same cloud on the same device; every
index gives a new cloud of the same size.

A configuration names its generator by the key of ``GENERATORS`` and
passes its ``params`` as keyword arguments.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch


def stream_seed(seed: int, index: int, stream: int) -> int:
    """A 64-bit generator seed from the run's seed, the cloud's index and
    a stream tag (so the voids and the points of a cloud draw apart)."""
    s = int(seed) % (1 << 64)
    words = [s & 0xFFFFFFFF, s >> 32, int(index) & 0xFFFFFFFF, int(stream)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def cheese_voids(seed: int, index: int, *, rect_min: Sequence[float],
                 rect_max: Sequence[float], k: int,
                 void_radius_range: Sequence[float], **_):
    """The voids of cloud ``index``: (centres (k, d), radii (k,)) float64
    on the host, placed by rejection as upstream places them: each inside
    the box and disjoint from the voids accepted before it (a batch's
    candidates are checked against earlier voids only)."""
    d = len(rect_min)
    lo = torch.tensor(rect_min, dtype=torch.float64)
    hi = torch.tensor(rect_max, dtype=torch.float64)
    r_min, r_max = (float(v) for v in void_radius_range)
    gv = _generator(torch.device("cpu"), stream_seed(seed, index, 1))
    centres = torch.empty((0, d), dtype=torch.float64)
    radii = torch.empty((0,), dtype=torch.float64)
    while centres.shape[0] < k:
        b = max(8, 2 * (k - centres.shape[0]))
        cand_c = (lo + r_max) + (hi - lo - 2 * r_max) * torch.rand(
            (b, d), generator=gv, dtype=torch.float64)
        cand_r = r_min + (r_max - r_min) * torch.rand(
            b, generator=gv, dtype=torch.float64)
        if centres.shape[0] == 0:
            ok = torch.ones(b, dtype=torch.bool)
        else:
            dist = torch.linalg.vector_norm(
                cand_c[:, None, :] - centres[None], dim=2)
            ok = (dist >= cand_r[:, None] + radii[None]).all(dim=1)
        keep = torch.nonzero(ok).flatten()[: k - centres.shape[0]]
        centres = torch.cat([centres, cand_c[keep]])
        radii = torch.cat([radii, cand_r[keep]])
    return centres, radii


def swiss_cheese(n: int, seed: int, index: int, device, *,
                 rect_min: Sequence[float], rect_max: Sequence[float],
                 k: int, void_radius_range: Sequence[float],
                 oversample: float = 1.25) -> torch.Tensor:
    """Points in a box with ``k`` spherical voids (upstream
    ``generate_swiss_cheese_points``): the voids of ``cheese_voids``, then
    points drawn uniformly in the box and kept outside every void."""
    device = torch.device(device)
    d = len(rect_min)
    lo = torch.tensor(rect_min, dtype=torch.float64)
    hi = torch.tensor(rect_max, dtype=torch.float64)
    centres, radii = cheese_voids(
        seed, index, rect_min=rect_min, rect_max=rect_max, k=k,
        void_radius_range=void_radius_range)
    gp = _generator(device, stream_seed(seed, index, 2))
    lo_d, hi_d = lo.to(device), hi.to(device)
    c_d, r2_d = centres.to(device), (radii * radii).to(device)
    parts, got = [], 0
    while got < n:
        todo = n - got
        b = int(math.ceil(todo * oversample)) + 1024
        cand = lo_d + (hi_d - lo_d) * torch.rand(
            (b, d), generator=gp, dtype=torch.float64, device=device)
        good = torch.ones(b, dtype=torch.bool, device=device)
        for j in range(c_d.shape[0]):
            good &= ((cand - c_d[j]) ** 2).sum(1) >= r2_d[j]
        acc = cand[good][:todo]
        parts.append(acc)
        got += acc.shape[0]
    return torch.cat(parts).to(torch.float32).contiguous()


def figure_eight_2d(n: int, seed: int, index: int, device, *,
                    r_bounds: Sequence[float],
                    centers: Sequence[Sequence[float]],
                    noise_std: float) -> torch.Tensor:
    """Points on two annular lobes with Gaussian noise (upstream
    ``generate_figure_eight_points_2d``): a lobe drawn per point, radius
    uniform in area between the bounds, angle uniform, then noise."""
    device = torch.device(device)
    g = _generator(device, stream_seed(seed, index, 3))
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    lobe = torch.randint(0, 2, (n,), device=device, generator=g)
    cen = torch.tensor(centers, dtype=torch.float64, device=device)
    r_min, r_max = (float(v) for v in r_bounds)
    r = torch.sqrt(r_min ** 2 + (r_max ** 2 - r_min ** 2) * torch.rand(n, **f64))
    theta = 2 * math.pi * torch.rand(n, **f64)
    xy = cen[lobe] + torch.stack([r * torch.cos(theta),
                                  r * torch.sin(theta)], dim=1)
    if noise_std > 0:
        xy = xy + noise_std * torch.randn((n, 2), **f64)
    return xy.to(torch.float32).contiguous()


GENERATORS: Dict[str, Callable[..., torch.Tensor]] = {
    "swiss_cheese": swiss_cheese,
    "figure_eight_2d": figure_eight_2d,
}


def make_cloud(config: dict, seed: int, index: int, device) -> torch.Tensor:
    """Cloud ``index`` of a run with ``seed``, as ``config`` states it:
    ``(n_points, dim)`` float32 on ``device``."""
    gen = GENERATORS[config["generator"]]
    return gen(int(config["n_points"]), seed, index, device,
               **config["params"])
