"""The clouds: deterministic from (seed, index), distinct across indices,
and drawn with the upstream parameters."""

import json

import torch

from conftest import BENCH
from fbench import generators


def _cfg(name, n):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["n_points"] = n
    return cfg


def test_same_seed_and_index_same_cloud_other_index_other_cloud():
    for name in ("cheese3d-10M-L1k", "eight2d-40M-L2k"):
        cfg = _cfg(name, 5000)
        seed = 2**31 + 11
        a = generators.make_cloud(cfg, seed, 3, "cpu")
        b = generators.make_cloud(cfg, seed, 3, "cpu")
        c = generators.make_cloud(cfg, seed, 4, "cpu")
        d = generators.make_cloud(cfg, seed + 1, 3, "cpu")
        assert a.shape == (5000, cfg["dim"]) and a.dtype == torch.float32
        assert torch.equal(a, b)
        assert not torch.equal(a, c) and not torch.equal(a, d)


def test_cheese_points_fill_the_box_outside_the_upstream_voids():
    cfg = _cfg("cheese3d-10M-L1k", 20000)
    p = cfg["params"]
    assert (p["k"], p["void_radius_range"]) == (6, [0.1, 0.2])
    pts = generators.make_cloud(cfg, 7, 1, "cpu").double()
    centres, radii = generators.cheese_voids(7, 1, **p)
    assert centres.shape == (6, 3)
    assert ((radii >= 0.1) & (radii <= 0.2)).all()
    assert ((centres >= 0.2) & (centres <= 0.8)).all()
    assert (pts >= 0).all() and (pts <= 1).all()
    dist = torch.cdist(pts, centres)
    assert (dist >= radii[None] - 1e-6).all()


def test_figure_eight_lobes_carry_the_upstream_radii_and_noise():
    cfg = _cfg("eight2d-40M-L2k", 200000)
    p = cfg["params"]
    assert p == {"r_bounds": [0.2, 0.3], "centers": [[0.3, 0.5], [0.7, 0.5]],
                 "noise_std": 0.02}
    pts = generators.make_cloud(cfg, 9, 2, "cpu").double()
    cen = torch.tensor(p["centers"], dtype=torch.float64)
    r = torch.cdist(pts, cen)
    inside = ((r > 0.2) & (r < 0.3)).any(dim=1).double().mean()
    assert inside > 0.8
    left = (pts[:, 0] < 0.5).double().mean()
    assert 0.45 < left < 0.55
    noiseless = dict(cfg, params=dict(p, noise_std=0.0))
    q = generators.make_cloud(noiseless, 9, 2, "cpu").double()
    rq = torch.cdist(q, cen)
    assert ((rq >= 0.2 - 1e-6) & (rq <= 0.3 + 1e-6)).any(dim=1).all()
