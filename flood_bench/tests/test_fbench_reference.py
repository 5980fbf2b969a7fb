"""The plain reference: its pieces on known inputs, its agreement with the
program's CPU path at a tiny size, and its refusal of a perturbed value
and a dropped simplex."""

import itertools
import json
from collections import Counter

import numpy as np
import pytest
import torch

from conftest import BENCH
from fbench import compare, generators, reference

GRID8 = {"mode": "grid", "points_per_edge": 8}


def test_grid_weights_count_and_sum():
    for ppe, k in ((30, 4), (30, 3), (8, 4), (2, 2)):
        w = reference.grid_weights(ppe, k)
        n = len(list(itertools.combinations(range(ppe + k - 2), k - 1)))
        assert w.shape == (n, k)
        assert np.allclose(w.sum(1), 1.0) and (w >= 0).all()
        assert len({tuple(r) for r in w}) == n
    assert len(reference.grid_weights(30, 4)) == 4960


@pytest.mark.parametrize("name", ["cheese3d-10M-L1k", "eight2d-40M-L2k"])
def test_the_pruned_minima_equal_a_brute_force_over_the_ball(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["n_points"] = 20000
    cloud = generators.make_cloud(cfg, 2**31 + 11, 1, "cpu")
    index = reference._Witnesses(cloud, cloud[:50])
    assert index.grid > 1
    g = torch.Generator().manual_seed(0)
    dim = cloud.shape[1]
    jobs = []
    for r in (0.01, 0.05, 0.2, 2.0):
        for n_s in (1, 40, 300):
            c = cloud[int(torch.randint(0, 20000, (1,), generator=g))].double()
            c = (c + 0.05 * torch.randn(dim, generator=g,
                                        dtype=torch.float64)).numpy()
            local = (torch.rand((n_s, dim), generator=g, dtype=torch.float64)
                     - 0.5).numpy() * r
            jobs.append((c, r, local))
    jobs.append((np.full(dim, 9.0), 0.1, jobs[0][2]))  # no witness
    pts = cloud.double().numpy()
    for (c, r, local), got in zip(jobs, index.minima(jobs)):
        d2c = ((pts - c) ** 2).sum(1)
        d2 = ((local[:, None, :] - (pts - c)[None]) ** 2).sum(-1)
        for col, band in ((0, 1 + reference.BAND), (1, 1 - reference.BAND)):
            want = np.where(d2c <= r * r * band, d2, np.inf).min(1)
            assert np.array_equal(np.isinf(got[:, col]), np.isinf(want))
            fin = np.isfinite(want)
            assert np.allclose(got[fin, col], want[fin], rtol=0, atol=1e-15)


def test_bounding_ball_of_a_right_triangle():
    v = torch.tensor([[[0.0, 0.0], [2.0, 0.0], [0.0, 1.0]]])
    c, r = reference.bounding_balls(v)
    assert torch.allclose(c, torch.tensor([[1.0, 0.5]], dtype=torch.float64))
    assert float(r[0]) == pytest.approx(np.sqrt(1.25) * 1.42 + 1e-3)


def test_fps_on_a_line_takes_the_first_of_tied_points():
    pts = torch.tensor([[0.0], [1.0], [10.0], [4.0], [6.0]])
    idx, upd, ties, _ = reference.fps(pts, 4, 0, count_updates=True)
    assert idx.tolist() == [0, 2, 3, 4]
    assert int(upd) >= 5 and ties.tolist() == [1, 1, 2, 1]


def test_diagram_of_a_filled_and_a_hollow_triangle():
    hollow = [((0,), 0.0), ((1,), 0.0), ((2,), 0.0),
              ((0, 1), 1.0), ((1, 2), 2.0), ((0, 2), 3.0)]
    assert reference.diagram(hollow) == Counter({
        (0, 0.0, float("inf")): 1, (0, 0.0, 1.0): 1, (0, 0.0, 2.0): 1,
        (1, 3.0, float("inf")): 1})
    filled = hollow + [((0, 1, 2), 5.0)]
    d = reference.diagram(filled)
    assert d[(1, 3.0, 5.0)] == 1 and (1, 3.0, float("inf")) not in d


def _program_answer(cloud, n_lms, ppe):
    import flooder_tpu_torch

    st = flooder_tpu_torch.flood_complex(
        cloud, n_lms, points_per_edge=ppe, max_dimension=cloud.shape[1],
        return_simplex_tree=True, device="cpu")
    return {tuple(v): f for v, f in st.get_simplices()}, \
        compare.diagram_counter(st.persistence())


@pytest.mark.parametrize("name", ["cheese3d-10M-L1k", "eight2d-40M-L2k"])
def test_reference_agrees_with_the_program_on_the_cpu(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["n_points"] = 2500
    cloud = generators.make_cloud(cfg, 2**31 + 3, 1, "cpu")
    values, diag = _program_answer(cloud, 30, 8)
    ref = compare.ReferenceComplex(cloud, 30)
    assert ref.simplex_set() == set(values)
    every = sorted(values)
    bounds = reference.FloodIntervals(cloud, ref.landmarks, ref.cells,
                                      8).values(every)
    gaps = [compare.relative_gap(values[s], lo, hi)
            for s, (lo, hi) in zip(every, bounds)]
    assert max(gaps) <= compare.LIMITS["filtration_gap"]
    assert reference.diagram(values.items()) == diag
    got = compare.check_cloud(cloud, 30, GRID8, values, diag, 8,
                              np.random.default_rng(0))
    assert compare.verdict(dict(got, bad_answers=0))


def test_random_mode_agrees_from_the_host_seed_and_not_from_another():
    import flooder_tpu_torch

    cfg = json.loads((BENCH / "configs" / "cheese3d-10M-L1k.json").read_text())
    cfg["n_points"] = 2500
    cloud = generators.make_cloud(cfg, 2**31 + 5, 1, "cpu")
    sampling = {"mode": "random", "num_rand": 16, "host_seed": 4242}
    np.random.seed(4242)
    st = flooder_tpu_torch.flood_complex(
        cloud, 30, num_rand=16, max_dimension=3, return_simplex_tree=True,
        device="cpu")
    values = {tuple(v): f for v, f in st.get_simplices()}
    ref = compare.ReferenceComplex(cloud, 30)
    assert ref.match(set(values)) == 0
    every = sorted(values)

    def worst(samp):
        bounds = reference.intervals(cloud, ref.landmarks, ref.cells,
                                     ref.levels, samp).values(every)
        return max(compare.relative_gap(values[s], lo, hi)
                   for s, (lo, hi) in zip(every, bounds))

    assert worst(sampling) <= compare.LIMITS["filtration_gap"]
    assert worst(dict(sampling, host_seed=4243)) > 3 * compare.LIMITS[
        "filtration_gap"]


def test_reference_rejects_a_perturbed_value_and_a_dropped_simplex():
    cfg = json.loads((BENCH / "configs" / "cheese3d-10M-L1k.json").read_text())
    cfg["n_points"] = 2500
    cloud = generators.make_cloud(cfg, 5, 1, "cpu")
    values, diag = _program_answer(cloud, 30, 8)
    top = max(values, key=lambda s: (len(s), values[s]))
    bumped = dict(values)
    bumped[top] = values[top] * 1.01
    got = compare.check_cloud(cloud, 30, GRID8, bumped, diag, 4,
                              np.random.default_rng(0))
    assert got["filtration_gap"] > compare.LIMITS["filtration_gap"]
    dropped = dict(values)
    del dropped[top]
    got = compare.check_cloud(cloud, 30, GRID8, dropped, diag, 4,
                              np.random.default_rng(0))
    assert got["simplex_mismatch"] == 1
    assert not compare.verdict(dict(got, bad_answers=0))


def test_an_exact_fps_tie_allows_either_greedy_pick():
    pts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 0.5],
                        [0.0, -0.5], [0.3, 0.2], [0.7, -0.2], [-0.4, 0.1]])
    idx, _, ties, _ = reference.fps(pts, 6, 0)
    assert idx.tolist()[:3] == [0, 1, 2] and int(ties[1]) == 2
    swapped = idx.clone()
    swapped[1], swapped[2] = idx[2], idx[1]
    levels = reference.delaunay_levels(
        reference.delaunay_cells(pts[swapped].double().numpy()))
    prog = {tuple(int(v) for v in r) for lv in levels for r in lv}
    ref = compare.ReferenceComplex(pts, 6)
    assert ref.simplex_set() != prog
    assert ref.match(prog) == 0
    assert torch.equal(ref.landmarks, pts[swapped])
    assert idx.tolist()[5] == 7
    # point 6 as the last landmark: no greedy rule takes it there
    bad = {tuple(int(v) for v in r) for lv in reference.delaunay_levels(
        reference.delaunay_cells(pts[[0, 2, 1, 3, 4, 6]].double().numpy()))
        for r in lv}
    assert compare.ReferenceComplex(pts, 6).match(bad) > 0
