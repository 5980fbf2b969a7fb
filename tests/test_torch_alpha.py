"""The port's AlphaComplex and bottleneck_distance (topology/alpha.py and
topology/bottleneck.py) against flooder_tpu's on the same inputs, the
alpha and bottleneck cases of tests/test_topology.py, and the oracle test
test_vs_alpha (tests/test_flooder.py): with landmarks == points the Flood
complex's persistence matches the Alpha complex's within a bottleneck
distance of 1.1e-3 in dimensions 0 and 1."""

import numpy as np
import pytest

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.topology import alpha as alpha_j
from flooder_tpu.topology import bottleneck_distance as bottleneck_j
from flooder_tpu_torch.topology import AlphaComplex, bottleneck_distance
from flooder_tpu_torch.topology import alpha as alpha_t


def _diagrams(tree, dims=2):
    tree.compute_persistence()
    return [tree.persistence_intervals_in_dimension(i) for i in range(dims)]


def _alpha_diagrams(X, alpha_complex=AlphaComplex):
    return _diagrams(alpha_complex(np.asarray(X)).create_simplex_tree(
        output_squared_values=False))


@pytest.mark.parametrize("use_rand", [True, False])
@pytest.mark.parametrize("batch_size", [8, 23])
def test_vs_alpha(use_rand, batch_size):
    """The oracle test on the dense engine, as the reference runs it on the
    CPU: 600 figure-eight points, landmarks == points."""
    np.random.seed(42)
    X = ft.generate_figure_eight_points_2d(600, seed=42, device="cpu")
    if use_rand:
        kwargs = {"num_rand": 4000, "points_per_edge": None}
    else:
        kwargs = {"num_rand": None, "points_per_edge": 80}
    st = ft.flood_complex(X, X, return_simplex_tree=True,
                          batch_size=batch_size, use_pallas=False,
                          device="cpu", **kwargs)
    fd = _diagrams(st)
    ad = _alpha_diagrams(X.numpy())
    for dim in range(2):
        dist = bottleneck_distance(fd[dim], ad[dim])
        assert dist < 1.1e-3, (dim, use_rand, dist)


@pytest.mark.parametrize("use_rand", [True, False])
def test_vs_alpha_full(use_rand):
    """The reference-size oracle test: 1000 points, ppe 130 or 20,000
    random samples, bottleneck distance under 5e-4."""
    np.random.seed(42)
    X = ft.generate_figure_eight_points_2d(1000, seed=42, device="cpu")
    if use_rand:
        kwargs = {"num_rand": 20_000, "points_per_edge": None}
    else:
        kwargs = {"num_rand": None, "points_per_edge": 130}
    st = ft.flood_complex(X, X, return_simplex_tree=True, batch_size=23,
                          use_pallas=False, device="cpu", **kwargs)
    fd = _diagrams(st)
    ad = _alpha_diagrams(X.numpy())
    for dim in range(2):
        assert bottleneck_distance(fd[dim], ad[dim]) < 5e-4


def test_alpha_circle_h1():
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, 200)
    pts = np.stack([np.cos(theta), np.sin(theta)], 1)
    pts += rng.normal(0, 0.01, pts.shape)
    st = AlphaComplex(pts).create_simplex_tree(output_squared_values=False)
    st.compute_persistence()
    d1 = st.persistence_intervals_in_dimension(1)
    pers = d1[:, 1] - d1[:, 0]
    assert (pers > 0.5).sum() == 1
    d0 = st.persistence_intervals_in_dimension(0)
    assert np.isinf(d0[:, 1]).sum() == 1


def test_alpha_monotone():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, (150, 3))
    st = AlphaComplex(pts).create_simplex_tree()
    for simplex, filt in st.get_simplices():
        for face, face_filt in st.get_boundaries(simplex):
            assert face_filt <= filt + 1e-12


def test_alpha_matches_distance_on_pair():
    pts = np.array([[0.0, 0.0], [2.0, 0.0]])
    st = AlphaComplex(pts).create_simplex_tree()
    assert st.filtration([0, 1]) == pytest.approx(1.0)
    st2 = AlphaComplex(pts).create_simplex_tree(output_squared_values=False)
    assert st2.filtration([0, 1]) == pytest.approx(1.0)
    st3 = AlphaComplex(np.array([[0.0, 0.0], [4.0, 0.0]])).create_simplex_tree()
    assert st3.filtration([0, 1]) == pytest.approx(4.0)


def test_bottleneck_simple():
    d1 = np.array([[0.0, 10.0], [2.0, 5.0]])
    d2 = np.array([[0.5, 10.0], [2.0, 5.5]])
    assert bottleneck_distance(d1, d2) == pytest.approx(0.5)
    d3 = np.array([[0.0, 10.0], [4.0, 4.4]])
    d4 = np.array([[0.0, 10.0]])
    assert bottleneck_distance(d3, d4) == pytest.approx(0.2)


def test_bottleneck_inf_bars():
    d1 = np.array([[0.0, np.inf], [1.0, 2.0]])
    d2 = np.array([[0.25, np.inf], [1.0, 2.0]])
    assert bottleneck_distance(d1, d2) == pytest.approx(0.25)
    d3 = np.array([[0.0, np.inf], [0.0, np.inf]])
    assert bottleneck_distance(d1, d3) == np.inf


def test_bottleneck_identity():
    rng = np.random.default_rng(3)
    b = rng.uniform(0, 1, 50)
    diag = np.stack([b, b + rng.uniform(0, 1, 50)], 1)
    assert bottleneck_distance(diag, diag) == 0.0


def test_empty_diagrams():
    assert bottleneck_distance(np.empty((0, 2)), np.empty((0, 2))) == 0.0
    d = np.array([[0.0, 1.0]])
    assert bottleneck_distance(d, np.empty((0, 2))) == pytest.approx(0.5)


def _trees_equal(a, b):
    for d, (va, vb) in enumerate(zip(a._verts, b._verts)):
        np.testing.assert_array_equal(va, vb, err_msg=f"dim {d}")
    assert len(a._verts) == len(b._verts)
    for fa, fb in zip(a._filt, b._filt):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


@pytest.mark.parametrize(
    "dim,n,kw",
    [(2, 300, {}), (3, 200, {}), (3, 200, {"output_squared_values": False}),
     (2, 300, {"max_alpha_square": 0.002}),
     (2, 50, {"default_filtration_value": True})],
    ids=["2d", "3d", "3d-radii", "2d-pruned", "2d-default"],
)
def test_alpha_equals_flooder_tpu(dim, n, kw):
    """The same simplices and bit-equal filtrations as the reference."""
    pts = np.random.default_rng(dim * 100 + n).random((n, dim))
    got = AlphaComplex(pts).create_simplex_tree(**kw)
    want = alpha_j.AlphaComplex(pts).create_simplex_tree(**kw)
    if kw.get("default_filtration_value"):
        assert all(np.isnan(f).all() for f in got._filt)
        for va, vb in zip(got._verts, want._verts):
            np.testing.assert_array_equal(va, vb)
        return
    _trees_equal(got, want)
    assert AlphaComplex(pts).get_point(3).tolist() == pts[3].tolist()


def test_circumspheres_equal_flooder_tpu():
    rng = np.random.default_rng(4)
    for k, d in [(1, 2), (2, 2), (2, 3), (3, 3), (0, 3)]:
        verts = rng.random((40, k + 1, d))
        for got, want in zip(alpha_t.circumspheres(verts),
                             alpha_j.circumspheres(verts)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        AlphaComplex(np.zeros(5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bottleneck_equals_flooder_tpu(seed):
    """Random diagrams with essential classes and near-diagonal points: the
    exact value and the approximate one (e > 0) equal the reference's."""
    rng = np.random.default_rng(seed)
    n1, n2 = 30 + seed * 7, 25 + seed * 5
    b1, b2 = rng.random(n1), rng.random(n2)
    d1 = np.stack([b1, b1 + rng.exponential(0.2, n1)], 1)
    d2 = np.stack([b2, b2 + rng.exponential(0.2, n2)], 1)
    d1[0, 1] = d2[0, 1] = np.inf
    d2[1] = [0.4, 0.4]  # zero persistence: ignored by both
    for e in (None, 1e-3):
        assert bottleneck_distance(d1, d2, e) == bottleneck_j(d1, d2, e)
    assert bottleneck_distance(d1[1:], d2) == bottleneck_j(d1[1:], d2)


def test_flood_vs_alpha_diagrams_equal_flooder_tpu():
    """The oracle's inputs are the same in both packages: the port's Flood
    diagrams (dense engine) and Alpha diagrams equal the reference's, so the
    two bottleneck distances agree."""
    X = np.asarray(fj.generate_figure_eight_points_2d(300, seed=7))
    kw = dict(points_per_edge=40, return_simplex_tree=True)
    fd_t = _diagrams(ft.flood_complex(X, X, use_pallas=False, device="cpu",
                                      **kw))
    fd_j = _diagrams(fj.flood_complex(X, X, use_pallas=False, **kw))
    ad_t = _alpha_diagrams(X)
    ad_j = _alpha_diagrams(X, alpha_j.AlphaComplex)
    for dim in range(2):
        np.testing.assert_array_equal(ad_t[dim], ad_j[dim])
        assert bottleneck_distance(fd_t[dim], fd_j[dim]) < 1e-5
        assert bottleneck_distance(fd_t[dim], ad_t[dim]) == pytest.approx(
            bottleneck_j(fd_j[dim], ad_j[dim]), abs=1e-5)
