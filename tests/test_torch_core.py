"""The port's flood_complex on the CPU against flooder_tpu.flood_complex,
with the same X, L and seeds. Mirrors test_pallas_vs_dense, test_pallas_2d
and test_pallas_tight_prune_lossless (tests/test_pallas.py) and
test_filtration_condition (tests/test_flooder.py). The parity bar: the same
simplex set, values within 1e-5, inf exactly where the reference has inf,
and the same persistence diagrams."""

import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.topology import bottleneck_distance
from flooder_tpu_torch import core as core_t


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """K1's plain version is a loop of small torch ops: on one thread it
    does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_complex(ref: dict, got: dict):
    assert set(ref) == set(got)
    for simplex, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[simplex]), simplex
        else:
            assert abs(got[simplex] - val) < 1e-5, (simplex, got[simplex], val)


def _assert_same_diagrams(ref_tree, got_tree, dims):
    ref_tree.compute_persistence()
    got_tree.compute_persistence()
    for d in range(dims):
        a = ref_tree.persistence_intervals_in_dimension(d)
        b = got_tree.persistence_intervals_in_dimension(d)
        # pairs of (near) zero persistence may fall on either side of the
        # diagonal filter under 1e-7 value differences; the rest must match
        for tol in (1e-4, 1e-3):
            assert ((a[:, 1] - a[:, 0]) > tol).sum() == (
                (b[:, 1] - b[:, 0]) > tol
            ).sum(), d
        assert bottleneck_distance(a, b) < 1e-5, d


@pytest.mark.parametrize("num_landmarks", [20, 150])
@pytest.mark.parametrize("use_rand", [True, False])
def test_port_vs_flooder_tpu(num_landmarks, use_rand):
    kwargs = (
        {"num_rand": 256, "points_per_edge": None}
        if use_rand
        else {"num_rand": None, "points_per_edge": 10}
    )
    _assert_port_matches_on_the_torus(num_landmarks, kwargs)


@pytest.mark.parametrize("num_landmarks", [20, 150])
def test_port_vs_flooder_tpu_random_in_several_patches(num_landmarks):
    """Random mode at 600 samples a simplex: 5 patches of 128 in every
    pass, each admitting its own work."""
    from flooder_tpu_torch.ops import cuda_flood as cf

    assert cf._tile_geometry(600, 3)[:2] == (128, 5)
    _assert_port_matches_on_the_torus(
        num_landmarks, {"num_rand": 600, "points_per_edge": None})


def _assert_port_matches_on_the_torus(num_landmarks, kwargs):
    X = np.asarray(fj.generate_noisy_torus_points_3d(1500, seed=42))
    L = np.asarray(fj.generate_landmarks(X, num_landmarks, start_idx=0))
    np.random.seed(42)
    ref = fj.flood_complex(X, L, use_pallas=False, **kwargs)
    np.random.seed(42)
    got = ft.flood_complex(X, L, device="cpu", **kwargs)
    _assert_same_complex(ref, got)


def test_port_2d():
    X = np.asarray(fj.generate_figure_eight_points_2d(800, seed=1))
    L = np.asarray(fj.generate_landmarks(X, 120, start_idx=0))
    ref = fj.flood_complex(X, L, points_per_edge=12, use_pallas=False)
    got = ft.flood_complex(X, L, points_per_edge=12, device="cpu")
    _assert_same_complex(ref, got)


def test_port_tight_prune_lossless():
    X = np.asarray(fj.generate_noisy_torus_points_3d(2000, seed=9))
    L = np.asarray(fj.generate_landmarks(X, 120, start_idx=0))
    ref = fj.flood_complex(X, L, points_per_edge=10, use_pallas=False)
    got = ft.flood_complex(X, L, points_per_edge=10, device="cpu",
                           landmarks_in_cloud=True)
    _assert_same_complex(ref, got)


def test_explicit_landmarks_off_cloud_give_inf_like_reference():
    X = np.asarray(fj.generate_noisy_torus_points_3d(1200, seed=4))
    rng = np.random.default_rng(0)
    L = (rng.random((30, 3)) * 8 - 4).astype(np.float32)
    ref = fj.flood_complex(X, L, points_per_edge=6, use_pallas=False)
    got = ft.flood_complex(X, L, points_per_edge=6, device="cpu")
    _assert_same_complex(ref, got)
    assert any(np.isinf(v) for v in ref.values())


@pytest.mark.parametrize("use_rand", [True, False])
def test_slice_ends_in_same_diagrams(use_rand):
    """FPS -> flood_complex -> persistence, landmark count given as an int,
    on the swiss cheese the headline uses (cut to 2k points)."""
    kwargs = {"num_rand": 200, "points_per_edge": None} if use_rand else {}
    X = np.asarray(fj.generate_swiss_cheese_points(2000, k=6, seed=42)[0])
    np.random.seed(1)
    ref = fj.flood_complex(X, 100, use_pallas=False,
                           return_simplex_tree=True, **kwargs)
    np.random.seed(1)
    got = ft.flood_complex(X, 100, device="cpu", return_simplex_tree=True,
                           **kwargs)
    _assert_same_complex(
        {tuple(s): f for s, f in ref.get_simplices()},
        {tuple(s): f for s, f in got.get_simplices()},
    )
    _assert_same_diagrams(ref, got, 3)


@pytest.mark.parametrize("use_rand", [True, False])
@pytest.mark.parametrize("return_simplex_tree", [True, False])
def test_filtration_condition(use_rand, return_simplex_tree):
    np.random.seed(42)
    X = ft.generate_noisy_torus_points_3d(1000, seed=42, device="cpu")
    L = ft.generate_landmarks(X, 100, start_idx=0, device="cpu")
    kwargs = (
        {"num_rand": 256, "points_per_edge": None}
        if use_rand
        else {"num_rand": None, "points_per_edge": 10}
    )
    if not return_simplex_tree:
        fc = ft.flood_complex(X, L, return_simplex_tree=False,
                              device="cpu", **kwargs)
        st = ft.topology.SimplexTree()
        for simplex in fc:
            st.insert(simplex, float("inf"))
        for simplex in fc:
            st.assign_filtration(simplex, fc[simplex])
    else:
        st = ft.flood_complex(X, L, return_simplex_tree=True, device="cpu",
                              **kwargs)
    for simplex, filtration in st.get_simplices():
        faces = list(st.get_boundaries(simplex))
        assert len(faces) == (len(simplex) if len(simplex) > 1 else 0)
        for face, face_filtration in faces:
            assert face_filtration <= filtration + 1e-12


def test_engine_cache_same_tensor_hit_and_eviction():
    core_t._ENGINE_CACHE.clear()
    X = ft.generate_noisy_torus_points_3d(1200, seed=3, device="cpu")
    L = ft.generate_landmarks(X, 30, start_idx=0, device="cpu")
    out1 = ft.flood_complex(X, L, points_per_edge=6, device="cpu")
    assert len(core_t._ENGINE_CACHE) == 1
    eng1 = core_t._ENGINE_CACHE[0][2]
    out2 = ft.flood_complex(X, L, points_per_edge=6, device="cpu")
    assert core_t._ENGINE_CACHE[-1][2] is eng1
    assert out1 == out2
    Y = X + 0  # equal values, another object: a miss
    ft.flood_complex(Y, L, points_per_edge=6, device="cpu")
    assert len(core_t._ENGINE_CACHE) == 2
    del Y
    Z = ft.generate_noisy_torus_points_3d(1100, seed=4, device="cpu")
    ft.flood_complex(Z, 25, points_per_edge=6, device="cpu")
    assert len(core_t._ENGINE_CACHE) <= core_t._ENGINE_CACHE_CAP
    assert all(e[0]() is not None for e in core_t._ENGINE_CACHE)
    core_t._ENGINE_CACHE.clear()


def test_dict_matches_tree_and_landmark_validation():
    X = ft.generate_noisy_torus_points_3d(800, seed=3, device="cpu")
    L = ft.generate_landmarks(X, 60, start_idx=0, device="cpu")
    fc = ft.flood_complex(X, L, points_per_edge=8, device="cpu")
    st = ft.flood_complex(X, L, points_per_edge=8, device="cpu",
                          return_simplex_tree=True)
    assert fc == {tuple(s): f for s, f in st.get_simplices()}
    with pytest.raises(RuntimeError):
        ft.flood_complex(X, L.double(), points_per_edge=5, device="cpu")
    fc = ft.flood_complex(X[:70], 600, points_per_edge=5, device="cpu")
    assert sum(len(s) == 1 for s in fc) == 70  # clamped to 70 landmarks
    assert isinstance(next(iter(fc.values())), float)
    assert torch.is_tensor(L)


def test_landmarks_on_another_device_are_refused():
    """As flooder_tpu (core.py:379-383): a landmark tensor on another device
    than the tensor cloud raises before any move (a meta tensor cannot be
    moved); numpy inputs carry no device and are moved, and ``device=``
    moves a cloud and landmarks that share a device."""
    X = ft.generate_noisy_torus_points_3d(600, seed=3, device="cpu")
    L = ft.generate_landmarks(X, 24, start_idx=0, device="cpu")
    with pytest.raises(RuntimeError,
                       match=r"landmarks\.device \(meta\) != points\.device "
                             r"\(cpu\)"):
        ft.flood_complex(X, L.to("meta"), points_per_edge=4, device="cpu")
    want = ft.flood_complex(X, L, points_per_edge=4, device="cpu")
    assert ft.flood_complex(X, L.numpy(), points_per_edge=4,
                            device="cpu") == want
    assert ft.flood_complex(X.numpy(), L, points_per_edge=4,
                            device="cpu") == want
