"""Clouds of more than 4 coordinates through the port against flooder_tpu:
the reference's 5-D grid-mode and 6-D random-mode edge cases
(tests/test_edge_cases.py:190-226) on the kernel route (whose CUDA kernels
are built for 1-8 coordinates), the 5-D one also on the dense engine, and
a 17-D cloud,
past the native reduction's 16 coordinates, on the dense engine's torch
ops. Parity bar: the same simplices, values within 1e-5."""

import numpy as np

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu_torch import core as core_t


def _assert_same_complex(ref: dict, got: dict, tol: float = 1e-5):
    assert set(ref) == set(got)
    for simplex, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[simplex]), simplex
        else:
            assert abs(got[simplex] - val) < tol, (simplex, got[simplex], val)


def test_dense_matches_reference_past_16_coordinates():
    """A CPU cloud of 17 coordinates runs the torch ops (the native
    reduction stops at 16), as the reference runs its XLA scan."""
    rng = np.random.default_rng(4)
    X = rng.random((400, 17)).astype(np.float32)
    L = X[:18]  # at most dim + 1 landmarks: one simplex, no Qhull
    np.random.seed(5)
    ref = fj.flood_complex(X, L, num_rand=16, points_per_edge=None,
                           max_dimension=1, use_pallas=False)
    np.random.seed(5)
    got = ft.flood_complex(X, L, num_rand=16, points_per_edge=None,
                           max_dimension=1, use_pallas=False, device="cpu")
    assert core_t._ENGINE_CACHE[-1][2]._native is None
    _assert_same_complex(ref, got)
    core_t._ENGINE_CACHE.clear()


def test_5d_cloud_grid_mode_matches_flooder_tpu():
    """tests/test_edge_cases.py::test_5d_cloud_grid_mode against the
    reference, on the kernel route and the dense engine."""
    pts = np.random.default_rng(7).random((1200, 5)).astype(np.float32)
    ref = fj.flood_complex(pts, 24, points_per_edge=4, start_idx=0)
    assert max(len(s) for s in ref) == 6
    for use_pallas in (None, False):
        got = ft.flood_complex(pts, 24, points_per_edge=4, start_idx=0,
                               use_pallas=use_pallas, device="cpu")
        _assert_same_complex(ref, got)


def test_6d_cloud_random_mode_matches_flooder_tpu():
    """tests/test_edge_cases.py::test_6d_cloud_random_mode against the
    reference, on the kernel route (every dimension pass 0..6)."""
    pts = np.random.default_rng(8).random((800, 6)).astype(np.float32)
    kw = dict(num_rand=32, points_per_edge=None, start_idx=0)
    np.random.seed(3)
    ref = fj.flood_complex(pts, 16, **kw)
    assert {len(s) for s in ref} == set(range(1, 8))
    np.random.seed(3)
    _assert_same_complex(ref, ft.flood_complex(pts, 16, device="cpu", **kw))
