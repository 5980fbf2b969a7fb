"""The port's FPS (the plain version of kernel K2) against flooder_tpu's
XLA loop and its Pallas kernel in interpret mode, under the greedy-
selection rule of tests/test_landmarks.py, also past 8 coordinates; the
kernel's layout preparation against the TPU kernel's, and its own checks
past 8 coordinates."""

import jax
import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.ops.fps import farthest_point_sampling as fps_xla
from flooder_tpu.ops.pallas_fps import pallas_farthest_point_sampling
from flooder_tpu_torch.ops import cuda_fps
from flooder_tpu_torch.ops.fps import farthest_point_sampling as fps_torch
from test_landmarks import _assert_same_greedy_selection


@pytest.mark.parametrize("n,n_lms", [(500, 16), (9000, 128)])
def test_plain_fps_matches_xla_and_pallas(n, n_lms):
    pts = np.asarray(fj.generate_noisy_torus_points_3d(n, seed=4))
    got = fps_torch(torch.tensor(pts), n_lms, 7).numpy()
    want = np.asarray(fps_xla(pts, n_lms, 7))
    _assert_same_greedy_selection(pts, got, want, 7)
    kern = np.asarray(pallas_farthest_point_sampling(pts, n_lms, 7,
                                                     interpret=True))
    _assert_same_greedy_selection(pts, got, kern, 7)


def test_wrapper_uses_plain_version_on_cpu():
    pts = torch.tensor(
        np.asarray(fj.generate_noisy_torus_points_3d(700, seed=2))
    )
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, 30, 3)
    assert cuda_fps.LAUNCHES == before  # no kernel on the CPU
    assert torch.equal(got, fps_torch(pts, 30, 3))


@pytest.mark.parametrize("n,dim", [(9000, 3), (5000, 2), (300, 1)])
def test_fps_prepare_matches_tpu_layout(n, dim):
    from flooder_tpu.ops.pallas_fps import FPS_CHUNK, _fps_prepare

    rng = np.random.default_rng(n)
    x = rng.random((n, dim)).astype(np.float32)
    pts_t, lo, hi, sstart, order = cuda_fps._fps_prepare(
        torch.from_numpy(x), 11
    )
    assert cuda_fps.FPS_CHUNK == FPS_CHUNK
    j_pts, j_lo, j_hi, j_start, j_order = _fps_prepare(
        x, np.int32(11), chunk=FPS_CHUNK, dim_pad=8
    )
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert int(sstart) == int(j_start)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(j_pts)[:dim])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo)[:dim])
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi)[:dim])


@pytest.mark.parametrize("start_idx", [0, 17, None])
def test_generate_landmarks_same_as_flooder_tpu(start_idx):
    X = np.asarray(fj.generate_noisy_torus_points_3d(1500, seed=8))
    np.random.seed(3)
    want = np.asarray(fj.generate_landmarks(X, 60, start_idx=start_idx))
    np.random.seed(3)
    got = ft.generate_landmarks(X, 60, start_idx=start_idx, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_landmarks_clamps_and_validates():
    X = np.asarray(fj.generate_noisy_torus_points_3d(50, seed=3))
    assert ft.generate_landmarks(X, 100, start_idx=0,
                                 device="cpu").shape == (50, 3)
    with pytest.raises(RuntimeError):
        ft.generate_landmarks(X, 0, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [9, 16, 64, 100])
def test_plain_fps_matches_xla_past_8_coordinates(dim, dtype):
    """Past 8 coordinates flooder_tpu runs its XLA loop (the kernel K2's
    runtime-width instance there): the port's plain version makes the same
    greedy selection, in float32 and (with JAX in x64) float64."""
    pts = np.random.default_rng(dim).random((1500, dim)).astype(dtype)
    got = fps_torch(torch.from_numpy(pts), 40, 5).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(fps_xla(pts, 40, 5))
    _assert_same_greedy_selection(pts, got, want, 5)


@pytest.mark.parametrize("dim", [9, 64, 100])
def test_fps_prepare_past_8_coordinates(dim):
    """K2's layout past 8 coordinates: the sort is a permutation, the
    start index maps through it, every chunk box holds its points, the
    padding columns copy the start point, and two calls agree (the codes
    stay inside int64 at every width)."""
    n, start = 9000, 13
    x = np.random.default_rng(dim).random((n, dim)).astype(np.float32)
    prep = cuda_fps._fps_prepare(torch.from_numpy(x), start)
    pts_t, lo, hi, sstart, order = (t.numpy() for t in prep)
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    assert order[int(sstart[0])] == start
    chunk = cuda_fps.FPS_CHUNK
    assert pts_t.shape == (dim, 2 * chunk)
    np.testing.assert_array_equal(pts_t[:, :n], x[order].T)
    np.testing.assert_array_equal(
        pts_t[:, n:], np.repeat(x[start][:, None], 2 * chunk - n, axis=1))
    boxes = pts_t.reshape(dim, -1, chunk)
    np.testing.assert_array_equal(lo, boxes.min(2))
    np.testing.assert_array_equal(hi, boxes.max(2))
    again = cuda_fps._fps_prepare(torch.from_numpy(x), start)
    for a, b in zip(prep, again):
        assert torch.equal(a, b)
