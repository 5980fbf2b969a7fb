"""Few samples a simplex: the tiles of K1's few-sample instances (128
samples, a warp a tile on the card) through the port on the CPU, where K1's
plain version runs.

Random mode at 1 and 64 samples a simplex against flooder_tpu (every
dimension pass 0..3), and K1's plain version at 1, 64, 126 and 256 samples
a simplex (one tile, and two tiles of 128 at 256) against the port's dense
engine on seeded simplices. Parity bar: the same simplices, values within
1e-5, inf exactly where the reference has inf."""

import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu_torch.ops import cuda_flood as cf
from flooder_tpu_torch.ops.flood import DenseFloodEngine, simplex_bounding_balls


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """K1's plain version is a loop of small torch ops: on one thread it
    does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(ref, got, tol=1e-5):
    """The same keys (simplices or (simplex, sample) cells), inf where the
    reference has inf, every other value within ``tol``."""
    assert set(ref) == set(got)
    for key, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[key]), key
        else:
            assert abs(got[key] - val) < tol, (key, got[key], val)


@pytest.mark.parametrize("num_rand", [1, 64])
def test_random_mode_matches_flooder_tpu(num_rand):
    """flooder_tpu.flood_complex on the CPU (as tests/test_torch_dims.py
    calls it) against the port's kernel route in random mode: one tile of
    128 slots a simplex in every pass."""
    X = np.asarray(fj.generate_noisy_torus_points_3d(2000, seed=12))
    kw = dict(num_rand=num_rand, points_per_edge=None, start_idx=0)
    np.random.seed(4)
    ref = fj.flood_complex(X, 60, **kw)
    assert {len(s) for s in ref} == {1, 2, 3, 4}
    assert cf._tile_geometry(num_rand) == (cf.FEW_RT, 1, cf.FEW_RT)
    np.random.seed(4)
    _assert_same(ref, ft.flood_complex(X, 60, device="cpu", **kw))


@pytest.mark.parametrize("r_count", [1, 64, 126, 256])
def test_plain_k1_matches_dense_engine_at_few_samples(r_count):
    """K1's plain version (the kernel engine on CPU tensors) against the
    dense engine on 24 seeded tetrahedra of a 3,000-point cloud, with balls
    that cut sub-chunks and some that hold no witness: the min distances of
    every (simplex, sample) within 1e-5, inf alike."""
    rng = np.random.default_rng(r_count)
    X = torch.from_numpy(rng.random((3000, 3)).astype(np.float32))
    verts = torch.from_numpy(
        (rng.random((24, 1, 3)) + (rng.random((24, 4, 3)) - 0.5) * 0.3)
        .astype(np.float32))
    centers, radii = simplex_bounding_balls(verts)
    radii[::5] = 1e-4  # balls that hold no witness
    w = rng.random((r_count, 4))
    w /= w.sum(axis=1, keepdims=True)
    rt, nr, _ = cf._tile_geometry(r_count)
    assert (rt, nr) == (cf.FEW_RT, -(-r_count // cf.FEW_RT))

    got = cf.CudaFloodEngine(X).min_distances(verts, w, centers, radii)
    want = DenseFloodEngine(X, 256).min_distances(verts, w, centers, radii)
    assert got.shape == want.shape == (24, r_count)
    assert torch.isinf(want).any() and torch.isfinite(want).any()
    cells = lambda t: {ij: v for ij, v in np.ndenumerate(t.numpy())}  # noqa: E731
    _assert_same(cells(want), cells(got))
