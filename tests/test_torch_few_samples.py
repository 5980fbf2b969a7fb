"""Few samples a simplex: the tiles of K1's few-sample instances (128
samples, a warp a tile on the card) through the port on the CPU, where K1's
plain version runs.

Which instance a launch takes (``k1_instance``: tiles of 128 samples the
few-sample ones at every width); random mode at 1 and 64 samples a simplex
against flooder_tpu (every dimension pass 0..3) and, on a 10-D cloud, at
64 and 256 (the few-sample instance past 8 coordinates on the card); and
K1's plain version at 1, 64, 126 and 256 samples a simplex at 3
coordinates, and at 1-384 at 10 (one to three tiles of 128), against the
port's dense engine on seeded simplices. Parity bar: the same simplices,
values within 1e-5, inf exactly where the reference has inf. Grid passes
past 384 samples a simplex at 1-8 coordinates take the same tiles as
128-sample patches: K1's plain version gives the face maxima of tiles of
512 there, bit for bit, with no more in-ball pairs."""

import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu_torch.ops import cuda_flood as cf
from flooder_tpu_torch.ops.flood import DenseFloodEngine, simplex_bounding_balls
from test_torch_cuda import tiled_operands


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


@pytest.mark.parametrize("dim", [3, 8, 9, 10, 16, 17, 64])
def test_tiles_of_128_samples_take_the_few_sample_launch(dim):
    """Tiles of FEW_RT samples take the few-sample instances at every width
    (past 8 coordinates the runtime-width ones: one slab up to 16, slabs
    past it); tiles of 256-512 samples take the instance that walks a
    block's simplices in a CTA past 8 coordinates, and are refused at 1-8.
    A pass takes tiles of FEW_RT at 1-8 coordinates whatever its samples a
    simplex (past 384, 128-sample patches), and past 8 up to 384 samples,
    RT above."""
    few = cf.k1_instance(cf.FEW_RT, dim)
    assert few == {3: "flood_min_few<3>", 8: "flood_min_few<8>",
                   17: "flood_min_few_slabs",
                   64: "flood_min_few_slabs"}.get(dim, "flood_min_few_wide")
    for rt in (256, 384, cf.RT):
        if dim > cf.KERNEL_MAX_DIM:
            assert cf.k1_instance(rt, dim) == "flood_min_wide"
        else:
            with pytest.raises(ValueError, match="tiles of 128"):
                cf.k1_instance(rt, dim)
    for r_count in (1, 384, 385, 465, 4960):
        rt, nr, total = cf._tile_geometry(r_count, dim)
        patches = dim <= cf.KERNEL_MAX_DIM or r_count <= cf.RT - cf.FEW_RT
        assert rt == (cf.FEW_RT if patches else cf.RT)
        assert (nr, total) == (-(-r_count // rt), -(-r_count // rt) * rt)
        assert cf.k1_instance(rt, dim).startswith("flood_min_few") == patches


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
    assert cf._tile_geometry(num_rand, 3) == (cf.FEW_RT, 1, cf.FEW_RT)
    np.random.seed(4)
    _assert_same(ref, ft.flood_complex(X, 60, device="cpu", **kw))


@pytest.mark.parametrize("num_rand", [64, 256])
def test_10d_random_mode_matches_flooder_tpu(num_rand):
    """flooder_tpu.flood_complex on the CPU against the port's kernel route
    in random mode on a 10-D cloud (as tests/test_torch_dims.py runs its 9-D
    and 12-D clouds): passes 0..3, one or two tiles of 128 slots a simplex
    in each, the few-sample instance past 8 coordinates on the card."""
    pts = np.random.default_rng(10).random((800, 10)).astype(np.float32)
    kw = dict(num_rand=num_rand, points_per_edge=None, start_idx=0,
              max_dimension=3)
    np.random.seed(3)
    ref = fj.flood_complex(pts, 12, **kw)
    assert any(len(s) == 4 and np.isfinite(v) for s, v in ref.items())
    rt = cf._tile_geometry(num_rand, 10)[0]
    assert cf.k1_instance(rt, 10) == "flood_min_few_wide"
    np.random.seed(3)
    _assert_same(ref, ft.flood_complex(pts, 12, device="cpu", **kw))


@pytest.mark.parametrize("dim,r_count", [
    pytest.param(3, 1, id="1"), pytest.param(3, 64, id="64"),
    pytest.param(3, 126, id="126"), pytest.param(3, 256, id="256"),
    pytest.param(10, 1, id="10d-1"), pytest.param(10, 64, id="10d-64"),
    pytest.param(10, 126, id="10d-126"), pytest.param(10, 256, id="10d-256"),
    pytest.param(10, 384, id="10d-384")])
def test_plain_k1_matches_dense_engine_at_few_samples(dim, r_count):
    """K1's plain version (the kernel engine on CPU tensors) against the
    dense engine on 24 seeded tetrahedra of a 3,000-point cloud of 3 or 10
    coordinates, with balls that cut sub-chunks and some that hold no
    witness: the min distances of every (simplex, sample) within 1e-5, inf
    alike."""
    rng = np.random.default_rng(r_count if dim == 3 else (dim, r_count))
    X = torch.from_numpy(rng.random((3000, dim)).astype(np.float32))
    spread = 0.3 if dim == 3 else 0.6  # 10-D balls of 0.3 hold no witness
    verts = torch.from_numpy(
        (rng.random((24, 1, dim)) + (rng.random((24, 4, dim)) - 0.5) * spread)
        .astype(np.float32))
    centers, radii = simplex_bounding_balls(verts)
    radii[::5] = 1e-4  # balls that hold no witness
    w = rng.random((r_count, 4))
    w /= w.sum(axis=1, keepdims=True)
    rt, nr, _ = cf._tile_geometry(r_count, dim)
    assert (rt, nr) == (cf.FEW_RT, -(-r_count // cf.FEW_RT))

    engine = cf.CudaFloodEngine(X)
    got = engine.min_distances(verts, w, centers, radii)
    want = DenseFloodEngine(X, 256).min_distances(verts, w, centers, radii)
    assert got.shape == want.shape == (24, r_count)
    assert torch.isinf(want).any() and torch.isfinite(want).any()
    if dim > cf.KERNEL_MAX_DIM:  # admitted units partly out of their balls
        units, inball = cf.kernel_operations(engine.last_stats)
        assert 0 < inball < units * cf.SUB * rt
    cells = lambda t: {ij: v for ij, v in np.ndenumerate(t.numpy())}  # noqa: E731
    _assert_same(cells(want), cells(got))


def _clustered_cloud_with_a_void(dim, n=3000, seed=5):
    """Half of the points uniform in the unit cube, half in four tight
    Gaussian clusters, and none within 0.3 of the cube's centre."""
    rng = np.random.default_rng(seed)
    uniform = rng.random((n // 2, dim))
    means = rng.random((4, dim))
    clusters = (means[rng.integers(0, 4, n - n // 2)]
                + rng.normal(0.0, 0.03, (n - n // 2, dim)))
    X = np.concatenate([uniform, clusters])
    X = X[np.linalg.norm(X - 0.5, axis=1) > 0.3]
    return torch.from_numpy(X.astype(np.float32))


def _face_maxima(engine, inputs, face_idxs, rt=None):
    """K1's plain version on one grid pass tiled by ``_tile_geometry`` (or
    by tiles of ``rt``): each codimension's face maxima of d^2 in the
    original sample order, the in-ball pairs and the tiles' shape."""
    if rt is None:
        ops, sperm, num = engine.prepare(*inputs, True)
    else:
        ops, sperm, num = tiled_operands(engine, *inputs, True, rt)
    out, stats = cf.flood_min(*ops)
    acc2 = out.reshape(out.shape[0], -1)
    inv = np.argsort(sperm)
    faces = [acc2[:, torch.as_tensor(inv[t])].amax(-1)[:num]
             for t in face_idxs]
    return faces, cf.kernel_operations(stats)[1], ops[0].shape[1:3]


@pytest.mark.parametrize("dim,ppe", [(2, 30), (3, 20), (3, 30), (5, 10)])
def test_patches_give_the_face_maxima_of_512_sample_tiles(dim, ppe):
    """A grid pass past 384 samples a simplex, on FPS landmarks' Delaunay
    cells over a clustered cloud with a void: K1's plain version on
    128-sample patches gives every face maximum of d^2 that it gives on
    tiles of 512, bit for bit, with no more in-ball pairs."""
    from flooder_tpu_torch.core import _grid_host
    from flooder_tpu_torch.topology.delaunay import delaunay_cells

    X = _clustered_cloud_with_a_void(dim)
    L = ft.generate_landmarks(X, 24 if dim < 5 else 12, start_idx=0,
                              device="cpu")
    engine = cf.CudaFloodEngine(X)
    cells = torch.as_tensor(delaunay_cells(L.double().numpy())).long()
    verts = L[cells]
    centers, radii = simplex_bounding_balls(verts)
    order = torch.as_tensor(engine.order(centers))[:2 * cf.BS]
    weights, _, face_idxs = _grid_host(ppe, dim)
    assert len(weights) > cf.RT - cf.FEW_RT
    inputs = (verts[order], weights, centers[order], radii[order])

    patches, pairs, shape = _face_maxima(engine, inputs, face_idxs)
    assert tuple(shape) == (-(-len(weights) // cf.FEW_RT), cf.FEW_RT)
    tiles, pairs_512, shape_512 = _face_maxima(engine, inputs, face_idxs,
                                               rt=cf.RT)
    assert shape_512[1] == cf.RT
    for got, want in zip(patches, tiles):
        assert torch.isfinite(want).any()
        assert torch.equal(got, want)
    assert 0 < pairs <= pairs_512
