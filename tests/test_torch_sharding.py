"""The port's multi-device meshes on the CPU against flooder_tpu.parallel.

The reference runs on conftest.py's eight virtual CPU devices; the port's
meshes are built from ``["cpu"] * n``. The reference results are computed
once per module. The parity bar is the reference's tests/test_sharding.py:
the same simplex set, values within 2e-6 and inf exactly where the
reference has inf; against the port's own single-device engine the mesh
must be exact (min is associative and every pair's d^2 is computed alike).
"""

import jax
import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.parallel import make_mesh as fj_make_mesh
from flooder_tpu.parallel.sharding import (
    balance_chunk_assignment as fj_balance,
)
from flooder_tpu_torch.ops import cuda_flood
from flooder_tpu_torch.ops.flood import DenseFloodEngine
from flooder_tpu_torch.parallel import (
    Mesh,
    MeshCudaFloodEngine,
    MeshFloodEngine,
    make_mesh,
)
from flooder_tpu_torch.parallel.sharding import (
    _shard_groups,
    balance_chunk_assignment,
)
from flooder_tpu_torch.core import _grid_host, pass_inputs
from flooder_tpu_torch.topology import DelaunayComplex

PPE = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """K1's plain version is a loop of small torch ops: on one thread it
    does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def top_pass_inputs(engine, landmarks, ppe):
    """The top-dimension pass's (verts, weights, centers, radii) in the
    engine's visit order, as flood_complex hands them to the engine."""
    L = torch.as_tensor(landmarks)
    dim = L.shape[1]
    stree = DelaunayComplex(L.numpy().astype(np.float64)).create_simplex_tree()
    verts, centers, radii, _ = pass_inputs(L, stree._verts[dim], engine)
    return verts, _grid_host(ppe, dim)[0], centers, radii


def _assert_close(ref: dict, got: dict, tol=2e-6):
    assert set(ref) == set(got)
    for simplex, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[simplex]), simplex
        else:
            assert abs(got[simplex] - val) <= tol, (simplex, got[simplex], val)


def _assert_equal(a: dict, b: dict):
    assert set(a) == set(b)
    assert all(a[s] == v for s, v in b.items())


@pytest.fixture(scope="module")
def cloud():
    """The reference's Pallas-mesh test cloud: a 1,500-point torus (seed
    7) and 64 FPS landmarks from index 0, both from the reference."""
    X = np.asarray(fj.generate_noisy_torus_points_3d(1500, seed=7))
    L = np.asarray(fj.generate_landmarks(X, 64, start_idx=0))
    return X, L


@pytest.fixture(scope="module")
def ref(cloud):
    """The reference's mesh results, computed once."""
    X, L = cloud
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    out = {}
    for s in (8, 2):
        out["kernel", s] = fj.flood_complex(
            X, L, points_per_edge=PPE, mesh=fj_make_mesh(simplex_parallel=s),
            use_pallas=True)
    out["kernel", "3dev"] = fj.flood_complex(
        X, L, points_per_edge=PPE,
        mesh=fj_make_mesh(jax.devices()[:3], simplex_parallel=1),
        use_pallas=True)
    for s in (8, 4, 2):
        out["dense", s] = fj.flood_complex(
            X, L, points_per_edge=PPE, mesh=fj_make_mesh(simplex_parallel=s))
    np.random.seed(42)
    out["random"] = fj.flood_complex(
        X, L, num_rand=128, points_per_edge=None,
        mesh=fj_make_mesh(simplex_parallel=2))
    out["float64"] = fj.flood_complex(
        X.astype(np.float64), L.astype(np.float64), points_per_edge=PPE,
        mesh=fj_make_mesh(simplex_parallel=2))
    return out


@pytest.fixture(scope="module")
def single(cloud):
    """The port's single-device kernel engine on the same inputs."""
    X, L = cloud
    return ft.flood_complex(X, L, points_per_edge=PPE, device="cpu")


@pytest.mark.parametrize(
    "n,request_,shape",
    [(8, None, (8, 1)), (8, 4, (4, 2)), (8, 3, (2, 4)), (8, 100, (8, 1)),
     (3, None, (3, 1)), (3, 2, (1, 3)), (1, 0, (1, 1))],
)
def test_make_mesh_shapes(n, request_, shape):
    """The reference's clamping to the largest divisor <= the request
    (tests/test_sharding.py::test_mesh_shapes), mesh for mesh."""
    ref = fj_make_mesh(jax.devices()[:n], simplex_parallel=request_)
    got = make_mesh(["cpu"] * n, simplex_parallel=request_)
    assert dict(ref.shape) == got.shape
    assert (got.shape["simplex"], got.shape["witness"]) == shape
    assert all(d == torch.device("cpu") for row in got.devices for d in row)
    # frozen and hashable: it keys the engine cache
    assert hash(got) == hash(make_mesh(["cpu"] * n, simplex_parallel=request_))


@pytest.mark.parametrize("n_bins", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_balance_chunk_assignment_matches_reference(n_bins, seed):
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 50, size=64)  # ties included
    loads[-8:] = 0
    got = balance_chunk_assignment(loads, n_bins)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, fj_balance(loads, n_bins))


def test_balance_chunk_assignment_all_zero_and_divisibility():
    np.testing.assert_array_equal(balance_chunk_assignment(np.zeros(16), 4),
                                  fj_balance(np.zeros(16), 4))
    with pytest.raises(ValueError, match="divide"):
        balance_chunk_assignment(np.ones(10), 4)


def test_shard_groups_pad_and_drop_placeholders():
    """Counts that n_bins does not divide: zero-load placeholders pad the
    loads and are dropped, every item lands in exactly one shard, in
    ascending order."""
    loads = torch.tensor([5, 0, 9, 1, 7])
    groups = _shard_groups(loads, 3)
    assert sorted(np.concatenate(groups).tolist()) == list(range(5))
    assert all((np.diff(g) > 0).all() for g in groups)
    assert [len(_shard_groups(torch.tensor([3]), 4)[i]) for i in range(4)] \
        == [1, 0, 0, 0]


@pytest.mark.parametrize("s", [8, 2])
def test_kernel_mesh_matches_reference(cloud, ref, single, s):
    X, L = cloud
    mesh = make_mesh(["cpu"] * 8, simplex_parallel=s)
    got = ft.flood_complex(X, L, points_per_edge=PPE, mesh=mesh)
    _assert_close(ref["kernel", s], got)
    _assert_equal(got, single)


def test_kernel_mesh_three_devices(cloud, ref, single):
    """A witness axis of 3, which is not a power of two."""
    X, L = cloud
    mesh = make_mesh(["cpu"] * 3, simplex_parallel=1)
    assert mesh.shape == {"simplex": 1, "witness": 3}
    got = ft.flood_complex(X, L, points_per_edge=PPE, mesh=mesh)
    _assert_close(ref["kernel", "3dev"], got)
    _assert_equal(got, single)


@pytest.fixture(scope="module")
def chunky():
    """A cloud of 4 witness chunks and its single-device kernel results in
    grid and random mode."""
    X = ft.generate_noisy_torus_points_3d(8_000, seed=3, device="cpu")
    L = ft.generate_landmarks(X, 24, start_idx=0, device="cpu")
    grid = ft.flood_complex(X, L, points_per_edge=4, device="cpu")
    np.random.seed(5)
    rand = ft.flood_complex(X, L, num_rand=40, points_per_edge=None,
                            device="cpu")
    return X, L, grid, rand


@pytest.mark.parametrize("shape", [(1, 3), (3, 2)])
def test_kernel_mesh_splits_witness_chunks(chunky, shape):
    """Every witness shard holds chunks: each pass launches K1's plain
    version once per (simplex shard, witness shard), every shard list is
    in local chunk ids, and the result equals the single-device engine
    exactly, grid and random mode."""
    X, L, want_grid, want_rand = chunky
    n_ss, n_ws = shape
    mesh = make_mesh(["cpu"] * (n_ss * n_ws), simplex_parallel=n_ss)
    assert mesh.shape == {"simplex": n_ss, "witness": n_ws}
    _assert_equal(ft.flood_complex(X, L, points_per_edge=4, mesh=mesh),
                  want_grid)
    np.random.seed(5)
    _assert_equal(ft.flood_complex(X, L, num_rand=40, points_per_edge=None,
                                   mesh=mesh), want_rand)

    eng = MeshCudaFloodEngine(X, mesh)
    assert eng.witnesses.shape[0] // cuda_flood.WCHUNK == 4
    verts, weights, centers, radii = top_pass_inputs(eng, L, 4)
    shards, blocks, _, num, s_total = eng.shard_operands(
        verts, weights, centers, radii, True)
    assert sorted(np.concatenate(blocks).tolist()) == list(
        range(s_total // cuda_flood.BS))
    units = []
    for row in shards:
        assert len(row) == n_ws
        for ops in row:
            n_chunks = ops[1].shape[0] // cuda_flood.WCHUNK
            assert ops[-1].numel() == 0 or int(ops[-1].max()) < n_chunks
            units.append(cuda_flood.kernel_operations(
                cuda_flood.flood_min(*ops)[1]))
    assert sum(u for u, _ in units) > 0
    eng.min_distances(verts, weights, centers, radii, tight=True)
    assert [cuda_flood.kernel_operations(s) for row in eng.last_stats
            for s in row] == units


def test_kernel_mesh_more_simplex_shards_than_blocks():
    """Simplex shards without blocks launch nothing and are skipped by
    the combine."""
    X = ft.generate_noisy_torus_points_3d(800, seed=1, device="cpu")
    L = ft.generate_landmarks(X, 6, start_idx=0, device="cpu")
    want = ft.flood_complex(X, L, points_per_edge=4, device="cpu")
    got = ft.flood_complex(X, L, points_per_edge=4,
                           mesh=make_mesh(["cpu"] * 8))
    _assert_equal(got, want)


def test_kernel_mesh_random_mode(cloud, ref):
    X, L = cloud
    mesh = make_mesh(["cpu"] * 8, simplex_parallel=2)
    np.random.seed(42)
    got = ft.flood_complex(X, L, num_rand=128, points_per_edge=None,
                           mesh=mesh)
    np.random.seed(42)
    want = ft.flood_complex(X, L, num_rand=128, points_per_edge=None,
                            device="cpu")
    _assert_close(ref["random"], got)
    _assert_equal(got, want)


@pytest.mark.parametrize("s", [8, 4, 2])
def test_dense_mesh_matches_reference(cloud, ref, s):
    X, L = cloud
    mesh = make_mesh(["cpu"] * 8, simplex_parallel=s)
    got = ft.flood_complex(X, L, points_per_edge=PPE, mesh=mesh,
                           use_pallas=False)
    _assert_close(ref["dense", s], got)


def test_dense_mesh_float64_matches_reference(cloud, ref):
    X, L = cloud
    mesh = make_mesh(["cpu"] * 8, simplex_parallel=2)
    with pytest.warns(RuntimeWarning, match="float64"):
        got = ft.flood_complex(X.astype(np.float64), L.astype(np.float64),
                               points_per_edge=PPE, mesh=mesh)
    _assert_close(ref["float64"], got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (1, 3)])
def test_dense_mesh_equals_single_device_torch_reduction(cloud, dtype,
                                                         shape):
    """The dense mesh runs ``flood_min_distances`` on every shard: exactly
    the single-device dense engine's torch reduction (on the CPU the
    single-device engine runs the native one, an ulp away)."""
    X, L = cloud
    X = torch.tensor(X, dtype=dtype)
    L = torch.tensor(L, dtype=dtype)
    single = DenseFloodEngine(X, 128)
    single._native = None  # the torch reduction, as on the card
    n_ss, n_ws = shape
    mesh = MeshFloodEngine(X, 128, make_mesh(["cpu"] * (n_ss * n_ws),
                                             simplex_parallel=n_ss))
    assert mesh.witnesses.shape[0] % (128 * n_ws) == 0
    verts, weights, centers, radii = top_pass_inputs(single, L, PPE)
    want = single.min_distances(verts, weights, centers, radii, 64)
    got = mesh.min_distances(verts, weights, centers, radii, 64)
    assert got.dtype == dtype and torch.equal(got, want)


ENGINES = ("dense", "kernel", "dense-mesh", "kernel-mesh")


def _engine(kind, X):
    """One of the four flood engines on cloud ``X``; the meshes are 2 x 2
    on the CPU."""
    mesh = make_mesh(["cpu"] * 4, simplex_parallel=2)
    if kind == "dense":
        return DenseFloodEngine(X, 128)
    if kind == "kernel":
        return cuda_flood.CudaFloodEngine(X)
    if kind == "dense-mesh":
        return MeshFloodEngine(X, 128, mesh)
    return MeshCudaFloodEngine(X, mesh)


@pytest.fixture(scope="module")
def cheese():
    """A 2,000-point swiss cheese, 40 FPS landmarks from index 0, and the
    one-card kernel engine's dicts in grid and random mode."""
    X = ft.generate_swiss_cheese_points(2000, k=6, seed=3, device="cpu")[0]
    L = ft.generate_landmarks(X, 40, start_idx=0, device="cpu")
    want = {"grid": ft.flood_complex(X, L, points_per_edge=PPE,
                                     device="cpu")}
    np.random.seed(9)
    want["random"] = ft.flood_complex(X, L, num_rand=60, points_per_edge=None,
                                      device="cpu")
    return X, L, want


@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("kind", ENGINES)
def test_min_distances_facemax_is_min_distances_then_face_maxima(
        cheese, kind, mode):
    """Every engine's ``min_distances_facemax``, the one call of a pass in
    flood_complex, equals its ``min_distances`` followed by the max over
    each face's sample columns (grid mode) or over all samples (random
    mode), bit for bit."""
    X, L, _ = cheese
    engine = _engine(kind, X)
    d = 3 if mode == "grid" else 2
    stree = DelaunayComplex(L.double().numpy()).create_simplex_tree()
    verts, centers, radii, _ = pass_inputs(L, stree._verts[d], engine)
    if mode == "grid":
        weights, _, face_tables = _grid_host(PPE, d)
    else:
        np.random.seed(9)
        weights = ft.generate_uniform_weights(60, d, device="cpu")
        face_tables = None
    dists = engine.min_distances(verts, weights, centers, radii, tight=True)
    got = engine.min_distances_facemax(verts, weights, centers, radii,
                                       tight=True, face_tables=face_tables)
    assert bool(torch.isfinite(dists).any())
    if face_tables is None:
        assert torch.equal(got, dists.amax(-1))
    else:
        assert len(got) == len(face_tables)
        for g, t in zip(got, face_tables):
            assert torch.equal(g, dists[:, torch.as_tensor(t)].amax(-1))


@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("kind", ["dense", "dense-mesh", "kernel-mesh"])
def test_flood_complex_gives_the_kernel_engines_dict(cheese, monkeypatch,
                                                      kind, mode):
    """flood_complex gives the one-card kernel engine's dict bit for bit
    with every other float32 engine; the dense engine runs its torch
    reduction, as on the card (the native one is an ulp away)."""
    from flooder_tpu_torch.ops import flood

    X, L, want = cheese
    monkeypatch.setattr(flood, "NATIVE_MAX_DIM", 0)
    kw = dict(use_pallas=False) if kind.startswith("dense") else {}
    if kind.endswith("mesh"):
        kw["mesh"] = make_mesh(["cpu"] * 4, simplex_parallel=2)
    else:
        kw["device"] = "cpu"
    if mode == "grid":
        got = ft.flood_complex(X.clone(), L, points_per_edge=PPE, **kw)
    else:
        np.random.seed(9)
        got = ft.flood_complex(X.clone(), L, num_rand=60,
                               points_per_edge=None, **kw)
    _assert_equal(got, want[mode])


def test_mesh_error_contracts(cloud):
    X, L = cloud
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* n"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(["cuda:0"] * 2)
    with pytest.raises(ValueError, match="not both"):
        make_mesh(["cpu", "cuda:0"])
    mesh = make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="first device"):
        ft.flood_complex(X, L, mesh=mesh, device="cuda")
    with pytest.raises(TypeError, match="float64"):
        ft.flood_complex(X.astype(np.float64), L.astype(np.float64),
                         mesh=mesh, use_pallas=True)
    with pytest.raises(TypeError, match="Mesh"):
        ft.flood_complex(X, L, mesh=fj_make_mesh(jax.devices()[:2]),
                         device="cpu")
    assert isinstance(mesh, Mesh)
