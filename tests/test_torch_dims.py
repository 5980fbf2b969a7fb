"""Clouds of more than 4 coordinates through the port against flooder_tpu:
the reference's 5-D grid-mode and 6-D random-mode edge cases
(tests/test_edge_cases.py:190-226) on the kernel route (template instances
of the CUDA kernels for 1-8 coordinates), the 5-D one also on the dense
engine, and a 17-D cloud, past the native reduction's 16 coordinates, on
the dense engine's torch ops. Parity bar: the same simplices, values within
1e-5.

Past 8 coordinates (the kernels' runtime-width instances, whose plain
versions run here): 9-D and 12-D clouds in grid and random mode, a 9-D 2x2
mesh against one device, and K1's and K3's plain versions against the
Pallas kernels in interpret mode on one block at 9 coordinates and, for
K1, at 40, where a masked d2 overflows to +inf; and the grounds of the bar
that the card holds those instances to (two fp32 summation orders of dim
terms lie within 2 * dim * 2**-24 * d2 of each other) at 9-64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.ops import pallas_flood as pf
from flooder_tpu_torch import core as core_t
from flooder_tpu_torch.ops import cuda_flood as cf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """K1's plain version is a loop of small torch ops: on one thread it
    does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# past 8 coordinates: the kernels' runtime-width instances, through their
# plain versions here
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("dim,n_lms", [(9, 12), (12, 14)])
def test_flood_complex_past_8_coordinates_matches_flooder_tpu(dim, n_lms,
                                                              mode):
    """A 9-D and a 12-D cloud through the kernel route (K2's and K1's plain
    versions) against flooder_tpu, in grid and random mode."""
    pts = np.random.default_rng(dim).random((800, dim)).astype(np.float32)
    kw = dict(points_per_edge=4) if mode == "grid" else dict(
        num_rand=16, points_per_edge=None)
    np.random.seed(3)
    ref = fj.flood_complex(pts, n_lms, start_idx=0, max_dimension=3, **kw)
    assert any(len(s) == 4 and np.isfinite(v) for s, v in ref.items())
    np.random.seed(3)
    got = ft.flood_complex(pts, n_lms, start_idx=0, max_dimension=3,
                           device="cpu", **kw)
    _assert_same_complex(ref, got)


def test_mesh_past_8_coordinates_equals_one_device():
    """A 2x2 CPU mesh of the kernel engine (K1's plain version on every
    (simplex, witness) shard) on a 9-D cloud of 4 witness chunks equals the
    single-device run exactly."""
    from flooder_tpu_torch.parallel import make_mesh

    X = np.random.default_rng(19).random((4500, 9)).astype(np.float32)
    L = ft.generate_landmarks(X, 12, start_idx=0, device="cpu")
    want = ft.flood_complex(X, L, points_per_edge=4, max_dimension=3,
                            device="cpu")
    mesh = make_mesh(["cpu"] * 4, simplex_parallel=2)
    assert mesh.shape == {"simplex": 2, "witness": 2}
    got = ft.flood_complex(X, L, points_per_edge=4, max_dimension=3,
                           mesh=mesh)
    assert got.keys() == want.keys()
    assert all(got[s] == v for s, v in want.items())


def _wide_block(dim, seed=23, n=4096, r_count=40, k=4):
    """One block of BS tetrahedra in [0, 1]^dim around witness points, with
    radii at the distance of the 2nd to 300th nearest witness, and every
    fourth radius 1e-5 (the ball meets sub-chunk boxes but holds no
    witness). Returns (X, vertices, weights, centers, radii)."""
    rng = np.random.default_rng(seed + dim)
    X = rng.random((n, dim)).astype(np.float32)
    S = cf.BS
    centers = (X[rng.choice(n, S, replace=False)]
               + (rng.random((S, dim)) - 0.5) * 0.02).astype(np.float32)
    d = np.sort(np.linalg.norm(X[None] - centers[:, None], axis=-1), axis=1)
    radii = d[np.arange(S), rng.integers(2, 300, S)].astype(np.float32)
    radii[::4] = 1e-5
    verts = (centers[:, None, :]
             + (rng.random((S, k, dim)) - 0.5) * 0.1).astype(np.float32)
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    return X, verts, w, centers, radii


@pytest.mark.parametrize("dim", [9, 40])
def test_plain_k1_matches_pallas_k1_past_8_coordinates(dim):
    """flood_pairs_reference (through the engine, on CPU tensors) against
    flooder_tpu's Pallas K1 in interpret mode on one block: values within
    1e-5, inf in the same places. A unit with no in-ball witness gives a
    masked d2 that is finite at 9 coordinates and overflows to +inf at 40
    (from 38 on), and both map to inf."""
    X, verts, w, centers, radii = _wide_block(dim)
    eng_j = pf.PallasFloodEngine(jnp.asarray(X), pf.WCHUNK, interpret=True)
    want = np.asarray(eng_j.min_distances(
        jnp.asarray(verts), jnp.asarray(w), jnp.asarray(centers),
        jnp.asarray(radii), None, tight=False))
    eng_t = cf.CudaFloodEngine(torch.from_numpy(X))
    t = torch.from_numpy
    got = eng_t.min_distances(t(verts), w, t(centers), t(radii),
                              tight=False).numpy()
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    assert inf[::4].all() and (~inf).any()
    np.testing.assert_allclose(got[~inf], want[~inf], atol=1e-5)

    out, _ = cf.flood_pairs_reference(
        *eng_t.prepare(t(verts), w, t(centers), t(radii), False)[0])
    folded = out[::4] >= cf._MASKED_D2
    assert folded.all()
    if dim < 38:
        assert torch.isfinite(out[::4]).all()
    else:
        assert torch.isinf(out[::4]).all()


def test_plain_k3_matches_pallas_k3_past_8_coordinates():
    """flood_stats_reference against the TPU tool's K3 in interpret mode at
    9 coordinates on one block: d2 within 1e-6, no-witness entries in the
    same places, every per-simplex counter equal."""
    from test_torch_kernel_stats import _jax_k3

    from flooder_tpu_torch.ops import cuda_flood_stats as cfs
    from tools import kernel_stats as ks_j

    X, verts, w, centers, radii = _wide_block(9)
    eng = cf.CudaFloodEngine(torch.from_numpy(X))
    rt, nr, r2_total = cf._tile_geometry(len(w), 9)
    ws, _ = cf._prepare_sample_weights(w, r2_total)
    vl = (verts - centers[:, None, :]).astype(np.float32)
    tpu_ops, ps, pc, out_j, st_j = _jax_k3(eng, ws, vl, centers, radii, nr,
                                           rt, tight=False)
    ops = cfs.operands_from_jax(ps, pc, *tpu_ops, device="cpu")
    out_t, st_t = (a.numpy() for a in cfs.flood_stats_reference(*ops))
    masked = out_j >= 1e30
    np.testing.assert_array_equal(out_t >= 1e30, masked)
    assert masked.any() and (~masked).any()
    assert np.abs(out_t[~masked] - out_j[~masked]).max() <= 1e-6
    for col_t, col_j in ((cfs.COL_SUBCHUNKS, ks_j.COL_SUBCHUNKS),
                         (cfs.COL_TILES, ks_j.COL_TILES)):
        np.testing.assert_array_equal(st_t[:, col_t], st_j[:, col_j])
    assert st_t[:, cfs.COL_TILES].sum() > 0


def _all_pairs_operands(dim, seed=11):
    """K1's operands for one block of 8 simplices, 128 samples each and one
    chunk of 2,048 witnesses in [0, 1]^dim, built so that every pair is
    computed: balls far larger than the cube, sub-chunk boxes that hold
    every sample box (the tile test's gap is 0) and no nearest-vertex
    bound. Returns the operands and the ball-local samples and witnesses."""
    rng = np.random.default_rng(seed + dim)
    S, rt = cf.BS, 128
    w = rng.random((cf.WCHUNK, dim)).astype(np.float32)
    c = np.full((S, dim), 0.5, np.float32)
    x = (rng.random((S, 1, rt, dim)).astype(np.float32) - np.float32(0.5))
    t = torch.from_numpy
    subs = cf.WCHUNK // cf.SUB
    ops = (t(x), t(w), torch.full((subs, dim), -1.0),
           torch.full((subs, dim), 2.0), t(c),
           torch.full((S,), 10.0 * dim), t(x.min(2)), t(x.max(2)),
           torch.full((S, 1), float("inf")),
           torch.tensor([0, 1], dtype=torch.int32),
           torch.tensor([0], dtype=torch.int32))
    yl = t(w)[None] - t(c)[:, None]  # (S, W, dim) ball-local, in float32
    return ops, t(x)[:, 0], yl


@pytest.mark.parametrize("dim", [9, 16, 40, 64])
def test_fp32_summation_orders_meet_the_wide_bar(dim):
    """The bar the card holds K1's and K3's runtime-width instances to:
    |d2 - d2_plain| <= 2 * dim * 2**-24 * d2. Over every (sample, witness)
    pair of a block, the plain version's min d2 (products and sums rounded
    one by one) and an emulation of the kernels' order (one FMA a
    coordinate: float64 arithmetic rounded to float32 at each step) each lie
    within dim * 2**-24 * d2 of the same sum of the same float32
    differences taken in float64, so the two fp32 orders lie within twice
    that of each other."""
    ops, x, yl = _all_pairs_operands(dim)
    out, stats = cf.flood_pairs_reference(*ops)
    units, inball = cf.kernel_operations(stats)
    S, rt = x.shape[:2]  # every simplex admits every sub-chunk, whole
    assert units == S * cf.WCHUNK // cf.SUB and inball == S * cf.WCHUNK * rt
    plain = out[:, 0].double()  # (S, rt)

    exact = fma = None
    for d in range(dim):
        diff = yl[:, None, :, d] - x[:, :, None, d]  # float32, (S, rt, W)
        sq = diff.double() ** 2  # exact: a float32 squared fits a double
        exact = sq if exact is None else exact + sq
        fma = (sq if fma is None else fma.double() + sq).float()
    exact, fma = exact.amin(-1), fma.double().amin(-1)

    bound = dim * 2.0**-24 * exact
    assert bool(((plain - exact).abs() <= bound).all())
    assert bool(((fma - exact).abs() <= bound).all())
    assert bool(((plain - fma).abs() <= 2 * dim * 2.0**-24 * plain).all())
    # the orders differ somewhere, so the test sees a real rounding gap
    assert bool((plain != fma).any())
