"""The port's dense flood engine (use_pallas=False and float64) against
flooder_tpu on the same seeded inputs: the engine against the reference's
DenseFloodEngine, the native CPU reduction against the torch ops, the
windows, and through flood_complex test_float64, test_engine_vs_brute_force
and test_batching_invariance (tests/test_flooder.py); clouds of 5, 6 and 17
coordinates are in test_torch_dims.py. Parity bar: the same simplices,
values within 1e-5 and inf where the reference has inf (3e-6 for float64
against float32, 2e-5 against the brute force, 2e-6 across batchings)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.core import _grid_host
from flooder_tpu.ops import flood as flood_j
from flooder_tpu.topology import DelaunayComplex
from flooder_tpu_torch import core as core_t
from flooder_tpu_torch.native import build
from flooder_tpu_torch.ops import flood as flood_t


def _assert_same_complex(ref: dict, got: dict, tol: float):
    assert set(ref) == set(got)
    for simplex, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[simplex]), simplex
        else:
            assert abs(got[simplex] - val) < tol, (simplex, got[simplex], val)


@pytest.fixture
def torch_ops_on_cpu(monkeypatch):
    """Route CPU clouds of any width to the torch ops (the path of CUDA
    tensors and of CPU clouds past 16 coordinates)."""
    monkeypatch.setattr(flood_t, "NATIVE_MAX_DIM", 0)
    core_t._ENGINE_CACHE.clear()
    yield
    core_t._ENGINE_CACHE.clear()


def _tets(n=2000, n_lms=80, seed=9, shift=0.0, radius_scale=1.0):
    """Sorted dimension-3 simplices of a torus cloud, as flood_complex
    hands them to the engine, from the reference's own functions."""
    X = np.asarray(fj.generate_noisy_torus_points_3d(n, seed=seed))
    L = np.asarray(fj.generate_landmarks(X, n_lms, start_idx=0)) + np.float32(
        shift)
    stree = DelaunayComplex(L.astype(np.float64)).create_simplex_tree()
    sv = L[stree._verts[3]]
    c, r = (np.asarray(a) for a in flood_j.simplex_bounding_balls(sv))
    r = (r * np.float32(radius_scale)).astype(np.float32)
    o = np.argsort(c[:, int(np.argmax(np.ptp(X, axis=0)))], kind="stable")
    return X, sv[o], c[o], r[o]


@pytest.mark.parametrize("path", ["native", "torch-ops"])
@pytest.mark.parametrize("case", ["tight", "off-cloud"])
def test_dense_engine_matches_flooder_tpu(path, case):
    """DenseFloodEngine.min_distances against the reference's on the same
    operands; the off-cloud case shifts the landmarks and halves the balls,
    so some hold no witness (inf)."""
    shift, scale = (0.0, 1.0) if case == "tight" else (0.05, 0.5)
    X, sv, c, r = _tets(shift=shift, radius_scale=scale)
    w = _grid_host(8, 3)[0]
    eng_j = flood_j.DenseFloodEngine(jnp.asarray(X), 512)
    want = np.asarray(eng_j.min_distances(
        jnp.asarray(sv), jnp.asarray(w, dtype=jnp.float32), jnp.asarray(c),
        jnp.asarray(r), 64,
    ))
    eng_t = flood_t.DenseFloodEngine(torch.from_numpy(X.copy()), 512)
    assert eng_t._native is not None
    if path == "torch-ops":
        eng_t._native = None
    got = eng_t.min_distances(torch.from_numpy(sv), w, torch.from_numpy(c),
                              torch.from_numpy(r), 64).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    assert (~inf).any()
    assert inf.any() == (case == "off-cloud")
    np.testing.assert_allclose(got[~inf], want[~inf], atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_native_matches_torch_ops(dtype):
    """The native reduction against the torch ops on the same engine
    (test_native_cpu_matches_xla_dense), within 1e-5."""
    X, sv, c, r = _tets()
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    eng = flood_t.DenseFloodEngine(t(X), 512)
    assert eng._native is not None
    w = _grid_host(8, 3)[0]
    d_native = eng.min_distances(t(sv), w, t(c), t(r), 64)
    eng._native = None
    d_ops = eng.min_distances(t(sv), w, t(c), t(r), 64)
    assert d_native.dtype == d_ops.dtype == dtype
    finite = torch.isfinite(d_ops)
    assert torch.equal(torch.isfinite(d_native), finite)
    assert (d_native[finite] - d_ops[finite]).abs().max().item() < 1e-5


def test_batch_windows_and_witness_layout_match_flooder_tpu():
    rng = np.random.default_rng(2)
    X = (rng.random((3000, 3)) * [1.0, 4.0, 2.0]).astype(np.float32)
    eng_j = flood_j.DenseFloodEngine(jnp.asarray(X), 256)
    eng_t = flood_t.DenseFloodEngine(torch.from_numpy(X), 256)
    assert eng_t.mrd == eng_j.mrd == 1
    np.testing.assert_array_equal(eng_t.witness_axis.numpy(),
                                  np.asarray(eng_j.witness_axis))
    assert eng_t.witnesses.shape == (3072, 3)
    assert (eng_t.witnesses[3000:] == flood_t.WITNESS_PAD).all()
    ca = (rng.random((7, 5)) * 4).astype(np.float32)
    rad = (rng.random((7, 5)) * 0.3).astype(np.float32)
    want = flood_j.batch_windows(jnp.asarray(ca), jnp.asarray(rad),
                                 eng_j.witness_axis, 256)
    got = flood_t.batch_windows(torch.from_numpy(ca), torch.from_numpy(rad),
                                eng_t.witness_axis, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] % 256 == 0).all()


@pytest.mark.parametrize("pointcloud", ["torus", "cheese"])
def test_float64(pointcloud):
    """float64 (dense engine, with its RuntimeWarning) against float32 (the
    port's dense engine and the reference's run) within 3e-6, and against
    the reference's float64 run (test_float64 at 2,000 points instead of
    3,000 and points_per_edge 12 instead of 30, to keep the CPU run short).
    The kernel route's float32 equals the reference's in
    test_torch_core.py, and float64 against it on the card is a phase of
    chip_smoke.py."""
    num_pts, num_lms = 2000, 150
    if pointcloud == "torus":
        pts = fj.generate_noisy_torus_points_3d(num_pts, seed=11)
    else:
        pts = fj.generate_swiss_cheese_points(num_pts, seed=11)[0]
    lms = fj.generate_landmarks(pts, num_lms, start_idx=0)
    p32, l32 = np.asarray(pts, np.float32), np.asarray(lms, np.float32)
    p64, l64 = np.asarray(pts, np.float64), np.asarray(lms, np.float64)
    kw = dict(points_per_edge=12)
    ref32 = fj.flood_complex(p32, l32, **kw)
    f32 = ft.flood_complex(p32, l32, use_pallas=False, device="cpu", **kw)
    with pytest.warns(RuntimeWarning, match="float64"):
        f64 = ft.flood_complex(p64, l64, device="cpu", **kw)
    _assert_same_complex(ref32, f32, 1e-5)
    _assert_same_complex(f32, f64, 3e-6)
    _assert_same_complex(ref32, f64, 3e-6)
    with pytest.warns(RuntimeWarning):
        ref64 = fj.flood_complex(p64, l64, **kw)
    _assert_same_complex(ref64, f64, 1e-9)


def test_float64_routing_and_raises():
    X = np.random.default_rng(0).random((300, 3))
    with pytest.raises(TypeError, match="float32"):
        ft.flood_complex(X, 10, points_per_edge=5, use_pallas=True,
                         device="cpu")
    core_t._ENGINE_CACHE.clear()
    with pytest.warns(RuntimeWarning):
        ft.flood_complex(X, 10, points_per_edge=5, wchunk=256, device="cpu")
    (_, key, eng), = core_t._ENGINE_CACHE
    assert key == ("dense", 256) and isinstance(eng, flood_t.DenseFloodEngine)
    core_t._ENGINE_CACHE.clear()
    ft.flood_complex(X.astype(np.float32), 10, points_per_edge=5,
                     use_triton=False, device="cpu")
    (_, key, _), = core_t._ENGINE_CACHE
    assert key == ("dense", core_t._auto_wchunk(300))
    core_t._ENGINE_CACHE.clear()


class _BruteEngine:
    """Brute-force float64 numpy engine for the reference's
    ``_engine_override``: every witness, the ball mask, no windows."""

    def __init__(self, points, wchunk):
        self.wit = np.asarray(points, dtype=np.float64)

    def order(self, centers):
        return jnp.argsort(centers[:, 0])

    def min_distances(self, verts, weights, centers, radii, batch_size,
                      tight=False):
        v = np.asarray(verts, dtype=np.float64)
        w = np.asarray(weights, dtype=np.float64)
        c = np.asarray(centers, dtype=np.float64)
        r = np.asarray(radii, dtype=np.float64)
        out = np.full((v.shape[0], w.shape[0]), np.inf)
        for i in range(v.shape[0]):
            samples = w @ v[i]
            m = ((self.wit - c[i]) ** 2).sum(1) <= r[i] ** 2
            if m.any():
                d = ((samples[:, None, :] - self.wit[m][None]) ** 2).sum(-1)
                out[i] = np.sqrt(d.min(1))
        return jnp.asarray(out, dtype=jnp.float32)


@pytest.mark.parametrize("num_landmarks", [20, 150])
@pytest.mark.parametrize("use_rand", [True, False])
def test_engine_vs_brute_force(num_landmarks, use_rand):
    """use_pallas=False against an unwindowed float64 brute force, within
    2e-5 (test_engine_vs_brute_force)."""
    kw = ({"num_rand": 256, "points_per_edge": None} if use_rand
          else {"num_rand": None, "points_per_edge": 10})
    X = np.asarray(fj.generate_noisy_torus_points_3d(1500, seed=42))
    L = np.asarray(fj.generate_landmarks(X, num_landmarks, start_idx=0))
    np.random.seed(42)
    got = ft.flood_complex(X, L, batch_size=32, use_pallas=False,
                           device="cpu", **kw)
    np.random.seed(42)
    ref = fj.flood_complex(X, L, batch_size=32, _engine_override=_BruteEngine,
                           **kw)
    _assert_same_complex(ref, got, 2e-5)


@pytest.mark.parametrize("batch_size,wchunk",
                         [(8, 128), (64, 512), (None, 1024)])
def test_batching_invariance(torch_ops_on_cpu, batch_size, wchunk):
    """The torch ops' result does not depend on batching or chunking
    (test_batching_invariance, within 2e-6; points_per_edge 10 to keep the
    CPU run short). The base also equals the native reduction."""
    X = np.asarray(fj.generate_noisy_torus_points_3d(1200, seed=7))
    L = np.asarray(fj.generate_landmarks(X, 80, start_idx=0))
    kw = dict(points_per_edge=10, use_pallas=False, device="cpu")
    base = ft.flood_complex(X, L, batch_size=16, wchunk=256, **kw)
    other = ft.flood_complex(X, L, batch_size=batch_size, wchunk=wchunk, **kw)
    for simplex, val in base.items():
        assert other[simplex] == pytest.approx(val, abs=2e-6)
    eng = core_t._ENGINE_CACHE[-1][2]
    assert eng._native is None and eng.wchunk == wchunk


def test_native_source_is_own_copy():
    ref = build.PKG_DIR.parent / "flooder_tpu" / "native" / "src"
    assert build.FLOOD_CPU_SRC.read_bytes() == (
        ref / "flood_cpu.cpp").read_bytes()
    assert build.PKG_DIR in build.FLOOD_CPU_SRC.parents
    lib = build.load_flood_cpu()
    assert lib._name == str(build.FLOOD_CPU_LIB)
    assert build.FLOOD_CPU_LIB.parent == build.BUILD_DIR


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the dense engine raise on a CPU cloud;
    nothing falls back to the torch ops."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(build, "FLOOD_CPU_LIB", tmp_path / "_flood_cpu.so")
    monkeypatch.setattr(build, "_loaded", {})
    X = torch.rand(500, 3)
    with pytest.raises(RuntimeError, match="building flood_cpu failed"):
        flood_t.DenseFloodEngine(X, 128)
    assert not (tmp_path / "_flood_cpu.so").exists()
    core_t._ENGINE_CACHE.clear()
    with pytest.raises(RuntimeError, match="building flood_cpu failed"):
        ft.flood_complex(X, 10, points_per_edge=4, use_pallas=False,
                         device="cpu")
    core_t._ENGINE_CACHE.clear()


def test_native_nonzero_return_raises(monkeypatch):
    X, sv, c, r = _tets(n=1200, n_lms=30)
    eng = flood_t.DenseFloodEngine(torch.from_numpy(X.copy()), 256)

    class Failing:
        def flood_min_dist_f32(self, *args):
            return -1

    eng._native = Failing()
    with pytest.raises(RuntimeError, match="returned -1"):
        eng.min_distances(torch.from_numpy(sv), _grid_host(4, 3)[0],
                          torch.from_numpy(c), torch.from_numpy(r), 64)
