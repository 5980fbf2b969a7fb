"""Kernels of flooder_tpu_torch on the card against their plain versions.

These tests need an NVIDIA GPU with ``nvcc``; elsewhere they skip from
inside the ``cuda_device`` fixture. They import nothing of JAX, so on a
machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import flooder_tpu_torch as ft
from flooder_tpu_torch.ops import cuda_flood, cuda_flood_stats, cuda_fps
from flooder_tpu_torch.ops.fps import farthest_point_sampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_same_greedy_selection(pts, a, b, start):
    """Both index sequences realize the same exact greedy FPS run: the same
    start and the same farthest distance at every step (a tie may pick a
    different, equally far point)."""
    p = np.asarray(pts, dtype=np.float64)
    assert a[0] == b[0] == start
    assert len(set(a.tolist())) == len(a)
    m_a = np.full(len(p), np.inf)
    m_b = np.full(len(p), np.inf)
    for ia, ib in zip(a, b):
        da, db = m_a[ia], m_b[ib]
        assert da == db or abs(da - db) < 1e-6 * max(da, db)
        m_a = np.minimum(m_a, ((p - p[ia]) ** 2).sum(-1))
        m_b = np.minimum(m_b, ((p - p[ib]) ** 2).sum(-1))


@pytest.mark.parametrize("n,n_lms,dim", [(9000, 128, 3), (20000, 64, 2)])
def test_fps_kernel_matches_plain(cuda_device, n, n_lms, dim):
    rng = np.random.default_rng(n)
    x = rng.random((n, dim)).astype(np.float32)
    pts = torch.from_numpy(x).to(cuda_device)
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, n_lms, 7)
    assert cuda_fps.LAUNCHES == before + 1  # the whole loop, one launch
    want = farthest_point_sampling(pts, n_lms, 7)
    assert_same_greedy_selection(x, got.cpu().numpy(), want.cpu().numpy(), 7)


def test_fps_kernel_with_several_chunks_per_cta(cuda_device):
    """More chunks than co-resident CTAs: every CTA owns two chunks or
    more, past its first (shared-memory) one."""
    ctas = cuda_fps.coresident_ctas(3)
    n = cuda_fps.FPS_CHUNK * (ctas + 5)
    x = np.random.default_rng(17).random((n, 3)).astype(np.float32)
    pts = torch.from_numpy(x).to(cuda_device)
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, 48, 11)
    assert cuda_fps.LAUNCHES == before + 1
    want = farthest_point_sampling(pts, 48, 11)
    assert_same_greedy_selection(x, got.cpu().numpy(), want.cpu().numpy(), 11)


@pytest.mark.parametrize(
    "n,n_lms,dim,chunks_per_cta",
    [(6000, 64, 3, 0), (20000, 64, 2, 0), (9000, 32, 8, 0), (0, 40, 3, 2)],
    ids=["one-chunk", "dim2-cached", "dim8", "several-chunks-a-cta"],
)
def test_fps_kernel_float64_matches_plain(cuda_device, n, n_lms, dim,
                                          chunks_per_cta):
    """K2's double instance: the same greedy selection as the plain version
    in float64, on one chunk, with the first chunk's points cached (dim 2),
    at 8 coordinates, and with more chunks than co-resident CTAs."""
    if chunks_per_cta:
        ctas = cuda_fps.coresident_ctas(dim, dtype=torch.float64)
        n = cuda_fps.FPS_CHUNK * (ctas + 5)
    x = np.random.default_rng(n + dim).random((n, dim))
    pts = torch.from_numpy(x).to(cuda_device)
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, n_lms, 5)
    assert cuda_fps.LAUNCHES == before + 1
    want = farthest_point_sampling(pts, n_lms, 5)
    assert_same_greedy_selection(x, got.cpu().numpy(), want.cpu().numpy(), 5)


def test_fps_kernel_rejects_other_dtypes(cuda_device):
    pts = torch.rand(1000, 3, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_fps.cuda_farthest_point_sampling(pts.half(), 10, 0)
    with pytest.raises(NotImplementedError):
        cuda_fps.cuda_farthest_point_sampling(
            torch.rand(1000, 9, device=cuda_device), 10, 0)


def test_fps_single_sample_launches_nothing(cuda_device):
    pts = torch.rand(1000, 3, device=cuda_device)
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, 1, 5)
    assert got.tolist() == [5]
    assert cuda_fps.LAUNCHES == before


def _dim3_operands(device, n=20000, n_lms=100, tight=True, num_rand=None,
                   shift=0.0, radius_scale=1.0):
    X = ft.generate_swiss_cheese_points(n, seed=3, device=device)[0]
    L = ft.generate_landmarks(X, n_lms, start_idx=0, device=device) + shift
    eng = cuda_flood.CudaFloodEngine(X)
    stree = ft.topology.DelaunayComplex(
        L.cpu().numpy().astype(np.float64)
    ).create_simplex_tree()
    tets = torch.as_tensor(stree._verts[3], device=device).long()
    verts = L[tets]
    centers, radii = ft.ops.flood.simplex_bounding_balls(verts)
    radii = radii * radius_scale
    order = torch.as_tensor(eng.order(centers), device=device)
    if num_rand is None:
        from flooder_tpu_torch.core import _grid_host

        weights = _grid_host(10, 3)[0]
    else:
        np.random.seed(0)
        weights = ft.generate_uniform_weights(num_rand, 3, device="cpu")
    return eng.prepare(verts[order], weights, centers[order], radii[order],
                       tight)[0]


@pytest.mark.parametrize("tight,num_rand", [(True, None), (False, 300)])
def test_flood_kernel_matches_plain(cuda_device, tight, num_rand):
    ops = _dim3_operands(cuda_device, tight=tight, num_rand=num_rand)
    before = cuda_flood.LAUNCHES
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert cuda_flood.LAUNCHES == before + 1
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked_k = out_k >= cuda_flood._MASKED_D2
    masked_p = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(masked_k, masked_p)
    assert (out_k[~masked_k] - out_p[~masked_p]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    assert stats_k[:, 0].sum().item() > 0


def test_flood_kernel_matches_plain_where_balls_cut_subchunks(cuda_device):
    """Landmarks off the cloud, balls of half the radius (as in
    test_torch_flood.py::test_plain_kernel_matches_pallas_interpret): many
    admitted sub-chunks are partly out of the ball, so the compacted inner
    loop runs over partly masked tiles."""
    ops = _dim3_operands(cuda_device, tight=False, num_rand=300, shift=0.05,
                         radius_scale=0.5)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked_k = out_k >= cuda_flood._MASKED_D2
    assert torch.equal(masked_k, out_p >= cuda_flood._MASKED_D2)
    assert not masked_k.all()
    assert (out_k[~masked_k] - out_p[~masked_k]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    units, inball = cuda_flood.kernel_operations(stats_k)
    rt = ops[0].shape[2]
    assert 0 < inball < units * cuda_flood.SUB * rt  # partly masked units
    out_3, stats_3 = cuda_flood_stats.flood_min_stats(*ops)
    assert torch.equal(out_3, out_k)
    assert stats_3[:, cuda_flood_stats.COL_TILES].sum().item() == units


# K3's cases beyond the Delaunay scenes, as k3_case_operands arguments; CPU
# tests (test_torch_kernel_stats.py) check through the plain version that each
# reaches the fold of a unit with no in-ball witness and a tile that test 3
# rejects inside an admitted unit. At 512 samples a tile the dim cases have
# 3 or 4 tiles a simplex, so both tile groups of a CTA compute tiles and read
# each other's tile maxima.
K3_CASES = {
    "dim1": dict(dim=1, r_count=1100),
    "dim2": dict(dim=2, r_count=2000),
    "dim4": dict(dim=4, r_count=1100),
    "nr1": dict(dim=3, r_count=200),
    "nr3": dict(dim=3, r_count=1300),
    "empty-block": dict(dim=3, r_count=300, empty_block=True),
}


def k3_case_operands(device, dim, r_count, empty_block=False, seed=7,
                     radius_max=1.3):
    """Seeded K3 operands from ``CudaFloodEngine.prepare``: 16,384 witnesses
    in [0, 5]^dim, 4 blocks of random simplices with the nearest-vertex
    bound on and radii in [0.1, radius_max). Every fourth ball has radius
    1e-5, so it meets the sub-chunk boxes around its centre but holds no
    witness; ``empty_block`` gives the last block radius 0, so its
    work-list is empty."""
    rng = np.random.default_rng(seed + dim)
    X = (rng.random((16384, dim)) * 5).astype(np.float32)
    eng = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    S, k = cuda_flood.BS * 4, dim + 1
    centers = (rng.random((S, dim)) * 5).astype(np.float32)
    radii = (rng.random(S) * (radius_max - 0.1) + 0.1).astype(np.float32)
    radii[::4] = 1e-5
    if empty_block:
        radii[-cuda_flood.BS:] = 0.0
    verts = centers[:, None, :] + (
        rng.random((S, k, dim)).astype(np.float32) - 0.5
    ) * 0.3
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return eng.prepare(t(verts), w, t(centers), t(radii), True)[0]


def k3_paths_reached(out, stats):
    """(a unit with no in-ball witness was computed, test 3 rejected a tile
    inside an admitted unit), read off K3's plain output: only the fold of
    such a unit gives a finite d^2 >= 1e30, and an admitted unit tests all
    nr tiles."""
    nr = out.shape[1]
    fold = bool(((out >= cuda_flood._MASKED_D2) & torch.isfinite(out)).any())
    units = stats[:, cuda_flood_stats.COL_SUBCHUNKS]
    rejected = bool((units * nr > stats[:, cuda_flood_stats.COL_TILES]).any())
    return fold, rejected


def assert_k3_matches_plain(ops):
    """K3, launched once through its wrapper, against its plain version
    (d^2 within 1e-6, inf alike, every counter equal) and against K1 (equal
    output, computed tiles == K1's units)."""
    before = cuda_flood_stats.LAUNCHES
    out_k, stats_k = cuda_flood_stats.flood_min_stats(*ops)
    torch.cuda.synchronize()
    assert cuda_flood_stats.LAUNCHES == before + 1
    out_p, stats_p = cuda_flood_stats.flood_stats_reference(*ops)
    masked_p = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked_p)
    diff = (out_k[~masked_p] - out_p[~masked_p]).abs()
    assert diff.numel() == 0 or diff.max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    assert stats_k[:, cuda_flood_stats.COL_TILES].sum().item() > 0
    out_1, stats_1 = cuda_flood.flood_min(*ops)
    assert torch.equal(out_k, out_1)
    assert stats_k[:, cuda_flood_stats.COL_TILES].sum().item() == (
        cuda_flood.kernel_operations(stats_1)[0]
    )
    return out_p, stats_p


@pytest.mark.parametrize("case", list(K3_CASES))
def test_flood_stats_kernel_cases_match_plain(cuda_device, case):
    ops = k3_case_operands(cuda_device, **K3_CASES[case])
    out_p, stats_p = assert_k3_matches_plain(ops)
    assert k3_paths_reached(out_p, stats_p) == (True, True)
    if case == "empty-block":
        assert torch.isinf(out_p[-cuda_flood.BS:]).all()
        assert not stats_p[-cuda_flood.BS:].any()


@pytest.mark.parametrize("dim", [5, 6, 7, 8])
def test_flood_kernels_match_plain_at_5_to_8_coordinates(cuda_device, dim):
    """K1 and K3 at 5-8 coordinates (a staged witness of two float4; at 8
    the raw buffer in dynamic shared memory) against their plain versions.
    Balls up to radius 3 in [0, 5]^dim hold a few hundred witnesses and cut
    sub-chunks; 1100 samples give 3 tiles a simplex."""
    ops = k3_case_operands(cuda_device, dim=dim, r_count=1100,
                           radius_max=3.0)
    assert ops[0].shape[1] == 3
    before = cuda_flood.LAUNCHES
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert cuda_flood.LAUNCHES == before + 1
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert not masked.all()
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    units, inball = cuda_flood.kernel_operations(stats_k)
    assert 0 < inball < units * cuda_flood.SUB * ops[0].shape[2]
    assert_k3_matches_plain(ops)


# the last case is the K1 case above whose balls cut sub-chunks
@pytest.mark.parametrize(
    "tight,num_rand,shift,radius_scale",
    [(True, None, 0.0, 1.0), (False, 300, 0.0, 1.0), (False, 300, 0.05, 0.5)],
)
def test_flood_stats_kernel_matches_plain(cuda_device, tight, num_rand,
                                          shift, radius_scale):
    ops = _dim3_operands(cuda_device, tight=tight, num_rand=num_rand,
                         shift=shift, radius_scale=radius_scale)
    assert_k3_matches_plain(ops)


def test_kernel_stats_tool_on_card(cuda_device):
    from flooder_tpu_torch.tools import kernel_stats
    from flooder_tpu_torch.tools.scene import build_scene

    scene = build_scene(20000, 100)
    before = cuda_flood_stats.LAUNCHES
    seg_times, counters, parity = kernel_stats.run_with_stats(scene)
    assert parity
    assert cuda_flood_stats.LAUNCHES == before + 2  # warm-up + timed run
    assert counters["visited_pairs"] == counters["worklist_pairs"] > 0
    assert counters["computed_tiles"] == counters["production_units"] > 0
    assert seg_times[0] > 0


def test_flood_kernel_rejects_bad_operands(cuda_device):
    ops = list(_dim3_operands(cuda_device, n=5000, n_lms=30))
    with pytest.raises(TypeError):
        cuda_flood.flood_min(*([ops[0].double()] + ops[1:]))
    with pytest.raises(TypeError):
        cuda_flood.flood_min(*(ops[:-1] + [ops[-1].long()]))


def test_pipeline_cuda_matches_cpu(cuda_device):
    X = ft.generate_swiss_cheese_points(3000, seed=5, device="cpu")[0]
    out = {}
    for dev in ("cpu", "cuda"):
        st = ft.flood_complex(X, 40, points_per_edge=12,
                              return_simplex_tree=True, device=dev)
        out[dev] = {tuple(s): f for s, f in st.get_simplices()}
    assert out["cpu"].keys() == out["cuda"].keys()
    for s, v in out["cpu"].items():
        assert abs(out["cuda"][s] - v) <= 1e-6, s


def test_main_path_goes_through_both_kernels(cuda_device):
    X = ft.generate_swiss_cheese_points(30000, seed=6, device=cuda_device)[0]
    f0, k0 = cuda_fps.LAUNCHES, cuda_flood.LAUNCHES
    st = ft.flood_complex(X, 200, return_simplex_tree=True)
    st.compute_persistence()
    assert cuda_fps.LAUNCHES == f0 + 1
    assert cuda_flood.LAUNCHES == k0 + 1
    vals = np.concatenate(st._filt)
    assert np.isfinite(vals).all()


def _complex(dev, X, L, **kw):
    st = ft.flood_complex(X, L, return_simplex_tree=True, device=dev, **kw)
    return {tuple(s): f for s, f in st.get_simplices()}


def _assert_same(a, b, tol):
    assert a.keys() == b.keys()
    for s, v in a.items():
        if np.isinf(v):
            assert np.isinf(b[s]), s
        else:
            assert abs(b[s] - v) <= tol, (s, b[s], v)


@pytest.mark.parametrize("mode", ["float64", "dense-float32"])
def test_dense_pipeline_cuda_matches_cpu(cuda_device, mode):
    """The dense engine on the card (torch ops) against the CPU run (the
    native reduction), and float64 against the float32 kernel route."""
    X = ft.generate_noisy_torus_points_3d(3000, seed=11, device="cpu")
    if mode == "float64":
        X = X.double()
    L = ft.generate_landmarks(X, 60, start_idx=0, device="cpu")
    kw = dict(points_per_edge=12)
    if mode == "float64":
        with pytest.warns(RuntimeWarning):
            got = _complex("cuda", X, L, **kw)
        with pytest.warns(RuntimeWarning):
            want = _complex("cpu", X, L, **kw)
        _assert_same(want, got, 1e-9)
        f32 = _complex("cuda", X.float(), L.float(), **kw)
        _assert_same(f32, got, 3e-6)
    else:
        got = _complex("cuda", X, L, use_pallas=False, **kw)
        _assert_same(_complex("cpu", X, L, use_pallas=False, **kw), got,
                     1e-6)
        _assert_same(_complex("cuda", X, L, **kw), got, 1e-5)


def test_float64_fps_runs_k2_on_card(cuda_device):
    X = ft.generate_swiss_cheese_points(20000, seed=2, device="cpu")[0]
    X = X.double().to(cuda_device)
    before = cuda_fps.LAUNCHES
    with pytest.warns(RuntimeWarning):
        st = ft.flood_complex(X, 80, points_per_edge=8,
                              return_simplex_tree=True)
    assert cuda_fps.LAUNCHES == before + 1
    assert np.isfinite(np.concatenate(st._filt)).all()


@pytest.mark.parametrize("case", ["5d-grid", "6d-random"])
def test_high_dim_pipelines_cuda_match_cpu(cuda_device, case):
    """The reference's 5-D grid and 6-D random edge cases
    (tests/test_edge_cases.py) through K2 and K1 on the card, against the
    CPU run."""
    if case == "5d-grid":
        pts = np.random.default_rng(7).random((1200, 5)).astype(np.float32)
        kw = dict(points_per_edge=4)
        n_lms = 24
    else:
        pts = np.random.default_rng(8).random((800, 6)).astype(np.float32)
        kw = dict(num_rand=32, points_per_edge=None)
        n_lms = 16
    out = {}
    for dev in ("cpu", "cuda"):
        np.random.seed(3)
        k0 = cuda_flood.LAUNCHES
        out[dev] = _complex(dev, pts, n_lms, start_idx=0, **kw)
        if dev == "cuda":
            assert cuda_flood.LAUNCHES > k0
    _assert_same(out["cpu"], out["cuda"], 1e-5)


def test_step_timer_on_cuda(cuda_device):
    """StepTimer on the card: a per-step device peak that covers a 64 MB
    allocation (the peak is reset on entry), and a wall time that covers a
    kernel's run (the step is fenced on exit)."""
    from flooder_tpu_torch.utils import StepTimer

    keep = torch.empty(256 * 2**20, dtype=torch.uint8, device=cuda_device)
    del keep  # an earlier, larger peak that the step must not report
    with StepTimer("alloc", cuda_device) as t:
        x = torch.ones(64 * 2**20, dtype=torch.uint8, device=cuda_device)
        del x
    assert t.stats.device_kind == "cuda"
    assert 64 <= t.stats.device_peak_mib < 256

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with StepTimer("spin", cuda_device) as t:
        start.record()
        torch.cuda._sleep(200_000_000)  # about 0.1 s of device spinning
        end.record()
    kernel_s = start.elapsed_time(end) / 1e3
    assert kernel_s > 0.02
    assert t.stats.wall_s >= kernel_s
