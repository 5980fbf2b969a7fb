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
from flooder_tpu_torch.core import _grid_host, pass_inputs
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
    with pytest.raises(ValueError):
        cuda_fps.cuda_farthest_point_sampling(
            torch.rand(1000, 0, device=cuda_device), 10, 0)


@pytest.mark.parametrize(
    "dim,dtype", [(16, torch.float32), (64, torch.float32),
                  (16, torch.float64)])
def test_fps_kernel_past_8_coordinates_matches_plain(cuda_device, dim,
                                                     dtype):
    """K2's runtime-width instance: the same greedy selection as the plain
    version, in one launch, on 3 chunks."""
    x = np.random.default_rng(dim).random((20000, dim))
    pts = torch.from_numpy(x).to(cuda_device, dtype)
    before = cuda_fps.LAUNCHES
    got = cuda_fps.cuda_farthest_point_sampling(pts, 64, 9)
    assert cuda_fps.LAUNCHES == before + 1
    want = farthest_point_sampling(pts, 64, 9)
    assert_same_greedy_selection(pts.cpu().numpy(), got.cpu().numpy(),
                                 want.cpu().numpy(), 9)


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
    verts, centers, radii, _ = pass_inputs(L, stree._verts[3], eng)
    if num_rand is None:
        weights = _grid_host(10, 3)[0]
    else:
        np.random.seed(0)
        weights = ft.generate_uniform_weights(num_rand, 3, device="cpu")
    return eng.prepare(verts, weights, centers, radii * radius_scale,
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


@pytest.mark.parametrize("num_rand", [None, 20000])
def test_seed_pass_counts_match_plain_on_a_cheese_scene(cuda_device,
                                                        num_rand):
    """K1's two passes on a seeded cheese scene, the grid of 4,960 samples a
    tetrahedron (39 patches of 128) and 20,000 random samples: all three
    columns of its stats (units, in-ball pairs, the seed pass's pairs)
    equal the plain version's, d^2 within 1e-6 of it, and its output equal
    bit for bit to K3's, the walk in one pass, whose computed tiles bound
    K1's units in every block."""
    from flooder_tpu_torch.tools.scene import build_scene

    sc = build_scene(20000, 40, seed=11)
    w = sc.weights
    if num_rand is not None:
        np.random.seed(11)
        w = ft.generate_uniform_weights(num_rand, 3, device="cpu")
    ops = sc.engine.prepare(sc.sim_verts, w, sc.centers, sc.radii, True)[0]
    assert ops[0].shape[1:3] == (-(-len(w) // cuda_flood.FEW_RT),
                                 cuda_flood.FEW_RT)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert stats_k.shape[1] == 3 and torch.equal(stats_k, stats_p)
    assert 0 < stats_k[:, 2].sum().item() <= stats_k[:, 1].sum().item()
    out_3, stats_3 = cuda_flood_stats.flood_min_stats(*ops)
    assert torch.equal(out_3, out_k)
    assert_k1_within_k3(stats_3, stats_k)


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
    assert_k1_within_k3(stats_3, stats_k)


# K3's cases beyond the Delaunay scenes, as k3_case_operands arguments; CPU
# tests (test_torch_kernel_stats.py) check through the plain version that each
# reaches the fold of a unit with no in-ball witness and a tile that test 3
# rejects inside an admitted unit. In tiles of 128 samples the dim cases have
# 9 to 16 tiles a simplex ("nr3" 11), so both tile groups of a CTA compute
# tiles and read each other's tile maxima; "nr1" has one tile (at most 128
# samples a simplex), "empty-block" three.
K3_CASES = {
    "dim1": dict(dim=1, r_count=1100),
    "dim2": dict(dim=2, r_count=2000),
    "dim4": dict(dim=4, r_count=1100),
    "nr1": dict(dim=3, r_count=120),
    "nr3": dict(dim=3, r_count=1300),
    "empty-block": dict(dim=3, r_count=300, empty_block=True),
}


def k3_case_operands(device, dim, r_count, empty_block=False, seed=7,
                     radius_max=1.3, rt=None, tight=True):
    """Seeded K3 operands from ``CudaFloodEngine.prepare``: 16,384 witnesses
    in [0, 5]^dim, 4 blocks of random simplices with the nearest-vertex
    bound on and radii in [0.1, radius_max) (past 8 coordinates the
    distance of the 2nd to 299th nearest witness). Every fourth ball has radius
    1e-5, so it meets the sub-chunk boxes around its centre but holds no
    witness; ``empty_block`` gives the last block radius 0, so its
    work-list is empty. ``rt`` sets the samples a tile (default: the
    engine's tiling; otherwise ``tiled_operands``); ``tight`` False turns
    the bound off."""
    rng = np.random.default_rng(seed + dim)
    X = (rng.random((16384, dim)) * 5).astype(np.float32)
    eng = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    S, k = cuda_flood.BS * 4, dim + 1
    centers = (rng.random((S, dim)) * 5).astype(np.float32)
    radii = (rng.random(S) * (radius_max - 0.1) + 0.1).astype(np.float32)
    if dim > cuda_flood.KERNEL_MAX_DIM:
        # such balls hold no witness: the radius of the 2nd to 299th
        # nearest witness instead
        d = np.sort(np.linalg.norm(X[None] - centers[:, None], axis=-1), 1)
        radii = d[np.arange(S), rng.integers(2, 300, S)].astype(np.float32)
    radii[::4] = 1e-5
    if empty_block:
        radii[-cuda_flood.BS:] = 0.0
    verts = centers[:, None, :] + (
        rng.random((S, k, dim)).astype(np.float32) - 0.5
    ) * 0.3
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (t(verts), w, t(centers), t(radii), tight)
    if rt is None:
        return eng.prepare(*args)[0]
    return tiled_operands(eng, *args, rt)[0]


def tiled_operands(engine, verts, weights, centers, radii, tight, rt):
    """What ``engine.prepare`` returns for one pass, in tiles of ``rt``
    samples instead of ``_tile_geometry``'s: at 1-8 coordinates K1 takes
    tiles of 128 alone, so tiles of 512 there are for the plain versions
    and K3."""
    nr = -(-weights.shape[0] // rt)
    num = verts.shape[0]
    s_total = cuda_flood._round_up(max(num, 1), cuda_flood.BS)
    verts, centers, radii = cuda_flood._pad_simplices(verts, centers, radii,
                                                      s_total)
    ws, sperm = cuda_flood._prepare_sample_weights(weights, nr * rt)
    samples, tile_lo, tile_hi, ub2, active, dist = cuda_flood._prep(
        verts - centers[:, None, :], torch.tensor(ws, device=verts.device),
        centers, radii, engine.chunk_lo, engine.chunk_hi, bs=cuda_flood.BS,
        nr=nr, rt=rt, tight=tight,
    )
    ops = (samples.contiguous(), engine.witnesses, engine.sub_lo,
           engine.sub_hi, centers.contiguous(), radii.contiguous(),
           tile_lo.contiguous(), tile_hi.contiguous(), ub2.contiguous(),
           *cuda_flood._worklist(active, dist))
    return ops, sperm, num


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


def assert_k1_within_k3(stats_3, stats_1):
    """K1's admitted units are no more than K3's computed tiles in every
    block: K3 computes the tiles of the walk in one pass, and K1's two
    passes (its seed pass first) admit a subset of them."""
    tiles = stats_3[:, cuda_flood_stats.COL_TILES].reshape(
        -1, cuda_flood.BS).sum(1)
    units = stats_1[:, 0].reshape(tiles.numel(), -1).sum(1)
    assert bool((units <= tiles).all())
    assert int(units.sum()) > 0


def assert_k3_matches_plain(ops):
    """K3, launched once through its wrapper, against its plain version
    (d^2 within 1e-6, inf alike, every counter equal) and against K1 (equal
    output, K1's units no more than K3's computed tiles in every block); on
    tiles that no K1 instance takes (more than 128 samples at 1-8
    coordinates), against K1's plain version (d^2 within 1e-6, its units no
    more than K3's tiles in every block)."""
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
    rt, dim = ops[0].shape[2:]
    if rt != cuda_flood.FEW_RT and dim <= cuda_flood.KERNEL_MAX_DIM:
        out_1, stats_1 = cuda_flood.flood_pairs_reference(*ops)
        assert torch.equal(out_1 >= cuda_flood._MASKED_D2, masked_p)
        assert (out_k[~masked_p] - out_1[~masked_p]).abs().max().item() <= (
            1e-6)
    else:
        out_1, stats_1 = cuda_flood.flood_min(*ops)
        assert torch.equal(out_k, out_1)
    assert_k1_within_k3(stats_k, stats_1)
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
    K3's raw buffer in dynamic shared memory) against their plain versions.
    Balls up to radius 3 in [0, 5]^dim hold a few hundred witnesses and cut
    sub-chunks; 1100 samples give 9 patches of 128 a simplex (K1's
    few-sample instance, K3 in 8 tile groups of a warp). On 3 tiles of 512,
    which K1 refuses at 1-8 coordinates, K3 (2 tile groups of 4 warps)
    against the plain versions."""
    ops = k3_case_operands(cuda_device, dim=dim, r_count=1100,
                           radius_max=3.0)
    assert ops[0].shape[1] == 9
    before = (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert not masked.all()
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    units, inball = cuda_flood.kernel_operations(stats_k)
    assert 0 < inball < units * cuda_flood.SUB * ops[0].shape[2]
    assert_k3_matches_plain(ops)

    tiled = k3_case_operands(cuda_device, dim=dim, r_count=1100,
                             radius_max=3.0, rt=cuda_flood.RT)
    assert tiled[0].shape[1] == 3
    before = cuda_flood.LAUNCHES
    with pytest.raises(ValueError, match="tiles of 128"):
        cuda_flood.flood_min(*tiled)
    assert cuda_flood.LAUNCHES == before
    assert_k3_matches_plain(tiled)


@pytest.mark.parametrize("r_count", [1, 64, 126, 256])
@pytest.mark.parametrize("dim", [3, 5, 8])
def test_flood_kernel_few_samples_match_plain(cuda_device, dim, r_count):
    """K1's few-sample instances (tiles of 128 samples, a warp a tile; two
    tiles at 256) against the plain version on balls up to radius 3 that
    cut sub-chunks, every fourth holding no witness: d^2 within 1e-6, inf
    alike, every count equal, in one launch of those instances."""
    ops = k3_case_operands(cuda_device, dim=dim, r_count=r_count,
                           radius_max=3.0)
    assert ops[0].shape[1:3] == (-(-r_count // cuda_flood.FEW_RT),
                                 cuda_flood.FEW_RT)
    before = (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert masked.any() and not masked.all()
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)
    assert cuda_flood.kernel_operations(stats_k)[0] > 0


def witness_simplex_inputs(device, dim, r_count, seed=7):
    """A pass's inputs on simplices whose vertices are witnesses, as the
    main path's landmarks are: (engine, verts, weights, centers, radii).
    16,384 witnesses in [0, 5]^dim, 4 blocks of simplices, each a witness
    and dim of its 40 nearest, with their bounding balls, and ``r_count``
    random barycentric weights. The nearest-vertex bound holds there."""
    from flooder_tpu_torch.ops.flood import simplex_bounding_balls

    rng = np.random.default_rng(seed + dim)
    X = (rng.random((16384, dim)) * 5).astype(np.float32)
    S, k = cuda_flood.BS * 4, dim + 1
    first = rng.choice(len(X), S, replace=False)
    near = np.argsort(np.linalg.norm(X[None] - X[first][:, None], axis=-1),
                      1)[:, 1:41]
    idx = np.stack([np.concatenate([[f], rng.choice(n, k - 1, replace=False)])
                    for f, n in zip(first, near)])
    verts = torch.from_numpy(X[idx]).to(device)
    centers, radii = simplex_bounding_balls(verts)
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    engine = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    return engine, verts, w, centers, radii


@pytest.mark.parametrize("r_count", [465, 4960])
@pytest.mark.parametrize("dim", [2, 3])
def test_flood_kernel_patches_match_plain(cuda_device, dim, r_count):
    """Past 384 samples a simplex (the figure-eight's 465 and the cheese's
    4,960 at 30 points per edge) K1 runs 128-sample patches through its
    few-sample instance, one launch, with the nearest-vertex bound on (the
    vertices are witnesses): against the plain version on the same
    patches, d^2 within 1e-6, inf alike, every count equal; and the
    largest d^2 of each simplex within 1e-6 of what the plain version gives
    on tiles of 512, with no more in-ball pairs."""
    inputs = witness_simplex_inputs(cuda_device, dim, r_count)
    ops = inputs[0].prepare(*inputs[1:], True)[0]
    assert ops[0].shape[1:3] == (-(-r_count // cuda_flood.FEW_RT),
                                 cuda_flood.FEW_RT)
    assert bool(torch.isfinite(ops[8]).all())  # the bound is on
    before = (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert not masked.all()
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)

    tiled = tiled_operands(*inputs, True, cuda_flood.RT)[0]
    assert tiled[0].shape[2] == cuda_flood.RT
    out_t, stats_t = cuda_flood.flood_pairs_reference(*tiled)
    # the padded slots repeat the last real row, so each max is over the
    # real samples in both
    top_k = out_k.reshape(out_k.shape[0], -1).amax(-1)
    top_t = out_t.reshape(out_t.shape[0], -1).amax(-1)
    fin = top_t < cuda_flood._MASKED_D2
    assert torch.equal(top_k < cuda_flood._MASKED_D2, fin) and fin.any()
    assert (top_k[fin] - top_t[fin]).abs().max().item() <= 1e-6
    pairs = cuda_flood.kernel_operations(stats_k)[1]
    assert 0 < pairs <= cuda_flood.kernel_operations(stats_t)[1]


def mixed_subchunk(engine):
    """The sub-chunks of an engine's witnesses that hold both real and
    padding rows (at ``WITNESS_PAD``), as a list of indices."""
    from flooder_tpu_torch.ops.flood import WITNESS_PAD

    pad = (engine.witnesses == WITNESS_PAD).all(1).reshape(-1, cuda_flood.SUB)
    return torch.nonzero(pad.any(1) & ~pad.all(1)).flatten().tolist()


def padded_cloud_inputs(device, dim, r_count, n=20000, seed=11):
    """A pass's inputs on a cloud that the engine pads: ``n`` witnesses in
    [0, 5]^dim, padded to ``witness_total(n)``. As in
    ``witness_simplex_inputs``, 4 blocks of simplices, each a witness and
    dim of its 40 nearest, with their bounding balls; the first witness
    of the first 2 blocks lies in the one sub-chunk that mixes real and
    padding rows, so their balls meet it. Returns (engine, verts, weights,
    centers, radii, the mixed sub-chunk)."""
    from flooder_tpu_torch.ops.flood import simplex_bounding_balls

    rng = np.random.default_rng(seed + dim)
    X = (rng.random((n, dim)) * 5).astype(np.float32)
    engine = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    (mixed,) = mixed_subchunk(engine)
    rows = engine.witnesses[mixed * cuda_flood.SUB:
                            (mixed + 1) * cuda_flood.SUB].cpu().numpy()
    # the engine keeps real rows bit for bit, so they are found in X
    real = np.flatnonzero((X[:, None, :] == rows[None]).all(-1).any(1))
    S, k = cuda_flood.BS * 4, dim + 1
    first = np.concatenate([
        rng.choice(real, S // 2, replace=len(real) < S // 2),
        rng.choice(len(X), S - S // 2, replace=False)])
    near = np.argsort(np.linalg.norm(X[None] - X[first][:, None], axis=-1),
                      1)[:, 1:41]
    idx = np.stack([np.concatenate([[f], rng.choice(m, k - 1, replace=False)])
                    for f, m in zip(first, near)])
    verts = torch.from_numpy(X[idx]).to(device)
    centers, radii = simplex_bounding_balls(verts)
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    return engine, verts, w, centers, radii, mixed


@pytest.mark.parametrize("dim", [2, 3])
def test_flood_kernel_matches_plain_on_a_padded_cloud(cuda_device, dim):
    """On the operands of a cloud that the engine pads with rows at
    ``WITNESS_PAD``, the work-list reaching the one sub-chunk that mixes
    real and padding rows: K1 against its plain version, d^2 within 1e-6,
    inf alike, every count equal."""
    *inputs, mixed = padded_cloud_inputs(cuda_device, dim, 465)
    ops = inputs[0].prepare(*inputs[1:], True)[0]
    spc = cuda_flood.WCHUNK // cuda_flood.SUB
    assert mixed // spc in ops[10].tolist()
    out_k, stats_k = cuda_flood.flood_min(*ops)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert not masked.all()
    assert (out_k[~masked] - out_p[~masked]).abs().max().item() <= 1e-6
    assert torch.equal(stats_k, stats_p)


@pytest.mark.parametrize("r_count", [1, 64, 126, 256, 384])
@pytest.mark.parametrize("dim", [9, 12, 16, 17, 37, 38, 40, 64])
def test_flood_kernel_few_samples_past_8_coordinates(cuda_device, dim,
                                                      r_count):
    """K1's few-sample instances past 8 coordinates (flood_min_few_wide at
    9-16, flood_min_few_slabs past 16: tiles of 128 samples, a warp a tile;
    one to three tiles a simplex) in one few-sample launch: against the
    plain version (the bar of assert_within_wide_bar, inf in place, +inf
    from 38 coordinates on, every count equal) and against K3's
    runtime-width instance (bit for bit, K1's units no more than its
    computed tiles in every block)."""
    ops = k3_case_operands(cuda_device, dim=dim, r_count=r_count)
    assert ops[0].shape[1:3] == (-(-r_count // cuda_flood.FEW_RT),
                                 cuda_flood.FEW_RT)
    assert cuda_flood.k1_instance(cuda_flood.FEW_RT, dim) == (
        "flood_min_few_wide" if dim <= 16 else "flood_min_few_slabs")
    before = (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert (cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    assert_within_wide_bar(out_k, out_p, dim)
    assert torch.equal(stats_k, stats_p)
    masked = out_p >= cuda_flood._MASKED_D2
    assert masked.any() and not masked.all()
    # a unit with no in-ball witness folds in a finite masked d2 below 38
    # coordinates, +inf from 38 on
    assert bool((masked & torch.isfinite(out_p)).any()) == (dim < 38)
    units = cuda_flood.kernel_operations(stats_k)[0]
    assert units > 0
    out_3, stats_3 = cuda_flood_stats.flood_min_stats(*ops)
    assert torch.equal(out_3, out_k)
    assert_k1_within_k3(stats_3, stats_k)


def test_landmarks_on_another_device_are_refused_on_card(cuda_device):
    """As flooder_tpu: CPU landmarks with a CUDA cloud raise before any
    move; numpy landmarks, and a CPU cloud and CPU landmarks with
    ``device=``, are moved to the card (test_12d_cloud_through_k2_and_k1
    moves CPU landmarks with a numpy cloud)."""
    X = ft.generate_swiss_cheese_points(3000, seed=5, device=cuda_device)[0]
    L = ft.generate_landmarks(X, 30, start_idx=0)
    with pytest.raises(RuntimeError, match=r"landmarks\.device \(cpu\) != "
                       r"points\.device \(cuda:0\)"):
        ft.flood_complex(X, L.cpu(), points_per_edge=5)
    want = ft.flood_complex(X, L, points_per_edge=5)
    assert ft.flood_complex(X, L.cpu().numpy(), points_per_edge=5) == want
    assert ft.flood_complex(X.cpu(), L.cpu(), points_per_edge=5,
                            device=cuda_device) == want


def assert_within_wide_bar(out_k, out_p, dim):
    """A runtime-width kernel's d2 against its plain version's: no-witness
    entries (>= 1e30) and +inf in the same places, every other d2 within
    2 * dim * 2**-24 * d2, the fp32 bound of two summation orders of dim
    terms (one FMA a coordinate against separately rounded products and
    sums; tests/test_torch_dims.py grounds it on the CPU)."""
    masked = out_p >= cuda_flood._MASKED_D2
    assert torch.equal(out_k >= cuda_flood._MASKED_D2, masked)
    assert torch.equal(torch.isinf(out_k), torch.isinf(out_p))
    a, b = out_k[~masked].double(), out_p[~masked].double()
    assert bool(((a - b).abs() <= 2 * dim * 2.0**-24 * b).all())


@pytest.mark.parametrize("dim", [9, 16, 37, 38, 40, 64])
def test_flood_kernels_past_8_coordinates_equal_plain(cuda_device, dim):
    """K1's and K3's runtime-width instances against their plain versions:
    d2 within the bar of assert_within_wide_bar (they sum with one FMA a
    coordinate), inf in the same places (a masked d2 overflows to +inf from
    38 coordinates on, on both sides), every count equal, K3's output K1's
    bit for bit and K1's units no more than K3's tiles, in one launch each.
    16 coordinates is the widest single slab, 37 the widest finite masked
    d2."""
    ops = k3_case_operands(cuda_device, dim=dim, r_count=1100)
    assert ops[0].shape[1] == 3
    before = cuda_flood.LAUNCHES
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    assert cuda_flood.LAUNCHES == before + 1
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    assert_within_wide_bar(out_k, out_p, dim)
    assert torch.equal(stats_k, stats_p)
    masked = out_p >= cuda_flood._MASKED_D2
    assert masked.any() and not masked.all()
    # a unit with no in-ball witness folds in a finite masked d2 below 38
    # coordinates, +inf from 38 on
    assert bool((masked & torch.isfinite(out_p)).any()) == (dim < 38)
    units, inball = cuda_flood.kernel_operations(stats_k)
    assert 0 < inball < units * cuda_flood.SUB * ops[0].shape[2]
    before = cuda_flood_stats.LAUNCHES
    out_3, stats_3 = cuda_flood_stats.flood_min_stats(*ops)
    torch.cuda.synchronize()
    assert cuda_flood_stats.LAUNCHES == before + 1
    out_3p, stats_3p = cuda_flood_stats.flood_stats_reference(*ops)
    assert_within_wide_bar(out_3, out_3p, dim)
    assert torch.equal(out_3, out_k)
    assert torch.equal(stats_3, stats_3p)
    assert_k1_within_k3(stats_3, stats_k)


def test_12d_cloud_through_k2_and_k1(cuda_device):
    """generate_landmarks and flood_complex on a small 12-D cloud through
    K2 and K1 on the card, against the CPU run."""
    pts = np.random.default_rng(12).random((3000, 12)).astype(np.float32)
    X = torch.from_numpy(pts).to(cuda_device)
    f0 = cuda_fps.LAUNCHES
    L = ft.generate_landmarks(X, 15, start_idx=0)
    assert cuda_fps.LAUNCHES == f0 + 1
    L_cpu = ft.generate_landmarks(pts, 15, start_idx=0, device="cpu")
    assert torch.equal(L.cpu(), L_cpu)  # no ties in a uniform cloud
    out = {}
    for dev in ("cpu", "cuda"):
        k0 = cuda_flood.LAUNCHES
        out[dev] = _complex(dev, pts, L_cpu, points_per_edge=4,
                            max_dimension=3)
        if dev == "cuda":
            assert cuda_flood.LAUNCHES == k0 + 1
    _assert_same(out["cpu"], out["cuda"], 1e-6)
    assert np.isfinite([v for s, v in out["cuda"].items() if len(s) == 4]
                       ).all()


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
    assert counters["computed_tiles"] >= counters["production_units"] > 0
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


@pytest.fixture
def second_cuda_device(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda:1")


def _mesh_against_single_card(devices, simplex_parallel, device):
    """A mesh's complexes (grid and random mode) against the single-card
    kernel engine on the mesh's first device: exactly equal, and K1
    launched once per shard and pass."""
    from flooder_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices, simplex_parallel=simplex_parallel)
    n_shards = mesh.shape["simplex"] * mesh.shape["witness"]
    X = ft.generate_noisy_torus_points_3d(20000, seed=4, device=device)
    L = ft.generate_landmarks(X, 120, start_idx=0, device=device)
    for kw in (dict(points_per_edge=8),
               dict(num_rand=64, points_per_edge=None)):
        np.random.seed(1)
        want = _complex(device, X, L, **kw)
        np.random.seed(1)
        k0 = cuda_flood.LAUNCHES
        got = ft.flood_complex(X, L, mesh=mesh, **kw)
        passes = 4 if "num_rand" in kw else 1  # dims 0-3, or the top only
        assert cuda_flood.LAUNCHES == k0 + passes * n_shards
        assert got.keys() == want.keys()
        assert all(got[s] == v for s, v in want.items())


def test_mesh_on_one_card_equals_single_card(cuda_device):
    """The (2, 2) mesh of one card named four times."""
    _mesh_against_single_card(["cuda:0"] * 4, 2, torch.device("cuda:0"))


def test_mesh_on_second_card(second_cuda_device):
    """A mesh over cuda:1 (the kernels launch on the shard's device, not
    the current one) and a mesh over two cards."""
    _mesh_against_single_card(["cuda:1"] * 2, 1, second_cuda_device)
    _mesh_against_single_card(["cuda:1", "cuda:0"], 1, second_cuda_device)
