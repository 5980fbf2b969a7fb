"""The port's flood engine pieces against flooder_tpu.ops.pallas_flood:
witness order, curve orders, bounding balls, operand preparation, the
work-list, the epilogues, and the plain version of kernel K1 against the
Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flooder_tpu as fj
import flooder_tpu_torch as ft
from flooder_tpu.ops import flood as flood_j
from flooder_tpu.ops import pallas_flood as pf
from flooder_tpu_torch.ops import cuda_flood as cf
from flooder_tpu_torch.ops.flood import simplex_bounding_balls


@pytest.mark.parametrize(
    "n,leaf,dim",
    [(512, 512, 3), (4096, 512, 3), (8192, 512, 2), (4096, 512, 5),
     (2048, 256, 1), (3 * 512, 512, 3), (12 * 512, 512, 3)],
)
def test_kd_order_matches_host_reference(n, leaf, dim):
    rng = np.random.default_rng(n + dim)
    pts = rng.uniform(0, 5, (n, dim)).astype(np.float32)
    got = cf.kd_order(torch.from_numpy(pts), leaf).numpy()
    np.testing.assert_array_equal(got, pf.kd_order_np(pts, leaf))
    dup = np.concatenate([pts[: n // 2], pts[: n // 2]])
    got = cf.kd_order(torch.from_numpy(dup), leaf).numpy()
    np.testing.assert_array_equal(got, pf.kd_order_np(dup, leaf))


@pytest.mark.parametrize("n", [1, 1500, 2049, 1_000_000, 4_300_000])
def test_witness_total_aligns_kd_leaves(n):
    total = cf.witness_total(n)
    assert total >= n and total % cf.WCHUNK == 0
    assert total < 2 * max(n, cf.WCHUNK)
    leaves = total // cf.SUB
    assert leaves & (leaves - 1) == 0  # every kd split on a leaf boundary


@pytest.mark.parametrize("dim,bits", [(2, 12), (3, 8), (4, 6)])
def test_curve_codes_and_orders_equal(dim, bits):
    rng = np.random.default_rng(dim)
    p32 = (rng.random((3000, dim)) * 7 - 2).astype(np.float32)
    np.testing.assert_array_equal(
        cf.hilbert_codes_np(p32, bits), pf.hilbert_codes_np(p32, bits)
    )
    np.testing.assert_array_equal(
        cf.hilbert_codes(torch.from_numpy(p32), bits).numpy(),
        np.asarray(pf.hilbert_codes(p32, bits)),
    )
    np.testing.assert_array_equal(
        cf.morton_codes(torch.from_numpy(p32), bits).numpy(),
        np.asarray(pf.morton_codes(p32, bits)),
    )
    np.testing.assert_array_equal(
        cf.spatial_order_np(p32, bits), pf.spatial_order_np(p32, bits)
    )


@pytest.mark.parametrize("dim", [9, 24, 63, 64, 100])
def test_curve_codes_past_8_coordinates(dim):
    """At the engine's and K2's bits per axis, int64 curve codes equal the
    reference's up to 63 coordinates; past that they code the first 63
    coordinates (a wider code would shift past the sign bit), stay
    non-negative and agree between numpy and torch."""
    bits = max(1, min(10, cf.MORTON_BITS_TOTAL // dim))
    p32 = np.random.default_rng(dim).random((2000, dim)).astype(np.float32)
    got = cf.hilbert_codes_np(p32, bits)
    np.testing.assert_array_equal(
        cf.hilbert_codes(torch.from_numpy(p32), bits).numpy(), got)
    assert (got >= 0).all()
    coded = min(dim, 63 // bits)
    np.testing.assert_array_equal(
        got, pf.hilbert_codes_np(p32[:, :coded], bits))
    if dim <= 63:
        np.testing.assert_array_equal(got, pf.hilbert_codes_np(p32, bits))
        np.testing.assert_array_equal(cf.spatial_order_np(p32, bits),
                                      pf.spatial_order_np(p32, bits))


def test_sample_orders_equal():
    from flooder_tpu.core import _grid_host

    for ppe, dim in [(30, 3), (10, 3), (12, 2), (7, 1)]:
        w = _grid_host(ppe, dim)[0].astype(np.float32)
        np.testing.assert_array_equal(
            cf._sample_morton_order(w), pf._sample_morton_order(w)
        )
    rng = np.random.default_rng(0)
    w = rng.random((256, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        cf._sample_morton_order(w), pf._sample_morton_order(w)
    )
    ws_t, sperm_t = cf._prepare_sample_weights(w, 384)
    ws_j, sperm_j = pf._prepare_sample_weights(w, 384)
    np.testing.assert_array_equal(sperm_t, sperm_j)
    np.testing.assert_array_equal(ws_t, np.asarray(ws_j))


@pytest.mark.parametrize("k,dim", [(4, 3), (3, 2), (2, 3), (3, 3)])
def test_bounding_balls_agree(k, dim):
    rng = np.random.default_rng(k * 10 + dim)
    v = rng.random((300, k, dim)).astype(np.float32)
    cj, rj = flood_j.simplex_bounding_balls(v)
    ct, rt = simplex_bounding_balls(torch.from_numpy(v))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)


def _prep_inputs(seed=7, s_blocks=8, r_count=40, k=4):
    rng = np.random.default_rng(seed)
    X = (rng.random((16384, 3)) * 5).astype(np.float32)
    eng = cf.CudaFloodEngine(torch.from_numpy(X))
    S = cf.BS * s_blocks
    centers = (rng.random((S, 3)) * 5).astype(np.float32)
    radii = (rng.random(S) * 1.5 + 0.1).astype(np.float32)
    radii[-3:] = 0.0  # padding-like rows admit nothing
    verts = centers[:, None, :] + (
        rng.random((S, k, 3)).astype(np.float32) - 0.5
    ) * 0.3
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    rt, nr, r2_total = cf._tile_geometry(len(w), 3)
    ws, _ = cf._prepare_sample_weights(w, r2_total)
    vl = (verts - centers[:, None, :]).astype(np.float32)
    return eng, ws, vl, centers, radii, nr, rt


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("r_count", [40, 600])
def test_prep_matches_jax(tight, r_count):
    eng, ws, vl, centers, radii, nr, rt = _prep_inputs(r_count=r_count)
    clo, chi = eng.chunk_lo.numpy(), eng.chunk_hi.numpy()
    j = pf._prep(
        jnp.asarray(vl), jnp.asarray(ws), jnp.asarray(centers),
        jnp.asarray(radii), jnp.asarray(clo), jnp.asarray(chi),
        bs=cf.BS, nr=nr, rt=rt, tight=tight, wchunk=cf.WCHUNK, pack="f32",
    )
    j_samples, j_tlo, j_thi, j_ub2, (j_active, j_dist) = j
    t = cf._prep(
        torch.from_numpy(vl), torch.from_numpy(ws.copy()),
        torch.from_numpy(centers), torch.from_numpy(radii),
        eng.chunk_lo, eng.chunk_hi, bs=cf.BS, nr=nr, rt=rt, tight=tight,
    )
    samples, tlo, thi, ub2, active, dist = (x.numpy() for x in t)
    np.testing.assert_allclose(
        samples, np.transpose(np.asarray(j_samples), (0, 1, 3, 2)),
        atol=1e-6,
    )
    np.testing.assert_allclose(tlo, np.asarray(j_tlo), atol=1e-6)
    np.testing.assert_allclose(thi, np.asarray(j_thi), atol=1e-6)
    np.testing.assert_allclose(ub2, np.asarray(j_ub2)[..., 0], atol=1e-6)
    np.testing.assert_array_equal(active, np.asarray(j_active))
    assert active.any() and not active.all()
    np.testing.assert_allclose(dist, np.asarray(j_dist), rtol=1e-6)

    # the CSR work-list visits the same pairs in the same order as the
    # TPU engine's host work-list (block-major, nearest chunk first)
    blk_ptr, blk_chunks = cf._worklist(t[4], t[5])
    ps, pc = np.nonzero(active)
    order = np.lexsort((dist[ps, pc], ps))
    np.testing.assert_array_equal(blk_chunks.numpy(), pc[order])
    np.testing.assert_array_equal(
        np.diff(blk_ptr.numpy()), np.bincount(ps, minlength=len(active))
    )


def test_epilogues_match_jax():
    rng = np.random.default_rng(3)
    acc = rng.random((40, 64)).astype(np.float32)
    acc[3, :] = 9e36
    acc[5, 7] = 2e30
    tables = (np.arange(64).reshape(1, 64), rng.integers(0, 64, (6, 5)))
    got = cf._facemax_epilogue(
        torch.from_numpy(acc), [torch.from_numpy(t) for t in tables]
    )
    want = pf._facemax_epilogue(
        jnp.asarray(acc), tuple(jnp.asarray(t) for t in tables)
    )
    got = list(got) + [cf._max_sqrt_epilogue(torch.from_numpy(acc))]
    want = list(want) + [pf._max_sqrt_epilogue(jnp.asarray(acc))]
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        # XLA's CPU sqrt may differ from torch's by one ulp
        np.testing.assert_allclose(g, w, rtol=2e-7)


@pytest.mark.parametrize("tight", [True, False])
def test_plain_kernel_matches_pallas_interpret(tight):
    """flood_pairs_reference (through the engine, on CPU tensors) against
    PallasFloodEngine in interpret mode: values within 1e-5, inf in the
    same places."""
    from flooder_tpu.core import _grid_host
    from flooder_tpu.topology import DelaunayComplex

    X = np.asarray(fj.generate_noisy_torus_points_3d(2000, seed=9))
    L = np.asarray(fj.generate_landmarks(X, 40, start_idx=0))
    tets = DelaunayComplex(L.astype(np.float64)).create_simplex_tree()
    sv = L[tets._verts[3]]
    c, r = (np.asarray(a) for a in flood_j.simplex_bounding_balls(sv))
    if not tight:
        # explicit landmarks off the cloud: shifted, with balls some of
        # which hold no witness at all
        sv = sv + np.float32(0.05)
        c, r = (np.asarray(a) for a in flood_j.simplex_bounding_balls(sv))
        r = (r * np.float32(0.5)).astype(np.float32)
    w = _grid_host(8, 3)[0]
    eng_j = pf.PallasFloodEngine(jnp.asarray(X), pf.WCHUNK, interpret=True)
    want = np.asarray(eng_j.min_distances(
        jnp.asarray(sv), jnp.asarray(w, dtype=jnp.float32), jnp.asarray(c),
        jnp.asarray(r), None, tight=tight,
    ))
    eng_t = cf.CudaFloodEngine(torch.tensor(X))
    got = eng_t.min_distances(
        torch.from_numpy(sv), w, torch.from_numpy(c), torch.from_numpy(r),
        tight=tight,
    ).numpy()
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    assert (~inf).any()
    if not tight:
        assert inf.any()
    np.testing.assert_allclose(got[~inf], want[~inf], atol=1e-5)
    units, pairs = cf.kernel_operations(eng_t.last_stats)
    assert units > 0 and pairs > 0


def _one_pass_walk(ops):
    """The walk K3 takes (``csrc/flood_stats.cu``, K1's tile test in one
    pass over each block's list), counted as K1 counts: per block, its
    admitted (simplex, tile, sub-chunk) units and their in-ball pairs."""
    samples, witnesses, sub_lo, sub_hi, centers, radii, tlo, thi, ub2 = \
        ops[:9]
    ptr, chunks = ops[9].tolist(), ops[10].tolist()
    s_total, nr, rt, dim = samples.shape
    spc = cf.WCHUNK // cf.SUB
    acc = torch.full((s_total, nr, rt), float("inf"))
    units, pairs = [], []
    for b in range(s_total // cf.BS):
        sl = slice(b * cf.BS, (b + 1) * cf.BS)
        c, r2, a = centers[sl], radii[sl] * radii[sl], acc[sl]
        u = p = 0
        subs = [ch * spc + q for ch in chunks[ptr[b]:ptr[b + 1]]
                for q in range(spc)]
        hit, g2 = cf._walk_tests(sub_lo, sub_hi, torch.tensor(subs), c, r2,
                                 tlo[sl], thi[sl])
        for j, sub in enumerate(subs):
            ok = hit[j][:, None] & (g2[j] <= torch.minimum(a.amax(-1),
                                                           ub2[sl]))
            if not bool(ok.any()):
                continue
            yl = witnesses[sub * cf.SUB:(sub + 1) * cf.SUB][None] - c[:, None]
            inb = cf._sqsum(yl) <= r2[:, None]
            ym = torch.where(inb[..., None], yl, torch.full_like(yl, cf.MASK))
            si, ri = ok.nonzero(as_tuple=True)
            d2 = cf._sqsum(ym[si][:, None] - samples[sl][si, ri][:, :, None])
            a[si, ri] = torch.minimum(a[si, ri], d2.amin(-1))
            u += int(ok.sum())
            p += int((ok.long() * inb.sum(1)[:, None]).sum()) * rt
        units.append(u)
        pairs.append(p)
    return torch.tensor(units), torch.tensor(pairs)


def _scene_pass(cloud, mode, tight):
    """K1's operands of a scene's top pass: the grid of ``build_scene``
    (30 points per edge, in 128-sample patches) or 300 random samples a
    simplex, with the nearest-vertex bound on or off."""
    from flooder_tpu_torch.core import generate_uniform_weights
    from flooder_tpu_torch.tools.scene import build_scene

    sc = build_scene(1000, 24, cloud=cloud, device="cpu")
    w = sc.weights
    if mode == "random":
        np.random.seed(7)
        w = generate_uniform_weights(300, sc.dim, device="cpu")
    return sc.engine.prepare(sc.sim_verts, w, sc.centers, sc.radii,
                             tight)[0]


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("cloud", ["cheese3d", "eight2d"])
def test_seed_pass_admits_a_subset_of_the_one_pass_walk(one_thread, cloud,
                                                        mode, tight):
    """K1's plain version walks each list twice, its seed pass first: its
    values equal K3's plain version's (the walk in one pass) bit for bit;
    block by block its admitted units and in-ball pairs are no more than
    K3's computed tiles and their pairs, and fewer on the cheese; the seed
    pass's pairs (column 2) are part of the pairs, above 0 where a tile's
    box meets a sub-chunk that passes the ball test."""
    from flooder_tpu_torch.ops import cuda_flood_stats as cfs

    ops = _scene_pass(cloud, mode, tight)
    nr = ops[0].shape[1]
    out, stats = cf.flood_pairs_reference(*ops)
    out3, st3 = cfs.flood_stats_reference(*ops)
    assert torch.equal(out, out3)
    one_units, one_pairs = _one_pass_walk(ops)
    tiles = st3[:, cfs.COL_TILES].reshape(-1, cf.BS).sum(1)
    assert torch.equal(one_units, tiles)
    per_blk = stats.reshape(-1, nr, 3).sum(1)
    assert (per_blk[:, 0] <= tiles).all()
    assert (per_blk[:, 1] <= one_pairs).all()
    if cloud == "cheese3d":
        assert per_blk[:, 0].sum() < tiles.sum()
        assert per_blk[:, 1].sum() < one_pairs.sum()
    assert (stats[:, 2] <= stats[:, 1]).all()
    # a tile whose box meets a sub-chunk in its ball has a seed pass
    samples, _, sub_lo, sub_hi, centers, radii, tlo, thi = ops[:8]
    ptr, chunks = ops[9].tolist(), ops[10]
    spc = cf.WCHUNK // cf.SUB
    met = torch.zeros(stats.shape[0] // nr, nr, dtype=torch.bool)
    for b in range(met.shape[0]):
        sl = slice(b * cf.BS, (b + 1) * cf.BS)
        subs = (chunks[ptr[b]:ptr[b + 1]].long()[:, None] * spc
                + torch.arange(spc)).reshape(-1)
        hit, g2 = cf._walk_tests(sub_lo, sub_hi, subs, centers[sl],
                                 radii[sl] * radii[sl], tlo[sl], thi[sl])
        met[b] = (hit[..., None] & (g2 == 0)).any(1).any(0)
    assert met.any()
    assert (stats[:, 2].reshape(-1, nr)[met] > 0).float().mean() > 0.5
    assert int(stats[:, 2].sum()) > 0


@pytest.fixture
def one_thread():
    """K1's plain version is a loop of small torch ops: on one thread it
    does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cyclic_engine(points):
    """The engine on the cloud padded to ``witness_total`` by cyclic copies
    of its rows, as the engine padded it before its padding rows sat at
    ``WITNESS_PAD``: the copies make the count whole, so the engine adds
    no row of its own."""
    n = points.shape[0]
    total = cf.witness_total(n)
    reps = points.repeat(-(-total // n), 1)[: total - n]
    return cf.CudaFloodEngine(torch.cat([points, reps]))


def _port_call(monkeypatch, X, L, engine, **kw):
    """The port's flood_complex on the CPU through ``engine`` (a factory of
    the kernel engine): (complex as a dict, the engine)."""
    from flooder_tpu_torch import core

    monkeypatch.setattr(core, "CudaFloodEngine", engine)
    np.random.seed(5)
    got = ft.flood_complex(torch.from_numpy(X.copy()), torch.from_numpy(L),
                           device="cpu", **kw)
    return got, core._ENGINE_CACHE[-1][2]


# (points, coordinates, mode, landmarks in the cloud): every cloud is padded
PADDED_CLOUDS = [
    (700, 3, "grid", True), (700, 2, "random", False),
    (3000, 2, "grid", False), (3000, 3, "random", True),
    (78000, 3, "grid", True), (78000, 2, "random", False),
]


@pytest.mark.parametrize("n,dim,mode,tight", PADDED_CLOUDS)
def test_padding_rows_leave_every_value_and_cut_pairs(monkeypatch, one_thread,
                                                      n, dim, mode, tight):
    """Padding rows at WITNESS_PAD against cyclic copies, through
    flood_complex: every filtration value equal bit for bit, each within
    1e-5 of flooder_tpu's, and fewer in-ball pairs in K1's last pass."""
    assert cf.witness_total(n) > n
    rng = np.random.default_rng(n + dim)
    X = rng.random((n, dim)).astype(np.float32)
    L = X[rng.choice(n, 24, replace=False)]
    if not tight:
        # explicit landmarks, some off the cloud
        L = L + np.float32(0.1)
    kw = ({"points_per_edge": 5} if mode == "grid"
          else {"num_rand": 64, "points_per_edge": None})
    got, eng = _port_call(monkeypatch, X, L, cf.CudaFloodEngine,
                          landmarks_in_cloud=tight, **kw)
    old, eng_old = _port_call(monkeypatch, X, L, _cyclic_engine,
                              landmarks_in_cloud=tight, **kw)
    assert eng.witnesses.shape == eng_old.witnesses.shape
    assert got == old  # bit for bit, inf alike
    pairs = cf.kernel_operations(eng.last_stats)[1]
    assert 0 < pairs < cf.kernel_operations(eng_old.last_stats)[1]
    np.random.seed(5)
    ref = fj.flood_complex(X, L, use_pallas=False, **kw)
    assert set(ref) == set(got)
    for simplex, val in ref.items():
        if np.isinf(val):
            assert np.isinf(got[simplex]), simplex
        else:
            assert abs(got[simplex] - val) < 1e-5, (simplex, val)


def test_an_unpadded_cloud_runs_as_before(monkeypatch, one_thread):
    """16,384 points fill 32 leaves of 512: no padding row, the same
    witnesses and the same pairs as the cyclic engine."""
    rng = np.random.default_rng(3)
    X = rng.random((16384, 3)).astype(np.float32)
    L = X[rng.choice(len(X), 24, replace=False)]
    got, eng = _port_call(monkeypatch, X, L, cf.CudaFloodEngine,
                          points_per_edge=5)
    old, eng_old = _port_call(monkeypatch, X, L, _cyclic_engine,
                              points_per_edge=5)
    assert cf.witness_total(16384) == 16384
    assert torch.equal(eng.witnesses, eng_old.witnesses)
    assert not eng.padded_chunks.any()
    assert got == old
    assert torch.equal(eng.last_stats, eng_old.last_stats)


@pytest.mark.parametrize(
    "n,dim,scale,offset",
    [(700, 3, 1.0, 0.0), (2049, 1, 1.0, 0.0), (3000, 2, 1e-4, -3.0),
     (9000, 5, 1e6, 2e6), (5000, 9, 1.0, 0.0), (78000, 3, 1.0, 0.0)],
)
def test_padding_rows_share_one_subchunk_with_real_rows(n, dim, scale,
                                                        offset):
    """Whatever the cloud's scale: the padding rows are the tail of the k-d
    order, at most one sub-chunk mixes them with real rows, the real rows
    are the cloud's, and ``padded_chunks`` names the chunks that hold a
    padding row."""
    from flooder_tpu_torch.ops.flood import WITNESS_PAD
    from test_torch_cuda import mixed_subchunk

    rng = np.random.default_rng(n)
    X = (rng.random((n, dim)) * scale + offset).astype(np.float32)
    eng = cf.CudaFloodEngine(torch.from_numpy(X))
    pad = (eng.witnesses == WITNESS_PAD).all(1)
    assert int(pad.sum()) == cf.witness_total(n) - n
    assert not pad[:n].any() and pad[n:].all()
    assert len(mixed_subchunk(eng)) == int(n % cf.SUB != 0)
    real = eng.witnesses[:n].numpy()
    np.testing.assert_array_equal(real[np.lexsort(real.T)],
                                  X[np.lexsort(X.T)])
    np.testing.assert_array_equal(eng.padded_chunks.numpy(),
                                  pad.reshape(-1, cf.WCHUNK).any(1).numpy())


def test_no_padding_row_lies_in_a_ball_that_holds_the_cloud(one_thread):
    """Explicit landmarks off the cloud's box, with balls enlarged to hold
    the whole box: no padding row lies in any ball, no pair of one is
    computed, and every value equals the cyclic engine's."""
    from flooder_tpu_torch.ops.flood import WITNESS_PAD
    from flooder_tpu_torch.topology import DelaunayComplex

    rng = np.random.default_rng(8)
    X = rng.random((3000, 3)).astype(np.float32)
    L = (rng.random((16, 3)) * 3 - 1).astype(np.float32)
    tets = DelaunayComplex(L.astype(np.float64)).create_simplex_tree()
    sv = torch.from_numpy(L[tets._verts[3]])
    c, _ = simplex_bounding_balls(sv)
    corners = torch.tensor(np.stack(np.meshgrid(*[[0.0, 1.0]] * 3),
                                    -1).reshape(-1, 3), dtype=torch.float32)
    r = torch.cdist(c, corners).amax(1) * 1.01
    eng = cf.CudaFloodEngine(torch.from_numpy(X))
    pad_row = torch.full((3,), WITNESS_PAD)
    assert bool(((pad_row - c) ** 2).sum(1).gt(r * r).all())
    assert bool((torch.cdist(c, torch.from_numpy(X)) <= r[:, None]).all())
    w = _grid_host_weights(6)
    got = eng.min_distances(sv, w, c, r, tight=False)
    old_eng = _cyclic_engine(torch.from_numpy(X))
    want = old_eng.min_distances(sv, w, c, r, tight=False)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    pairs = cf.kernel_operations(eng.last_stats)[1]
    assert 0 < pairs < cf.kernel_operations(old_eng.last_stats)[1]
    # every pair K1 counted is a real witness's: at most all real
    # witnesses against every sample slot of every admitted simplex
    ops = eng.prepare(sv, w, c, r, False)[0]
    slots = ops[0].shape[1] * ops[0].shape[2]
    assert pairs <= len(sv) * slots * len(X)


def _grid_host_weights(ppe):
    from flooder_tpu.core import _grid_host

    return _grid_host(ppe, 3)[0]


def test_the_mixed_subchunk_reaches_the_card_tests_worklist(one_thread):
    """The operands of ``test_torch_cuda.py``'s padded-cloud case list the
    chunk of the one mixed sub-chunk, whose box meets a ball of a block
    that visits it, and the plain K1 runs them with finite minima."""
    from test_torch_cuda import padded_cloud_inputs

    *inputs, mixed = padded_cloud_inputs("cpu", 3, 465)
    eng = inputs[0]
    ops = eng.prepare(*inputs[1:], True)[0]
    spc = cf.WCHUNK // cf.SUB
    blk_ptr, blk_chunks = ops[9].tolist(), ops[10].tolist()
    blocks = [b for b in range(len(blk_ptr) - 1)
              if mixed // spc in blk_chunks[blk_ptr[b]:blk_ptr[b + 1]]]
    assert blocks
    lo, hi = eng.sub_lo[mixed], eng.sub_hi[mixed]
    c, r = ops[4], ops[5]
    near = torch.minimum(torch.maximum(c, lo), hi) - c
    meets = (near * near).sum(1) <= r * r
    assert any(bool(meets[b * cf.BS:(b + 1) * cf.BS].any()) for b in blocks)
    out, _ = cf.flood_pairs_reference(*ops)
    assert bool((out < cf._MASKED_D2).any())


def test_mesh_gives_padding_only_chunks_no_work(one_thread):
    """Under a 1x4 mesh no work-list of a witness shard names a chunk of
    padding rows alone, and the values equal one device's."""
    from flooder_tpu_torch.ops.flood import WITNESS_PAD
    from flooder_tpu_torch.parallel import MeshCudaFloodEngine, make_mesh

    X, sv, w, c, r = _padded_pass(9000)
    mesh = make_mesh(["cpu"] * 4, simplex_parallel=1)
    eng = MeshCudaFloodEngine(X, mesh)
    assert int(cf.witness_total(9000) // cf.WCHUNK) == 8
    shards = eng.shard_operands(sv, w, c, r, True)[0]
    only_pad = 0
    for row in shards:
        for ops in row:
            chunk_pad = (ops[1] == WITNESS_PAD).all(1).reshape(
                -1, cf.WCHUNK).all(1)
            only_pad += int(chunk_pad.sum())
            assert not chunk_pad[ops[10].long()].any()
    assert only_pad == 3
    got = eng.min_distances(sv, w, c, r, tight=True)
    want = cf.CudaFloodEngine(X).min_distances(sv, w, c, r, tight=True)
    assert torch.equal(got, want)


def _padded_pass(n, lms=20, seed=4):
    """A 3-D grid pass on a padded cloud of ``n`` points whose vertices are
    witnesses: (cloud, verts, weights, centers, radii)."""
    from flooder_tpu_torch.topology import DelaunayComplex

    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    L = X[torch.from_numpy(rng.choice(n, lms, replace=False))]
    tets = DelaunayComplex(L.double().numpy()).create_simplex_tree()._verts[3]
    sv = L[torch.as_tensor(tets).long()]
    c, r = simplex_bounding_balls(sv)
    return X, sv, _grid_host_weights(6), c, r


@pytest.mark.parametrize(
    "lens",
    [np.random.default_rng(5).integers(0, 6, 50), np.full(9, 4), []],
    ids=["ties", "all-equal", "no-block"],
)
def test_cta_order_runs_longest_worklist_first(lens):
    """K1's launch order: a permutation of the blocks, by decreasing
    work-list length, ties by block index; with grid row i running block
    order[i] on every tile, each (block, tile) CTA runs exactly once."""
    lens = np.asarray(lens, dtype=np.int64)
    blk_ptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32)
    order = cf._cta_order(blk_ptr)
    assert order.dtype == torch.int32
    o = order.numpy()
    np.testing.assert_array_equal(
        o, sorted(range(len(lens)), key=lambda b: (-lens[b], b))
    )
    nr = 3
    ctas = (o[:, None].astype(np.int64) * nr + np.arange(nr)).reshape(-1)
    np.testing.assert_array_equal(np.sort(ctas), np.arange(len(lens) * nr))


def _meta_operands(dim=3, s_total=8):
    f = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    return [f(s_total, 1, 128, dim), f(2048, dim), f(4, dim), f(4, dim),
            f(s_total, dim), f(s_total), f(s_total, 1, dim),
            f(s_total, 1, dim), f(s_total, 1),
            torch.zeros(s_total // cf.BS + 1, dtype=torch.int32,
                        device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta")]


@pytest.mark.parametrize("wrapper", ["flood_min", "flood_min_stats"])
@pytest.mark.parametrize(
    "bad,error",
    [("float64", TypeError), ("int64", TypeError),
     ("dim0", ValueError), ("rows", ValueError),
     ("witnesses", ValueError)],
)
def test_flood_wrappers_share_one_operand_check(monkeypatch, wrapper, bad,
                                                error):
    """K1's and K3's wrappers reject what the kernels do not take, through
    the one ``_check_flood_operands``, before any kernel is loaded."""
    from flooder_tpu_torch.ops import cuda_flood_stats as cfs

    def no_kernel():
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(cf, "_lib", no_kernel)
    monkeypatch.setattr(cfs, "_lib", no_kernel)
    ops = _meta_operands(dim=0 if bad == "dim0" else 3,
                         s_total=12 if bad == "rows" else 8)
    if bad == "float64":
        ops[0] = ops[0].double()
    elif bad == "int64":
        ops[-1] = ops[-1].long()
    elif bad == "witnesses":
        ops[1] = ops[1][:2000]  # not whole chunks
    fn = cf.flood_min if wrapper == "flood_min" else cfs.flood_min_stats
    with pytest.raises(error):
        fn(*ops)


def test_operand_check_wants_aligned_witnesses():
    ops = [torch.zeros_like(t, device="cpu") for t in _meta_operands()]
    s_total, nr, rt, dim, n_blk = cf._check_flood_operands(ops, "k")
    assert (s_total, nr, rt, dim, n_blk) == (8, 1, 128, 3, 1)
    storage = torch.zeros(2048 * 3 + 1)
    ops[1] = storage[1:].reshape(2048, 3)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        cf._check_flood_operands(ops, "k")


@pytest.mark.parametrize("dim", [5, 8, 9, 16, 64])
def test_operand_check_takes_5_to_8_coordinates(dim):
    """K1's and K3's operand check passes 5-8 coordinates (template
    instances) and 9, 16 and 64 (the runtime-width instance), and rejects
    a cloud without coordinates."""
    ops = [torch.zeros_like(t, device="cpu") for t in _meta_operands(dim)]
    assert cf._check_flood_operands(ops, "k")[3] == dim
    ops = [torch.zeros_like(t, device="cpu") for t in _meta_operands(0)]
    with pytest.raises(ValueError, match="at least one coordinate"):
        cf._check_flood_operands(ops, "k")


def test_ptxas_names_every_kernel_instance():
    """The build's ptxas parser names each instance with its template
    arguments, K2's scalar type included, and the runtime-width ones."""
    from flooder_tpu_torch.native.build import kernel_instance, ptxas_kernels

    names = {
        "_ZN40_GLOBAL__N__8_flood_cu_113flood_min_fewILi8EEEvPKf": (
            "flood_min_few<8>"),
        "_ZN40_GLOBAL__N__8_flood_stats_cu_118flood_stats_kernelILi5EEEvPKf":
            "flood_stats_kernel<5>",
        "_ZN12_GLOBAL__N_18fps_loopIdLi3EEEvNS_7FpsArgsIT_EE": (
            "fps_loop<double,3>"),
        "_ZN12_GLOBAL__N_18fps_loopIfLi8EEEvNS_7FpsArgsIT_EE": (
            "fps_loop<float,8>"),
        "other_kernel": "other_kernel",
        # the runtime-width instances
        "_ZN12_GLOBAL__N_18fps_loopIdLi0EEEvNS_7FpsArgsIT_EE": (
            "fps_loop<double,wide>"),
        "_ZN40_GLOBAL__N__8_flood_cu_114flood_min_wideEPKfS1_S1_S1_": (
            "flood_min_wide"),
        "_ZN46_GLOBAL__N__8_flood_stats_cu_116flood_stats_wideEPKfS1_": (
            "flood_stats_wide"),
    }
    for mangled, want in names.items():
        assert kernel_instance(mangled) == want
    text = "".join(
        f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
        f"ptxas info    : Used {i + 40} registers, {8 * i} bytes spill "
        f"stores, 272 bytes smem\n"
        for i, m in enumerate(names))
    rows = ptxas_kernels(text)
    assert [r[0] for r in rows] == list(names.values())
    assert rows[2] == ("fps_loop<double,3>", 42, 16, 272)
