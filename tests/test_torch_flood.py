"""The port's flood engine pieces against flooder_tpu.ops.pallas_flood:
witness order, curve orders, bounding balls, operand preparation, the
work-list, the epilogues, and the plain version of kernel K1 against the
Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flooder_tpu as fj
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
