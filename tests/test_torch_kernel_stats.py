"""The port's kernel-stats path against the reference tool.

- the plain version of K3 (``flood_stats_reference``) against the Pallas
  K3 of ``tools/kernel_stats.py`` in interpret mode, on the same seeded
  operands: d^2 within 1e-6, no-witness entries (>= 1e30) in the same
  places, per-simplex counters exactly equal;
- K3 against K1 on the port's own operands: bit-equal output, and the
  computed tiles equal K1's admitted units;
- the port's tool (``flooder_tpu_torch.tools``) end to end on the CPU;
- K3's launch order, and that the operands of K3's card tests reach the
  kernel's fold and its deferred tile maxima;
- no fallback: without CUDA the default device raises, and a tensor that
  is not on the CPU never reaches the plain version.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flooder_tpu.ops import pallas_flood as pf
from flooder_tpu_torch.ops import cuda_flood as cf
from flooder_tpu_torch.ops import cuda_flood_stats as cfs
from flooder_tpu_torch.tools import kernel_stats as ks_t
from flooder_tpu_torch.tools import scene as scene_mod
from flooder_tpu_torch.tools.scene import build_scene
from test_torch_cuda import K3_CASES, k3_case_operands, k3_paths_reached
from test_torch_flood import _prep_inputs  # seeded flood operands
from tools import kernel_stats as ks_j

# the record keys of the reference tool (tools/kernel_stats.py:369-385)
REFERENCE_KEYS = {
    "points", "landmarks", "cloud", "backend", "num_simplices", "nr", "rt",
    "seg_times_s", "overhead_seg_times_s", "parity_vs_production",
    "visited_pairs", "admitted_subchunks", "computed_tiles",
    "worklist_pairs",
}


def _jax_k3(eng, ws, vl, centers, radii, nr, rt, tight):
    """The TPU tool's K3 in interpret mode over the whole work-list of
    ``_prep_inputs``' case (16,384 witnesses in 8 chunks, 8 blocks, some
    zero-radius rows), or of another case of the same form at any width,
    as one segment (no padding). Returns (numpy
    operands in the TPU layout, the sorted pair list, out, stats)."""
    samples, tlo, thi, ub2, (active, dist) = pf._prep(
        jnp.asarray(vl), jnp.asarray(ws), jnp.asarray(centers),
        jnp.asarray(radii), jnp.asarray(eng.chunk_lo.numpy()),
        jnp.asarray(eng.chunk_hi.numpy()), bs=cf.BS, nr=nr, rt=rt,
        tight=tight, wchunk=cf.WCHUNK, pack="f32",
    )
    active, dist = np.asarray(active), np.asarray(dist)
    # the work-list as run_with_stats sorts it (kernel_stats.py:219-223)
    ps, pc = np.nonzero(active)
    order = np.lexsort((dist[ps, pc], ps))
    ps, pc = ps[order].astype(np.int32), pc[order].astype(np.int32)
    first = np.concatenate([[1], ps[1:] != ps[:-1]]).astype(np.int32)
    wit = np.ascontiguousarray(eng.witnesses.numpy().T)  # (dim, W)
    s_total = len(centers)
    with pf._x32_mode():
        out, stats = ks_j._flood_pairs_call_stats(
            jnp.asarray(ps), jnp.asarray(pc), jnp.asarray(first), samples,
            jnp.asarray(wit), jnp.asarray(centers),
            jnp.asarray(radii[:, None]), tlo, thi, ub2,
            jnp.full((s_total, nr, rt), jnp.inf, jnp.float32),
            jnp.zeros((s_total, 128), jnp.int32),
            bs=cf.BS, dim=vl.shape[-1], nsub=cf.WCHUNK // cf.SUB,
            sub=cf.SUB,
            interpret=True,
        )
        out, stats = np.asarray(out), np.asarray(stats)
    tpu_ops = (np.asarray(samples), wit, centers, radii[:, None],
               np.asarray(tlo), np.asarray(thi), np.asarray(ub2))
    return tpu_ops, ps, pc, out, stats


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("r_count", [40, 600])
def test_plain_k3_matches_pallas_k3_interpret(tight, r_count):
    case = _prep_inputs(r_count=r_count)
    tpu_ops, ps, pc, out_j, st_j = _jax_k3(*case, tight=tight)
    ops = cfs.operands_from_jax(ps, pc, *tpu_ops, device="cpu")
    out_t, st_t = cfs.flood_stats_reference(*ops)
    out_t, st_t = out_t.numpy(), st_t.numpy()

    masked_j, masked_t = out_j >= 1e30, out_t >= 1e30
    np.testing.assert_array_equal(masked_t, masked_j)
    assert (~masked_j).any()
    assert np.abs(out_t[~masked_t] - out_j[~masked_j]).max() <= 1e-6

    np.testing.assert_array_equal(st_t[:, cfs.COL_SUBCHUNKS],
                                  st_j[:, ks_j.COL_SUBCHUNKS])
    np.testing.assert_array_equal(st_t[:, cfs.COL_TILES],
                                  st_j[:, ks_j.COL_TILES])
    # real pairs only: one segment without padding, so the TPU count (on
    # row 0 of each block) is the block's pair count too
    per_block = np.bincount(ps, minlength=len(st_t) // cf.BS)
    np.testing.assert_array_equal(st_t[:, cfs.COL_PAIRS],
                                  np.repeat(per_block, cf.BS))
    np.testing.assert_array_equal(st_j[:: cf.BS, ks_j.COL_PAIRS], per_block)

    # the bounds admit some work and skip some
    nr = case[5]
    units = st_t[:, cfs.COL_SUBCHUNKS].sum()
    tiles = st_t[:, cfs.COL_TILES].sum()
    assert 0 < units < len(ps) * cf.BS * (cf.WCHUNK // cf.SUB)
    assert 0 < tiles < units * nr


@pytest.mark.parametrize("tight", [True, False])
def test_k3_equals_k1_on_port_operands(tight):
    """K3 computes the tiles of the walk in one pass, K1 walks each list
    twice (its seed pass first) and admits a subset of them: bit-equal
    output, and in every block K1's admitted (simplex, tile, sub-chunk)
    units are no more than K3's computed tiles."""
    eng, ws, vl, centers, radii, nr, rt = _prep_inputs(r_count=600)
    samples, tlo, thi, ub2, active, dist = cf._prep(
        torch.from_numpy(vl), torch.from_numpy(ws.copy()),
        torch.from_numpy(centers), torch.from_numpy(radii), eng.chunk_lo,
        eng.chunk_hi, bs=cf.BS, nr=nr, rt=rt, tight=tight,
    )
    ops = (samples, eng.witnesses, eng.sub_lo, eng.sub_hi,
           torch.from_numpy(centers), torch.from_numpy(radii), tlo, thi,
           ub2, *cf._worklist(active, dist))
    out3, st3 = cfs.flood_min_stats(*ops)
    out1, st1 = cf.flood_pairs_reference(*ops)
    assert torch.equal(out3, out1)
    tiles = st3[:, cfs.COL_TILES].reshape(-1, cf.BS).sum(1)
    units = st1[:, 0].reshape(tiles.numel(), nr).sum(1)
    assert (units <= tiles).all()
    assert int(tiles.sum()) >= cf.kernel_operations(st1)[0] > 0
    assert int(st3[:: cf.BS, cfs.COL_PAIRS].sum()) == ops[-1].numel()


@pytest.mark.parametrize("cloud,dim", [("cheese3d", 3), ("eight2d", 2)])
def test_tool_end_to_end_on_cpu(cloud, dim):
    scene = build_scene(2000, 40, cloud=cloud, device="cpu")
    assert scene.dim == dim and scene.operands[0].shape[-1] == dim
    seg_times, counters, parity = ks_t.run_with_stats(scene)
    assert parity
    assert len(seg_times) == 1
    assert counters["visited_pairs"] == counters["worklist_pairs"] > 0
    assert counters["admitted_subchunks"] > 0
    assert counters["computed_tiles"] >= counters["production_units"] > 0


def test_block_slice_gives_the_blocks_rows():
    """K3 on a slice of whole blocks (blk_ptr rebased) gives exactly those
    blocks' rows of the run on the whole tuple, counters included."""
    ops = build_scene(2000, 40, device="cpu").operands
    out, stats = cfs.flood_stats_reference(*ops)
    lens = (ops[-2][1:] - ops[-2][:-1]).numpy()
    blocks = [len(lens) - 1, len(lens) // 2, int(lens.argmax())]
    assert len(set(blocks)) == 3 and lens[blocks].sum() > 0
    sliced, rows = scene_mod.block_slice(ops, blocks)
    assert sliced[-1].numel() == lens[blocks].sum()
    out_s, stats_s = cfs.flood_stats_reference(*sliced)
    assert torch.equal(out_s, out[rows])
    assert torch.equal(stats_s, stats[rows])


@pytest.mark.parametrize(
    "lens",
    [np.random.default_rng(5).integers(0, 6, 50), np.full(9, 4), [3]],
    ids=["ties", "all-equal", "one-block"],
)
def test_simplex_order_runs_longest_worklist_first(lens):
    """K3's launch order: a permutation of the simplex rows that takes the
    blocks by decreasing work-list length, ties by block index, with the BS
    simplices of a block together and in row order."""
    lens = np.asarray(lens, dtype=np.int64)
    blk_ptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32)
    order = cfs._simplex_order(blk_ptr)
    assert order.dtype == torch.int32
    o = order.numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(len(lens) * cf.BS))
    blocks = o.reshape(-1, cf.BS) // cf.BS
    assert (blocks == blocks[:, :1]).all()  # a block's simplices together
    np.testing.assert_array_equal(o.reshape(-1, cf.BS) % cf.BS,
                                  np.tile(np.arange(cf.BS), (len(lens), 1)))
    np.testing.assert_array_equal(
        blocks[:, 0], sorted(range(len(lens)), key=lambda b: (-lens[b], b))
    )


@pytest.mark.parametrize("case", list(K3_CASES))
def test_card_k3_cases_reach_fold_and_deferred_max(case):
    """The operands of the card's K3 cases (tests/test_torch_cuda.py), built
    here on the CPU, make the plain version compute a unit with no in-ball
    witness (the compacted kernel's fold) and reject a tile by test 3 inside
    an admitted unit (the kernel's deferred tile maxima); the empty block
    visits nothing."""
    ops = k3_case_operands("cpu", **K3_CASES[case])
    out, stats = cfs.flood_stats_reference(*ops)
    assert k3_paths_reached(out, stats) == (True, True)
    lens = (ops[9][1:] - ops[9][:-1]).numpy()
    assert (lens[-1] == 0) == (case == "empty-block")
    assert out.shape[1] == -(-K3_CASES[case]["r_count"] // cf.FEW_RT)


def test_main_prints_one_record(capsys, tmp_path):
    path = tmp_path / "kstats.json"
    rc = ks_t.main(["--device", "cpu", "--points", "2000", "--landmarks",
                    "40", "--cloud", "eight2d", "--overhead",
                    "--out", str(path)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert REFERENCE_KEYS <= set(rec)
    assert rec["backend"] == "cpu" and rec["timer"] == "host_clock"
    assert rec["parity_vs_production"] is True
    assert len(rec["overhead_seg_times_s"]) == 1
    assert json.loads(path.read_text()) == rec


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scene(2000, 40)
    with pytest.raises(RuntimeError, match="CUDA"):
        ks_t.main(["--points", "2000", "--landmarks", "40"])
    z = np.zeros((8, 1, 3, 128), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cfs.operands_from_jax(
            [0], [0], z, np.zeros((3, 2048), np.float32),
            np.zeros((8, 3), np.float32), np.zeros((8, 1), np.float32),
            z[:, :, :, 0], z[:, :, :, 0], np.zeros((8, 1, 1), np.float32),
        )


def test_non_cpu_tensors_never_run_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises; it never falls
    back to the plain version."""
    def no_plain(*a):
        raise AssertionError("the plain version ran")

    def no_kernel():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(cfs, "flood_stats_reference", no_plain)
    monkeypatch.setattr(cfs, "_lib", no_kernel)
    f = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    i = lambda n: torch.zeros(n, dtype=torch.int32, device="meta")  # noqa
    ops = (f(8, 1, 128, 3), f(2048, 3), f(4, 3), f(4, 3), f(8, 3), f(8),
           f(8, 1, 3), f(8, 1, 3), f(8, 1), i(2), i(1))
    with pytest.raises(RuntimeError, match="no kernel library"):
        cfs.flood_min_stats(*ops)
