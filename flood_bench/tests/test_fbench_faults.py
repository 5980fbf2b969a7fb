"""Whole runs on the CPU (the look for a chip skipped), sound and with the
program broken underneath: each fault has to turn ``correct`` false.

The faults a stream of clouds can have: K1 returning its accumulator
unchanged (a step that changes nothing), half of the witnesses left out,
an answer altered where it is produced (K1's values, all of them or one
block's, a dropped simplex, another landmark, a diagram pair), all on one
chip (no exchange); in grid mode and in random mode."""

import pytest
import torch

from fbench import cell


def _run(tiny_bench, workload="tiny-cheese-grid", trace=False):
    root, bench_dir = tiny_bench
    return cell.run_cell(root, workload, 2**31 + 77, 0.5, trace,
                         device="cpu", bench_dir=bench_dir)


def _sample_more(tiny_bench, per_dim):
    """Check ``per_dim`` simplices a dimension in the tiny mixes."""
    import json

    _, bench_dir = tiny_bench
    for path in (bench_dir / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["check"]["simplices_per_dim"] = per_dim
        path.write_text(json.dumps(mix))


@pytest.mark.parametrize("workload", ["tiny-cheese-grid", "tiny-eight-grid",
                                      "tiny-cheese-rand"])
def test_a_sound_run_is_correct(tiny_bench, workload):
    res = _run(tiny_bench, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _scale_k1(monkeypatch, factor):
    from flooder_tpu_torch.ops import cuda_flood

    real = cuda_flood.flood_min

    def broken(*a):
        out, stats = real(*a)
        return out * factor, stats

    monkeypatch.setattr(cuda_flood, "flood_min", broken)


def _scale_k1_block(monkeypatch, factor):
    """K1 wrong in one block of simplices of each launch: the first
    sixteenth of its rows."""
    from flooder_tpu_torch.ops import cuda_flood

    real = cuda_flood.flood_min

    def broken(*a):
        out, stats = real(*a)
        out = out.clone()
        rows = max(1, out.shape[0] // 16)
        out[:rows] *= factor
        return out, stats

    monkeypatch.setattr(cuda_flood, "flood_min", broken)


def _k1_unchanged(monkeypatch):
    from flooder_tpu_torch.ops import cuda_flood

    real = cuda_flood.flood_min

    def broken(*a):
        out, stats = real(*a)
        return torch.full_like(out, float("inf")), stats

    monkeypatch.setattr(cuda_flood, "flood_min", broken)


def _half_witnesses(monkeypatch):
    from flooder_tpu_torch.ops import cuda_flood

    real = cuda_flood.CudaFloodEngine.__init__

    def broken(self, points):
        real(self, points[: points.shape[0] // 2])

    monkeypatch.setattr(cuda_flood.CudaFloodEngine, "__init__", broken)


def _drop_cell(monkeypatch):
    from flooder_tpu_torch.topology import delaunay

    real = delaunay.delaunay_cells
    monkeypatch.setattr(delaunay, "delaunay_cells", lambda p: real(p)[:-1])


def _other_landmark(monkeypatch):
    from flooder_tpu_torch import core

    real = core.cuda_farthest_point_sampling

    def broken(points, n, start=0):
        idx = real(points, n, start).clone()
        idx[-1] = (idx[-1] + 1) % points.shape[0]
        return idx

    monkeypatch.setattr(core, "cuda_farthest_point_sampling", broken)


def _diagram_pair(monkeypatch):
    from flooder_tpu_torch.topology.simplex_tree import SimplexTree

    real = SimplexTree.persistence

    def broken(self, *a, **k):
        pairs = real(self, *a, **k)
        dim, (b, d) = pairs[-1]
        return pairs[:-1] + [(dim, (b, d * 1.5 + 1e-3))]

    monkeypatch.setattr(SimplexTree, "persistence", broken)


FAULTS = {
    "k1-unchanged": _k1_unchanged,
    "k1-values-altered": lambda mp: _scale_k1(mp, 1.1),
    "half-the-witnesses": _half_witnesses,
    "simplex-dropped": _drop_cell,
    "landmark-altered": _other_landmark,
    "diagram-altered": _diagram_pair,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(tiny_bench, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tiny_bench)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["k1-unchanged", "k1-values-altered"])
def test_a_broken_program_in_random_mode_is_not_correct(tiny_bench,
                                                        monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tiny_bench, "tiny-cheese-rand")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["tiny-cheese-grid", "tiny-cheese-rand"])
def test_k1_wrong_in_one_block_is_not_correct(tiny_bench, monkeypatch,
                                              workload):
    _sample_more(tiny_bench, 64)
    _scale_k1_block(monkeypatch, 1.1)
    res = _run(tiny_bench, workload)
    assert not res["correct"], res["checks"]


def test_a_traced_run_reads_its_layers_and_is_correct(tiny_bench):
    res = _run(tiny_bench, trace=True)
    assert res["correct"], res["checks"]
    assert {"delaunay_ms", "engine_init_ms", "persistence_ms"} <= set(res["metrics"])
    assert "k1_ms" not in res["metrics"]  # no device trace on the CPU
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
