"""Discovery by name, and BENCHMARK.json against the benchmark's rules."""

import json
import re

import pytest

from conftest import BENCH, ROOT
from fbench import cell, layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return layout.load_benchmark(ROOT)


def test_every_cell_finds_its_config_traffic_and_readers():
    bench = _bench()
    for w in bench["workloads"]:
        cfg = layout.load_config(ROOT, bench, w["config"])
        assert cfg["name"] == w["config"]
        traffic = cell.check_traffic(layout.load_traffic(w["traffic"]))
        assert traffic["points_per_edge"] >= 2
        metrics = layout.per_layer_metrics(bench, w["name"])
        assert metrics
        for m in metrics:
            assert callable(layout.load_reader(m["name"]))


def test_a_throwaway_config_is_found_in_another_directory(tiny_bench):
    root, bench_dir = tiny_bench
    bench = layout.load_benchmark(root)
    w = layout.find_cell(bench, "tiny-cheese-grid")
    cfg = layout.load_config(root, bench, w["config"])
    assert cfg["n_points"] == 3000 and cfg["generator"] == "swiss_cheese"
    assert layout.load_traffic(w["traffic"], bench_dir)["points_per_edge"] == 8
    (bench_dir / "metrics" / "made_up.py").write_text("def read(ctx):\n    return 7.0\n")
    assert layout.load_reader("made_up", bench_dir)({}) == 7.0
    with pytest.raises(KeyError):
        layout.find_cell(bench, "no-such-cell")


GRID = {"loop": "closed", "clients": 1, "clouds": "distinct",
        "mode": "grid", "points_per_edge": 30}


@pytest.mark.parametrize("change", [
    {"mode": "sobol"}, {"loop": "open"}, {"clients": 4},
    {"clouds": "repeated"}, {"points_per_edge": 0}, {"mode": "random"}])
def test_a_mix_the_harness_does_not_drive_is_refused(change):
    assert cell.check_traffic(dict(GRID)) == GRID
    assert cell.check_traffic(dict(GRID, mode="random", num_rand=256))
    with pytest.raises(ValueError):
        cell.check_traffic(dict(GRID, **change))


def test_the_mode_chooses_the_sampling_and_random_mode_seeds_per_cloud():
    cfg = {"n_landmarks": 10, "max_dimension": 2}
    grid = cell.Stream(cfg, GRID, 5, "cpu")
    assert grid.sampling(1) == {"mode": "grid", "points_per_edge": 30}
    rand = cell.Stream(cfg, dict(GRID, mode="random", num_rand=64), 2**31 + 9,
                       "cpu")
    a, b = rand.sampling(1), rand.sampling(2)
    assert a["mode"] == "random" and a["num_rand"] == 64
    assert a["host_seed"] != b["host_seed"] and a == rand.sampling(1)
    assert 0 <= a["host_seed"] < 2**32


def test_a_metric_without_workloads_follows_the_metric_it_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "m1", "moves": "a"},
                           {"name": "m2", "moves": "b"},
                           {"name": "m3", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in layout.per_layer_metrics(bench, "x")] == ["m1", "m2"]
    assert [m["name"] for m in layout.per_layer_metrics(bench, "y")] == ["m1", "m3"]


def test_benchmark_json_keeps_the_rules():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["flood_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["file"].startswith("flood_bench/") and cfg["reduced"] == []
        assert cfg["name"] in {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
