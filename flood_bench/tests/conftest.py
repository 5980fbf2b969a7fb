"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repository's root on the import path, and a tiny throwaway benchmark
(one cheese and one figure-eight configuration, a coarse grid, and the
cheese in random mode) that a run drives on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

TINY = {"cheese": ("cheese3d-10M-L1k", 3000, 30),
        "eight": ("eight2d-40M-L2k", 3000, 40)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Hold torch to one thread: the program's plain K1 loops over blocks,
    and several test processes may share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tiny_bench(where: Path) -> Path:
    """A benchmark of two tiny cells under ``where``; returns the folder
    that holds its traffic and metrics (``where/flood_bench``)."""
    bench_dir = where / "flood_bench"
    (bench_dir / "configs").mkdir(parents=True)
    (bench_dir / "traffic").mkdir()
    shutil.copytree(BENCH / "metrics", bench_dir / "metrics")
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, cells = [], []
    for short, (name, n, lms) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg.update(name=f"tiny-{short}", n_points=n, n_landmarks=lms)
        path = bench_dir / "configs" / f"tiny-{short}.json"
        path.write_text(json.dumps(cfg))
        configs.append({"name": cfg["name"], "source": cfg["source"],
                        "file": f"flood_bench/configs/tiny-{short}.json",
                        "reduced": [], "why": "a test"})
        cells.append({"name": f"tiny-{short}-grid", "config": cfg["name"],
                      "traffic": "tiny-grid8", "chips": 1, "why": "a test"})
    cells.append({"name": "tiny-cheese-rand", "config": "tiny-cheese",
                  "traffic": "tiny-rand16", "chips": 1, "why": "a test"})
    traffic = json.loads((BENCH / "traffic" / "stream-grid30.json").read_text())
    traffic.update(points_per_edge=8,
                   check={"clouds": 2, "simplices_per_dim": 8},
                   trace={"stage_clouds": 1, "profile_clouds": 1})
    (bench_dir / "traffic" / "tiny-grid8.json").write_text(json.dumps(traffic))
    rand = dict(traffic, mode="random", num_rand=16)
    del rand["points_per_edge"]
    (bench_dir / "traffic" / "tiny-rand16.json").write_text(json.dumps(rand))
    per_layer = [dict(m) for m in real["per_layer"]]
    for m in per_layer:
        m["workloads"] = [c["name"] for c in cells]
    bench = dict(real, configs=configs, workloads=cells, per_layer=per_layer)
    (where / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


@pytest.fixture
def tiny_bench(tmp_path):
    return tmp_path, write_tiny_bench(tmp_path)
