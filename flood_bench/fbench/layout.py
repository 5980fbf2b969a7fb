"""Find a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``traffic/<name>.json`` and a per-layer metric's reader is
``metrics/<name>.py`` (a function ``read(ctx)``), both in the benchmark's
folder. A later cell, mix or metric is a new file and a new entry, never
an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(root: Path, bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            with open(Path(root) / cfg["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str, end_to_end: Dict[str, dict]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moved = end_to_end.get(metric["moves"], {})
    return "workloads" not in moved or workload in moved["workloads"]


def end_to_end_metrics(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_metrics(bench: dict, workload: str) -> List[dict]:
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return [m for m in bench["per_layer"] if _reports(m, workload, e2e)]


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
