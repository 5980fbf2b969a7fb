"""The port's CLI (``python -m flooder_tpu_torch.cli``) on the CPU.

The cases of tests/test_cli.py for the port, the port CLI held against
``flooder_tpu.cli`` on the same seeded cloud (grid and random mode), a run
with ``jax``, ``rich``, ``psutil``, ``yaml`` and ``tqdm`` made unimportable
(the packages the GPU machine lacks), and the default device without
CUDA.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import flooder_tpu.cli as jax_cli
from flooder_tpu.topology import bottleneck_distance
import flooder_tpu_torch.cli as torch_cli
from flooder_tpu_torch.cli import (
    device_type,
    effective_max_dim,
    load_point_cloud,
    resolve_simplex_representation,
)

REPO = Path(__file__).resolve().parents[1]
STEPS = ["Loading", "Flood complex", "Persistence"]


def run_port_cli(args, env=None, prelude=""):
    """Run the port CLI in a subprocess; ``prelude`` is Python run first
    (to make modules unimportable)."""
    code = (
        f"{prelude}\nimport runpy, sys\n"
        f"sys.argv = ['flooder'] + {list(map(str, args))!r}\n"
        "runpy.run_module('flooder_tpu_torch.cli', run_name='__main__')\n"
    )
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, **(env or {})},
    )


def test_device_type_validation():
    assert device_type("cpu") == "cpu"
    assert device_type("cuda") == "cuda"
    assert device_type("cuda:0") == "cuda:0"
    assert device_type("cpu:0") == "cpu:0"
    for bad in ("tpu", "tpu:0"):
        with pytest.raises(argparse.ArgumentTypeError, match="cuda"):
            device_type(bad)
    with pytest.raises(argparse.ArgumentTypeError):
        device_type("gpu7")


def test_effective_max_dim():
    assert effective_max_dim(None, 3) == 3
    assert effective_max_dim(2, 3) == 2
    with pytest.raises(ValueError):
        effective_max_dim(0, 3)
    with pytest.raises(ValueError):
        effective_max_dim(4, 3)


def test_resolve_simplex_representation():
    assert resolve_simplex_representation(None, None) == (30, None)
    assert resolve_simplex_representation(10, None) == (10, None)
    assert resolve_simplex_representation(None, 99) == (None, 99)


def test_load_point_cloud(tmp_path):
    p = tmp_path / "cloud.npy"
    np.save(p, np.random.default_rng(0).random((100, 3)))
    arr, n, d = load_point_cloud(p)
    assert (n, d) == (100, 3) and arr.dtype == np.float32
    with pytest.raises(FileNotFoundError):
        load_point_cloud(tmp_path / "missing.npy")
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        load_point_cloud(bad)


def _circle(path):
    rng = np.random.default_rng(42)
    theta = rng.uniform(0, 2 * np.pi, 600)
    pts = np.stack([np.cos(theta), np.sin(theta)], 1)
    pts += rng.normal(0, 0.05, pts.shape)
    np.save(path, pts.astype(np.float32))


def test_cli_end_to_end(tmp_path):
    cloud = tmp_path / "cloud.npy"
    _circle(cloud)
    out = tmp_path / "out.pkl"
    stats = tmp_path / "stats.json"
    res = subprocess.run(
        [
            sys.executable, "-m", "flooder_tpu_torch.cli",
            "--input-file", str(cloud),
            "--output-file", str(out),
            "--stats-json", str(stats),
            "--num-landmarks", "100",
            "--points-per-edge", "8",
            "--device", "cpu",
            "--batch-size", "32",
        ],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    payload = pickle.loads(out.read_bytes())
    assert set(payload) == {"diagrams", "meta"}
    assert len(payload["diagrams"]) == 2
    # the circle should show one dominant H1 bar
    d1 = payload["diagrams"][1]
    pers = d1[:, 1] - d1[:, 0]
    assert (pers > 0.3).sum() == 1
    meta = payload["meta"]
    assert meta["n_points"] == 600 and meta["device"] == "cpu"
    assert meta["use_pallas"] is False  # the CPU runs the dense engine
    steps = json.loads(stats.read_text())
    assert [s["name"] for s in steps] == STEPS
    # the reference's stats keys
    assert set(steps[0]) == {
        f.name for f in jax_cli.StepStats.__dataclass_fields__.values()
    }
    assert all(s["device_kind"] == "cpu" and s["device_peak_mib"] is None
               for s in steps)


def test_cli_trace_dir(tmp_path):
    """--trace-dir wraps the Flood step in a torch.profiler trace and
    leaves a Chrome trace holding the step's span."""
    cloud = tmp_path / "cloud.npy"
    rng = np.random.default_rng(0)
    np.save(cloud, rng.uniform(size=(400, 2)).astype(np.float32))
    trace = tmp_path / "trace" / "nested"
    res = subprocess.run(
        [
            sys.executable, "-m", "flooder_tpu_torch.cli",
            "--input-file", str(cloud),
            "--num-landmarks", "32",
            "--points-per-edge", "4",
            "--device", "cpu",
            "--trace-dir", str(trace),
        ],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert trace.is_dir() and any(trace.rglob("*"))
    (path,) = trace.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "Flood complex"
               and e.get("cat") == "user_annotation" for e in events)


def _long_bars(d, tol):
    """Bars longer than ``tol``, sorted by birth, then death."""
    d = np.asarray(d, dtype=np.float64).reshape(-1, 2)
    d = d[d[:, 1] - d[:, 0] > tol]
    return d[np.lexsort((d[:, 1], d[:, 0]))]


def assert_same_diagrams(a, b, tol):
    """Per dimension: bottleneck distance within ``tol``, and the same bars
    longer than ``tol`` (births and deaths within ``tol`` after sorting,
    inf in the same places). Bars of a few float32 ulps appear in one
    package and not the other where their filtration values differ in the
    last ulp (both within the 1e-5 bar), so they are held by the
    bottleneck distance only."""
    assert len(a) == len(b)
    for dim, (da, db) in enumerate(zip(a, b)):
        assert bottleneck_distance(da, db) < tol, dim
        da, db = _long_bars(da, tol), _long_bars(db, tol)
        assert da.shape == db.shape, (dim, da.shape, db.shape)
        inf_a, inf_b = np.isinf(da), np.isinf(db)
        assert (inf_a == inf_b).all(), dim
        np.testing.assert_allclose(da[~inf_a], db[~inf_b], rtol=0, atol=tol)


@pytest.mark.parametrize(
    "mode", [["--points-per-edge", "8"],
             ["--num-rand", "20", "--seed", "3"]],
    ids=["grid-ppe8", "random-20-seed3"],
)
def test_cli_matches_jax_cli(tmp_path, monkeypatch, mode):
    """Both CLIs in this process, on the same seeded 3-D cloud, on the CPU
    (dense engine in both): the same diagrams within 1e-5."""
    cloud = tmp_path / "cloud.npy"
    rng = np.random.default_rng(11)
    np.save(cloud, rng.random((300, 3)).astype(np.float32))
    payloads = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        out = tmp_path / f"{name}.pkl"
        monkeypatch.setattr(sys, "argv", [
            "flooder", "--input-file", str(cloud), "--output-file", str(out),
            "--num-landmarks", "24", "--device", "cpu", *mode,
        ])
        cli.main()
        payloads[name] = pickle.loads(out.read_bytes())
    ref, got = payloads["jax"], payloads["torch"]
    assert len(got["diagrams"]) == 3
    assert sum(len(d) for d in got["diagrams"]) > 24
    assert_same_diagrams(ref["diagrams"], got["diagrams"], 1e-5)
    skip = {"device", "output_file"}
    assert {k: v for k, v in ref["meta"].items() if k not in skip} == {
        k: v for k, v in got["meta"].items() if k not in skip}


def test_cli_without_optional_packages(tmp_path):
    """The GPU machine's path: no jax, rich, psutil, yaml or tqdm. The CLI
    takes the plain console, and the RAM column is empty."""
    cloud = tmp_path / "cloud.npy"
    _circle(cloud)
    stats = tmp_path / "stats.json"
    blocked = ("jax", "flooder_tpu", "rich", "psutil", "yaml", "tqdm")
    res = run_port_cli(
        ["--input-file", cloud, "--num-landmarks", "50",
         "--points-per-edge", "6", "--device", "cpu", "--stats-json", stats],
        prelude="import sys\n" + "".join(
            f"sys.modules[{m!r}] = None\n" for m in blocked),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Flood complex: wall=" in res.stdout
    steps = json.loads(stats.read_text())
    assert [s["name"] for s in steps] == STEPS
    assert all(s["ram_delta_mib"] is None for s in steps)


def test_default_device_without_cuda_fails(tmp_path):
    """No --device means cuda; without it the CLI exits non-zero and says
    to pass --device cpu (nothing falls back to the CPU)."""
    cloud = tmp_path / "cloud.npy"
    _circle(cloud)
    out = tmp_path / "out.pkl"
    res = run_port_cli(["--input-file", cloud, "--output-file", out],
                       env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert not out.exists()


def test_cli_loads_no_yaml():
    """The GPU machine has no yaml: neither the package nor the CLI may
    import the datasets module."""
    code = (
        "import sys, flooder_tpu_torch, flooder_tpu_torch.cli\n"
        "assert 'yaml' not in sys.modules\n"
        "assert 'flooder_tpu_torch.datasets' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
