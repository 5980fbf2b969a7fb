"""The command's contract: the result line's keys, no result without the
chips, and no run beside JAX or the JAX package."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from fbench import cell
from fbench.guard import forbidden_modules

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_the_result_has_the_contract_keys_and_the_checks_last(tiny_bench):
    root, bench_dir = tiny_bench
    res = cell.run_cell(root, "tiny-eight-grid", 12345, 0.5, False,
                        device="cpu", bench_dir=bench_dir)
    assert list(res) == CONTRACT_KEYS + ["checks"]
    assert set(res["metrics"]) == {"clouds_per_s", "peak_mem_gib", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    traced = cell.run_cell(root, "tiny-eight-grid", 12345, 0.5, True,
                           device="cpu", bench_dir=bench_dir)
    assert list(traced) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    json.dumps(res), json.dumps(traced)


def test_no_result_without_a_chip():
    try:
        import torch
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
    except ImportError:
        pass
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "cheese3d-10M-L1k-grid", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["flooder_tpu_torch", "flooder_tpu_torch.core",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["flooder_tpu.core", "jax.numpy", "flax"]) == [
        "flax", "flooder_tpu", "jax"]
    assert forbidden_modules() == [], "the benchmark's tests load JAX"


def test_run_refuses_when_jax_is_loaded(monkeypatch, capsys):
    import types
    import run  # flood_bench/run.py

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "cheese3d-10M-L1k-grid", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out == ""


def test_the_reference_and_harness_import_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; "
            "import fbench.reference, fbench.compare, fbench.control, "
            "fbench.cell, fbench.trace; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('flooder_tpu_torch', 'flooder_tpu', 'jax')]; print(bad)"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
