"""The port's examples (flooder_tpu_torch/examples) on the CPU.

Each example's ``main`` runs in process with ``--device cpu`` and must
print its results; example 04 runs beside the reference's
examples/example_04_featurization.py at the same seeds and size, and the
numbers both print must agree.
"""

import importlib
import importlib.util
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EX04_SIZE = ["--small", "--num-points", "3000", "--per-class", "3",
             "--landmarks", "60"]


def _main(name):
    return importlib.import_module(
        f"flooder_tpu_torch.examples.{name}").main


@pytest.mark.parametrize(
    "name,args,expect",
    [
        ("example_01_cheese_3d", ["--small"],
         r"n_pts\s+method\s+Complex Time \(s\)\s+PH Time \(s\)"),
        ("example_02_torus_3d", ["--small", "--reps", "1"],
         r"n_pts\s+method\s+FPS Time \(s\)\s+Complex Time \(s\)"),
        ("example_03_figure_eight_2d", ["--small", "--points", "20000"],
         r"10 longest bars \(sorted by lifetime\) in dimension 1"),
        ("example_04_featurization", EX04_SIZE,
         r"nearest-centroid void-count accuracy: [01]\.\d\d"),
    ],
)
def test_example_runs_on_cpu(capsys, name, args, expect):
    _main(name)(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(expect, out), out
    if name == "example_01_cheese_3d":
        rows = re.findall(r"^\s*(\d+)\s+(Alpha|Flood)\s", out, flags=re.M)
        assert sorted(rows) == sorted(
            (n, m) for n in ("2000", "5000") for m in ("Alpha", "Flood"))
    if name == "example_03_figure_eight_2d":
        for part in out.split("10 longest bars")[1:]:
            bars = [float(b) for b in re.findall(r"lifetime=([0-9.]+)", part)]
            assert 1 <= len(bars) <= 10 and bars == sorted(bars, reverse=True)


@pytest.mark.parametrize(
    "name",
    ["example_01_cheese_3d", "example_02_torus_3d",
     "example_03_figure_eight_2d", "example_04_featurization"],
)
def test_example_default_device_needs_cuda(monkeypatch, name):
    """Without ``--device`` the examples ask for ``cuda``; without CUDA
    they raise and name ``--device cpu``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _main(name)(["--small"])


def _ex04_h2_counts(out):
    """The H2 bar count printed per cloud, keyed by (k, rep)."""
    return {(k, rep): int(n) for k, rep, n in re.findall(
        r"cloud k=(\d+) rep=(\d+): H2 bars > 0\.05: (\d+)", out)}


def test_example_04_matches_reference(capsys, monkeypatch):
    """Same seeds, same sizes: the per-cloud H2 bar counts printed by the
    port equal the reference's. The cloud of seed 0 (k=2, rep 0) is left
    out: the swiss-cheese generator of both packages treats seed 0 as no
    seed (``if seed``), so that cloud differs from run to run, and with
    it the accuracy."""
    spec = importlib.util.spec_from_file_location(
        "reference_example_04", REPO / "examples/example_04_featurization.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["example_04"] + EX04_SIZE)
    ref.main()
    want = _ex04_h2_counts(capsys.readouterr().out)
    _main("example_04_featurization")(EX04_SIZE + ["--device", "cpu"])
    got = _ex04_h2_counts(capsys.readouterr().out)
    assert len(got) == len(want) == 6
    del got["2", "0"], want["2", "0"]
    assert got == want
