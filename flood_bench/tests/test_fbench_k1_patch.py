"""``k1_patch_pct``: K1's sample slots in 128-sample patches, in percent of
all it ran, read from the program's ``k1_patch_samples`` and
``k1_samples`` counters."""

import sys
import types

import pytest

from fbench import cell, layout

NAME = "k1_patch_pct"


def _with_records(monkeypatch, recs):
    fake = types.ModuleType("stagetimer")
    fake.records = lambda: recs
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        fake)


def test_the_reader_sums_the_profiled_records(tiny_bench, monkeypatch):
    _, bench_dir = tiny_bench
    _with_records(monkeypatch, [
        {"mode": "profiler", "counters": {"k1_samples": 999,
                                          "k1_patch_samples": 0}},
        {"mode": "profiler", "counters": {"k1_samples": 300,
                                          "k1_patch_samples": 100}},
        {"mode": "off", "counters": {"k1_samples": 50}},
        {"mode": "profiler", "counters": {"k1_samples": 100,
                                          "k1_patch_samples": 100}}])
    read = layout.load_reader(NAME, bench_dir)
    assert read({"n_profiled": 2}) == pytest.approx(50.0)


def test_without_the_counters_the_reader_reports_nothing(tiny_bench,
                                                         monkeypatch):
    _, bench_dir = tiny_bench
    read = layout.load_reader(NAME, bench_dir)
    _with_records(monkeypatch, [{"mode": "profiler",
                                 "counters": {"k1_inball_pairs": 5}}])
    assert read({"n_profiled": 1}) is None
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        types.ModuleType("stagetimer"))
    assert read({"n_profiled": 1}) is None


def test_a_traced_tiny_run_reads_every_slot_in_patches(tiny_bench):
    root, bench_dir = tiny_bench
    res = cell.run_cell(root, "tiny-cheese-grid", 2147483999, 0.5, True,
                        device="cpu", bench_dir=bench_dir)
    assert res["metrics"][NAME]["value"] == pytest.approx(100.0)
    assert res["correct"]
