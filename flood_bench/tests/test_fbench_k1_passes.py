"""``k1_top_gpairs`` and ``k1_lowdim_gpairs``: K1's in-ball pairs of the
top pass and of the passes below it, read from the program's
``k1_inball_pairs_d<d>`` counters."""

import sys
import types

import pytest

from fbench import cell, layout

TOP, LOW = "k1_top_gpairs", "k1_lowdim_gpairs"
CTX = {"n_profiled": 2, "config": {"max_dimension": 3}}


def _with_records(monkeypatch, recs):
    fake = types.ModuleType("stagetimer")
    fake.records = lambda: recs
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        fake)


def test_the_readers_split_the_profiled_records_by_pass(tiny_bench,
                                                        monkeypatch):
    _, bench_dir = tiny_bench
    _with_records(monkeypatch, [
        {"mode": "profiler", "counters": {"k1_inball_pairs_d3": 7e9}},
        {"mode": "off", "counters": {"k1_inball_pairs_d2": 5e9}},
        {"mode": "profiler", "counters": {
            "k1_inball_pairs_d0": 1e9, "k1_inball_pairs_d1": 2e9,
            "k1_inball_pairs_d2": 3e9, "k1_inball_pairs_d3": 4e9}},
        {"mode": "profiler", "counters": {
            "k1_inball_pairs_d1": 1e9, "k1_inball_pairs_d3": 2e9}}])
    assert layout.load_reader(TOP, bench_dir)(CTX) == pytest.approx(3.0)
    assert layout.load_reader(LOW, bench_dir)(CTX) == pytest.approx(3.5)


def test_without_the_counters_the_readers_report_nothing(tiny_bench,
                                                        monkeypatch):
    _, bench_dir = tiny_bench
    top = layout.load_reader(TOP, bench_dir)
    low = layout.load_reader(LOW, bench_dir)
    _with_records(monkeypatch, [{"mode": "profiler",
                                 "counters": {"k1_inball_pairs": 5}}] * 2)
    assert top(CTX) is None and low(CTX) is None
    _with_records(monkeypatch, [{"mode": "profiler", "counters": {
        "k1_inball_pairs": 5, "k1_inball_pairs_d3": 5}}] * 2)
    assert low(CTX) is None  # grid mode: the top pass alone
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        types.ModuleType("stagetimer"))
    assert top(CTX) is None and low(CTX) is None


def test_a_traced_tiny_random_run_splits_the_pairs_whole(tiny_bench):
    root, bench_dir = tiny_bench
    res = cell.run_cell(root, "tiny-cheese-rand", 2147483999, 0.5, True,
                        device="cpu", bench_dir=bench_dir)
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert got[TOP] > 0 and got[LOW] > 0
    assert got[TOP] + got[LOW] == pytest.approx(got["k1_inball_gpairs"],
                                                rel=1e-12)
    assert res["correct"]
