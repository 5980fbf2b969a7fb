"""The per-layer metrics read from the program's own record of each call
(``fbench/records.py``), and the idle gaps named by the program's spans."""

import sys
import types

import pytest

from fbench import cell, layout
from fbench.spans import OUTSIDE, UNLINKED, reduce_spans
from fbench.trace import reduce_profile

NEW = ("delaunay_span_ms", "assembly_span_ms", "persistence_span_ms",
       "padding_pct", "k1_inball_gpairs")
# Read from the program's record too; K2's visits only on the card.
CACHE, VISITS = "engine_cache_hit_pct", "k2_chunk_kvisits"


class Event:
    """What ``reduce_profile`` and ``reduce_spans`` read of a profiler
    event."""

    def __init__(self, name, on_device, start, end, corr=0, linked=0):
        self._n, self._d, self._s, self._e = name, on_device, start, end
        self._c, self._l = corr, linked

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_a_gap_inside_a_program_span_is_named_after_it():
    events = [
        Event("cloud", False, 0, 1000), Event("cloud", True, 10, 990),
        Event("flood_min_kernel<3>", True, 10, 400),
        Event("Memcpy DtoH (Device -> Pageable)", True, 400, 410),
        Event("flooder.dim3:assembly", False, 410, 500),
        Event("flooder.persistence", False, 500, 950),
        Event("aten::empty", False, 520, 521),
        Event("fps_loop<float,3>", True, 950, 990),
    ]
    red = reduce_profile(events, (0, 1000))
    assert red["busy_s"] == pytest.approx(440e-9)
    (label, length), *_ = red["idle_gaps"]
    assert label == "flooder.persistence | after Memcpy DtoH (Device -> " \
        "Pageable)"
    assert length == pytest.approx(540e-9)


def test_spans_get_the_host_device_and_idle_time_they_hold():
    events = [
        Event("cloud", False, 0, 1000, corr=1),
        Event("cloud", True, 0, 1000, corr=7001, linked=1),
        Event("flooder.engine-init", False, 10, 100, corr=2),
        Event("aten::sort", False, 20, 30, corr=3),
        Event("flooder.delaunay", False, 100, 300, corr=4),
        Event("flooder.kernel", False, 300, 310, corr=5),
        Event("cudaLaunchKernel", False, 301, 302, corr=5),  # runtime ids
        Event("radix_sort", True, 40, 150, corr=7002, linked=3),
        Event("flood_min_kernel<3>", True, 310, 700, corr=5, linked=5),
        Event("Memcpy DtoH", True, 700, 710, corr=7003, linked=99),
    ]
    red = reduce_spans(events, (0, 1000))
    ns = {k: {n: round(v * 1e9) for n, v in d.items()} for k, d in red.items()}
    assert ns["host_s"] == {"engine-init": 90, "delaunay": 200, "kernel": 10}
    assert ns["device_s"] == {"engine-init": 110, "kernel": 390,
                              UNLINKED: 10}
    assert ns["idle_s"] == {OUTSIDE: 300, "engine-init": 30, "delaunay": 150,
                            "kernel": 10}


def _traced(tiny_bench, workload):
    root, bench_dir = tiny_bench
    return cell.run_cell(root, workload, 2147483999, 0.5, True,
                         device="cpu", bench_dir=bench_dir)


def test_a_traced_tiny_run_reports_the_program_record_metrics(tiny_bench):
    from flooder_tpu_torch.ops.cuda_flood import witness_total

    res = _traced(tiny_bench, "tiny-cheese-grid")
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["padding_pct"] == pytest.approx(
        100.0 * (witness_total(3000) - 3000) / 3000)
    for name in NEW:
        assert got[name] > 0, name
    assert got[CACHE] == 0.0  # every cloud of a stream is a new tensor
    assert VISITS not in got  # the CPU's K2 counts no visits
    assert res["correct"]


def test_the_cache_and_visit_readers_on_given_records(tiny_bench,
                                                      monkeypatch):
    root, bench_dir = tiny_bench
    recs = [{"mode": "off", "counters": {"engine_cache_hit": 1}},
            {"mode": "profiler", "counters": {"k2_chunk_visits": 2_000_000}},
            {"mode": "profiler", "counters": {"engine_cache_hit": 1,
                                              "k2_chunk_visits": 4_000_000}},
            {"mode": "profiler", "counters": {}}]
    fake = types.ModuleType("stagetimer")
    fake.records = lambda: recs
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        fake)
    ctx = {"n_profiled": 3}
    assert layout.load_reader(CACHE, bench_dir)(ctx) == pytest.approx(
        100.0 / 3)
    assert layout.load_reader(VISITS, bench_dir)(ctx) == pytest.approx(3000.0)


def test_without_the_program_records_the_readers_report_nothing(
        tiny_bench, monkeypatch):
    root, bench_dir = tiny_bench
    monkeypatch.setitem(sys.modules, "flooder_tpu_torch.utils.stagetimer",
                        types.ModuleType("stagetimer"))
    ctx = {"n_profiled": 3}
    for name in NEW + (CACHE, VISITS):
        assert layout.load_reader(name, bench_dir)(ctx) is None, name
