"""``flooder_tpu_torch.utils.timing`` on the CPU: the reference's stats
fields, the wall time, the device fields on the CPU, psutil made absent,
and the Chrome trace that ``trace_dir`` writes. The CUDA case (fence and
per-step peak) is in tests/test_torch_cuda.py."""

import dataclasses
import json
import time

import pytest
import torch

from flooder_tpu.utils.timing import StepStats as JaxStepStats
from flooder_tpu_torch.utils import StepStats, StepTimer
from flooder_tpu_torch.utils import timing


def test_step_stats_fields_match_reference():
    names = [f.name for f in dataclasses.fields(StepStats)]
    assert names == [f.name for f in dataclasses.fields(JaxStepStats)]
    assert names == ["name", "wall_s", "cpu_s", "ram_delta_mib",
                     "device_peak_mib", "device_kind"]


@pytest.mark.parametrize("device,kind", [(torch.device("cpu"), "cpu"),
                                         ("cpu", "cpu"), (None, None)],
                         ids=["torch-device", "string", "none"])
def test_cpu_step(device, kind):
    with StepTimer("sleep", device) as t:
        time.sleep(0.05)
    s = t.stats
    assert s.name == "sleep"
    assert 0.05 <= s.wall_s < 5.0
    assert 0.0 <= s.cpu_s < s.wall_s
    assert s.device_peak_mib is None
    assert s.device_kind == kind
    assert s.ram_delta_mib is not None  # psutil is installed here


def test_without_psutil(monkeypatch):
    monkeypatch.setattr(timing, "psutil", None)
    with StepTimer("step", torch.device("cpu")) as t:
        torch.ones(1000).sum()
    assert t.stats.ram_delta_mib is None
    assert t.stats.wall_s >= 0.0


def test_trace_dir_writes_chrome_trace(tmp_path):
    trace_dir = tmp_path / "a" / "b"  # created on exit
    with StepTimer("Flood complex", torch.device("cpu"),
                   trace_dir=str(trace_dir)) as t:
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    (path,) = trace_dir.glob("*.json")
    assert path.name.startswith("Flood_complex.")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "Flood complex"
             and e.get("cat") == "user_annotation"]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    assert any(e.get("name") == "aten::mm" for e in events)
    assert t.stats.device_kind == "cpu"


def test_exception_propagates_and_trace_stops(tmp_path):
    with pytest.raises(ValueError, match="boom"):
        with StepTimer("failing", "cpu", trace_dir=str(tmp_path)):
            raise ValueError("boom")
    # the profiler was stopped: a second traced step works
    with StepTimer("after", "cpu", trace_dir=str(tmp_path)):
        torch.ones(3).sum()
    assert len(list(tmp_path.glob("*.json"))) == 2
