"""Step-level profiling, the counterpart of ``flooder_tpu.utils.timing``.

Each pipeline step records wall clock, process CPU time, the RSS delta
(psutil, optional) and the device's peak memory. On a CUDA device the
step is fenced with ``torch.cuda.synchronize`` on entry and on exit, so
the wall time covers its device work, and the peak is the step's own
(``reset_peak_memory_stats`` on entry, ``max_memory_allocated`` on exit).
``trace_dir`` wraps the step in ``torch.profiler`` (CPU activity, plus
CUDA on a CUDA device) under a ``record_function`` span named after the
step, and writes a Chrome trace JSON file into that directory.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Optional, Union

import torch

try:
    import psutil
except Exception:  # pragma: no cover - psutil is optional
    psutil = None


@dataclass
class StepStats:
    name: str
    wall_s: float
    cpu_s: float
    ram_delta_mib: Optional[float]
    device_peak_mib: Optional[float]
    device_kind: Optional[str]


def _trace_file_name(step: str) -> str:
    """File name of a step's Chrome trace: the step's name as a slug, the
    process id and a nanosecond stamp, so repeated steps never collide."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", step).strip("_") or "step"
    return f"{slug}.{os.getpid()}.{time.time_ns()}.pt.trace.json"


class StepTimer:
    """Context manager timing one pipeline step.

    Args:
        name: Step label (also the name of the step's span in a trace).
        device: torch.device (or device string) whose memory to track;
            None => no device stats.
        trace_dir: if set, wraps the step in a ``torch.profiler`` trace
            written there as a Chrome trace JSON file.
    """

    def __init__(
        self,
        name: str,
        device: Union[None, str, torch.device] = None,
        trace_dir: Optional[str] = None,
    ):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.trace_dir = trace_dir
        self._proc = psutil.Process(os.getpid()) if psutil else None
        self._ram_before = None
        self._prof = None
        self._span = None
        self.stats: Optional[StepStats] = None

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def __enter__(self):
        if self._cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0_wall = time.perf_counter()
        self._t0_cpu = time.process_time()
        if self._proc:
            try:
                self._ram_before = self._proc.memory_info().rss
            except Exception:
                self._ram_before = None
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        # the fence lies inside the traced span: the span's window ends
        # after the step's last device operation
        if self._cuda:
            torch.cuda.synchronize(self.device)
        if self._prof is not None:
            self._span.__exit__(exc_type, exc, tb)
            self._prof.__exit__(exc_type, exc, tb)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, _trace_file_name(self.name))
            )
            self._prof = self._span = None
        wall = time.perf_counter() - self._t0_wall
        cpu = time.process_time() - self._t0_cpu

        ram_delta_mib = None
        if self._proc and self._ram_before is not None:
            try:
                ram_delta_mib = (
                    self._proc.memory_info().rss - self._ram_before
                ) / (1024**2)
            except Exception:
                ram_delta_mib = None

        device_peak_mib = None
        if self._cuda:
            device_peak_mib = torch.cuda.max_memory_allocated(
                self.device
            ) / (1024**2)

        self.stats = StepStats(
            name=self.name,
            wall_s=wall,
            cpu_s=cpu,
            ram_delta_mib=ram_delta_mib,
            device_peak_mib=device_peak_mib,
            device_kind=self.device.type if self.device else None,
        )
        return False
