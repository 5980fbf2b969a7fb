"""Stage spans and per-call counters of the pipeline.

``stage(name)`` marks a pipeline stage. It has three modes, chosen at
each call:

- **Off** (the default): the profiler is not running and
  ``FLOODER_TIMING`` is unset. A stage reads two flags and does nothing
  else: no span, no fence, no print, no device synchronisation.
- **Profiler spans**: while ``torch.profiler`` runs, a stage opens a span
  ``flooder.<name>`` on the profiler's clock, the clock of its device
  events, and adds no fence. The span is a plain record function, not a
  user annotation, so the profiler draws no shadow of it on the device
  timeline: the device rows hold device operations only. An idle gap on
  the device then lies inside the stage that held the host.
- **Fenced lines**: ``FLOODER_TIMING=1`` prints one
  ``[flooder-timing] <stage>: <sec>s`` line a stage to stderr, and
  ``fence`` inserts ``torch.cuda.synchronize()`` so that each stage's
  device work is charged to that stage. The fences serialise host and
  device, so the times are an upper bound on the unfenced pipeline.
  ``ENABLED`` is read at call time, so a calling script may set it.

**The counter record.** While tracing (profiler or fenced mode), each
``flood_complex`` call opens a record (``new_record``), and work after
it, such as the persistence of its tree, adds to it until the next call.
``count(name, n)`` adds a host integer where the work is decided;
``keep(name, tensor)`` keeps a reference to a device counter that a
kernel writes, and nothing reads it on the hot path. With tracing off
all three return at once and nothing is counted. ``counters()`` gives
the newest record's counts, summing the kept device counters then (a
device synchronisation); ``reset_counters()`` drops every record.

``records()`` gives the last ``HISTORY`` records, each with the mode it
was opened in and its stages' host seconds. The benchmark reads its
span metrics from them because its traced run does not yet hand the
profiler's events to its readers; the history, the mode and the stage
seconds go once it does. The records are one store for the process, not
one a thread: calls that run at once on two threads mix their counts.
"""

import os
import sys
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

ENABLED = os.environ.get("FLOODER_TIMING", "").strip().lower() not in (
    "", "0", "false", "no", "off",
)

# A record function of the profiler that is not a user annotation, so it
# casts no shadow on the device timeline; a torch without it gets the
# public record function, whose span does cast one.
_span = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                None) or torch.profiler.record_function

SPAN_PREFIX = "flooder."
HISTORY = 16  # records kept


def tracing() -> bool:
    """Whether the profiler runs or the fenced lines are on."""
    return ENABLED or _profiler._is_profiler_enabled


class _Record:
    """One call's counts, kept device counters and stage seconds."""

    def __init__(self):
        if ENABLED:
            self.mode = "fenced"
        elif _profiler._is_profiler_enabled:
            self.mode = "profiler"
        else:
            self.mode = "off"
        self.counts: Dict[str, int] = defaultdict(int)
        self.kept: List[Tuple[str, torch.Tensor, Optional[int]]] = []
        self.stage_s: Dict[str, float] = defaultdict(float)

    def resolve(self) -> Dict[str, int]:
        for name, t, column in self.kept:
            self.counts[name] += int((t if column is None
                                      else t[:, column]).sum())
        self.kept.clear()
        return dict(self.counts)


_records = deque([_Record()], maxlen=HISTORY)


def new_record() -> None:
    """While tracing, open the record of a new call."""
    if tracing():
        _records.append(_Record())


def count(name: str, n: int = 1) -> None:
    """While tracing, add the host integer ``n`` to counter ``name`` of
    the open record."""
    if tracing():
        _records[-1].counts[name] += int(n)


def keep(name: str, tensor: torch.Tensor,
         column: Optional[int] = None) -> None:
    """While tracing, keep ``tensor``, a device counter a kernel writes,
    to be summed into counter ``name`` when the record is read: whole, or
    only its column ``column``."""
    if tracing():
        _records[-1].kept.append((name, tensor, column))


def counters() -> Dict[str, int]:
    """The open record's counters, device counters summed."""
    return _records[-1].resolve()


def records() -> List[dict]:
    """The kept records, oldest first: each its ``mode`` ("off",
    "profiler" or "fenced"), ``counters`` and ``stage_s`` (host seconds
    by stage name, kept while tracing)."""
    return [{"mode": r.mode, "counters": r.resolve(),
             "stage_s": dict(r.stage_s)} for r in _records]


def reset_counters() -> None:
    """Drop every record and open an empty one."""
    _records.clear()
    _records.append(_Record())


def fence(*tensors) -> None:
    """Wait for the device, only in timing mode and only for CUDA tensors."""
    if ENABLED and any(
        isinstance(t, torch.Tensor) and t.is_cuda for t in tensors
    ):
        torch.cuda.synchronize()


@contextmanager
def stage(name: str):
    """A pipeline stage: a profiler span while the profiler runs, a fenced
    stderr line in timing mode, nothing otherwise."""
    if not (ENABLED or _profiler._is_profiler_enabled):
        yield
        return
    span = _span(SPAN_PREFIX + name) if _profiler._is_profiler_enabled \
        else None
    if span is not None:
        span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if span is not None:
            span.__exit__(None, None, None)
        _records[-1].stage_s[name] += dt
        if ENABLED:
            print(f"[flooder-timing] {name}: {dt:.4f}s", file=sys.stderr,
                  flush=True)
