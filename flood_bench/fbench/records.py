"""The program's own record of each call (``stagetimer.records()`` of
``flooder_tpu_torch``): its counters and its stages' host seconds, of the
clouds run under the profiler, read after the traced phases.

Nothing here imports the program: the records are read from the module
the run has already loaded. A program that keeps no records gives none,
and a reader of them then reports nothing.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

PROGRAM = "flooder_tpu_torch.utils.stagetimer"


def profiled(ctx) -> List[dict]:
    """The records of the profiled clouds, oldest first: each its
    ``counters`` and ``stage_s``; [] where the program keeps none."""
    records = getattr(sys.modules.get(PROGRAM), "records", None)
    if records is None:
        return []
    runs = [r for r in records() if r["mode"] == "profiler"]
    return runs[-int(ctx["n_profiled"]):]


def stage_ms(ctx, picks: Callable[[str], bool]) -> Optional[float]:
    """The mean over the profiled clouds of the host milliseconds of the
    stages whose name ``picks`` takes; None where no cloud has one."""
    vals = [sum(s for k, s in r["stage_s"].items() if picks(k))
            for r in profiled(ctx)
            if any(picks(k) for k in r["stage_s"])]
    return sum(vals) / len(vals) * 1e3 if vals else None
