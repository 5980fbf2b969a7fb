"""The profiler's events of unfenced clouds, reduced by the program's
spans (``flooder.<stage>``): each span's host seconds, the device seconds
of the operations launched inside it, and the device's idle seconds while
it held the host.

A device operation is tied to its launch by kineto's correlation ids:
its linked id is the id of the host operator that was innermost when it
was enqueued (an ``aten::`` operator, or a program span itself for the
kernels the program launches through its own C interface), and that
operator belongs to the innermost program span around its start. Device
operations with no such host operator in the window are counted under
``"(unlinked)"``; idle time and launches outside every program span under
``"(outside)"``. Host seconds of a span include those of the spans nested
in it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from .trace import _ns, _union

PREFIX = "flooder."
OUTSIDE, UNLINKED = "(outside)", "(unlinked)"


def _interval(ev) -> Tuple[int, int]:
    start = _ns(ev, "start")
    return start, start + int(ev.duration_ns())


class _Spans:
    """The program's host spans, to find the innermost one at an instant."""

    def __init__(self, spans: List[Tuple[str, int, int]]):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s for _, s, _ in self.spans]

    def at(self, t: int) -> str:
        """The innermost span around ``t`` (the latest started)."""
        k = bisect.bisect_right(self.starts, t)
        for name, s, e in reversed(self.spans[:k]):
            if e > t:
                return name
        return OUTSIDE

    def edges(self, a: int, b: int) -> List[int]:
        """Every span start or end strictly between ``a`` and ``b``."""
        return sorted({v for _, s, e in self.spans for v in (s, e)
                       if a < v < b})


def reduce_spans(events, window: Tuple[int, int],
                 shadows: Tuple[str, ...] = ("cloud",)) -> dict:
    """``host_s``, ``device_s`` and ``idle_s``, each seconds by span name
    (without the prefix), from the events inside ``window`` (start, end,
    in the profiler's nanoseconds). ``shadows`` are host spans of the
    caller whose shadows on the device rows are not device work."""
    w0, w1 = window
    spans, launches, device = [], {}, []
    for ev in events:
        s, e = _interval(ev)
        if e <= w0 or s >= w1:
            continue
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if name not in shadows and not name.startswith(PREFIX):
                device.append((ev.linked_correlation_id(), max(s, w0),
                               min(e, w1)))
            continue
        if name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, e))
        if not name.startswith("cu"):  # not a CUDA API call (cuda*, cu*)
            launches[ev.correlation_id()] = s
    found = _Spans(spans)
    host_s: Dict[str, float] = defaultdict(float)
    for name, s, e in spans:
        host_s[name] += (min(e, w1) - max(s, w0)) * 1e-9
    device_s: Dict[str, float] = defaultdict(float)
    for corr, s, e in device:
        at = launches.get(corr)
        device_s[UNLINKED if at is None else found.at(at)] += (e - s) * 1e-9
    idle_s: Dict[str, float] = defaultdict(float)
    busy = _union(np.asarray([[s, e] for _, s, e in device], dtype=np.int64))
    edges = [w0] + [int(v) for se in busy for v in se] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        cuts = [a] + found.edges(a, b) + [b]
        for x, y in zip(cuts, cuts[1:]):
            if y > x:
                idle_s[found.at((x + y) // 2)] += (y - x) * 1e-9
    return {"host_s": dict(host_s), "device_s": dict(device_s),
            "idle_s": dict(idle_s)}
