"""Reduce the traced run's records to per-layer readings.

Two records: the program's stage lines (``FLOODER_TIMING``, fenced, one
block a cloud), and a ``torch.profiler`` trace of the unfenced clouds,
reduced to device time by kernel, the device's busy time inside the
window, and the longest idle gaps with what the host was doing.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

_STAGE = re.compile(r"^\[flooder-timing\] ([^:\s][^\s]*?): ([0-9.eE+-]+)s$")


def parse_stages(text: str) -> Dict[str, float]:
    """Seconds by stage name in one cloud's stage lines (a name seen twice
    adds up)."""
    out: Dict[str, float] = defaultdict(float)
    for line in text.splitlines():
        m = _STAGE.match(line.strip())
        if m:
            out[m.group(1)] += float(m.group(2))
    return dict(out)


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted (start, end) intervals."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def reduce_profile(events, window: Tuple[int, int], top: int = 10,
                   spans: Tuple[str, ...] = ("cloud",)) -> dict:
    """Device time by operation name, busy and window seconds, and the
    longest idle gaps, from the profiler's events inside ``window``
    (start, end) in the profiler's nanoseconds.

    A gap is named by the innermost host span or operator that encloses
    its middle, and by the device operation it follows. ``spans`` are the
    benchmark's own host spans, whose shadows on the device timeline are
    not device work.
    """
    w0, w1 = window
    dev, host = [], []
    for ev in events:
        kind = str(ev.device_type())
        on_device = kind.endswith("CUDA")
        if on_device and ev.name() in spans:
            continue
        start = _ns(ev, "start")
        end = start + int(ev.duration_ns()) if hasattr(ev, "duration_ns") \
            else _ns(ev, "end")
        if end <= w0 or start >= w1:
            continue
        rec = (ev.name(), max(start, w0), min(end, w1))
        (dev if on_device else host).append(rec)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) * 1e-9
    spans = _union(np.asarray([[s, e] for _, s, e in dev], dtype=np.int64))
    busy = float((spans[:, 1] - spans[:, 0]).sum()) * 1e-9 if len(spans) else 0.0
    edges = [w0] + [v for se in spans for v in se] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:top]
    dev_sorted = sorted(dev, key=lambda r: r[2])
    dev_ends = np.asarray([r[2] for r in dev_sorted], dtype=np.int64)
    named = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        inner = None
        for name, s, e in host:
            if s <= mid <= e and (inner is None or s >= inner[1]):
                inner = (name, s)
        k = int(np.searchsorted(dev_ends, a, side="right")) - 1
        after = dev_sorted[k][0] if k >= 0 else "window start"
        label = f"{inner[0] if inner else 'host'} | after {_short(after)}"
        named.append([label, length * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "kernel_s": dict(by_name),
        "busy_s": busy,
        "window_s": (w1 - w0) * 1e-9,
        "device_ops": [[_short(n), s] for n, s in ops[:top]],
        "idle_gaps": named,
    }


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def kernel_seconds(kernel_s: Dict[str, float], prefix: str) -> float:
    """Device seconds of the operations whose name starts with ``prefix``
    (``flood_min`` takes every instance of K1): a C++ kernel's name may
    carry a return type and namespaces before it."""
    pattern = re.compile(r"(^|[\s:])" + re.escape(prefix))
    return sum(s for n, s in kernel_s.items() if pattern.search(n))
