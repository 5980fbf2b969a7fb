"""Env-gated stage timing for pipeline diagnosis.

``FLOODER_TIMING=1`` makes ``flood_complex`` and the CUDA flood engine
print one ``[flooder-timing] <stage>: <sec>`` line per internal stage to
stderr. Timing mode inserts ``torch.cuda.synchronize()`` fences so each
stage's device work is charged to that stage; the fences serialize host
and device, so timed totals are a slight upper bound on the untimed
pipeline. With the variable unset every helper is a no-op and no fence is
inserted. ``ENABLED`` is read at call time, so a calling script may set it.
"""

import os
import sys
import time
from contextlib import contextmanager

import torch

ENABLED = os.environ.get("FLOODER_TIMING", "").strip().lower() not in (
    "", "0", "false", "no", "off",
)


def note(msg: str) -> None:
    """Print a timing annotation (counts, shapes) when enabled."""
    if ENABLED:
        print(f"[flooder-timing] {msg}", file=sys.stderr, flush=True)


def fence(*tensors) -> None:
    """Wait for the device, only in timing mode and only for CUDA tensors."""
    if ENABLED and any(
        isinstance(t, torch.Tensor) and t.is_cuda for t in tensors
    ):
        torch.cuda.synchronize()


@contextmanager
def stage(name: str):
    """Time a pipeline stage (stderr, timing mode only)."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(
            f"[flooder-timing] {name}: {time.perf_counter() - t0:.4f}s",
            file=sys.stderr,
            flush=True,
        )
