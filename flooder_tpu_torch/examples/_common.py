"""What the examples share: the ``--device`` flag (default ``cuda``, as
the port's command line), the engine choice, a device fence for timings,
and the summary table of mean ± std per group (printed plainly, without
pandas)."""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..cli import device_type


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", type=device_type, default=None,
        help='"cpu", "cuda" or "cuda:N" (default: cuda; without CUDA this '
        "raises and says to use --device cpu)",
    )


def use_kernel(device: torch.device) -> bool:
    """``use_pallas`` for ``flood_complex``, as the port's command line
    chooses it: kernel K1 on the card, the dense engine on the CPU (the
    reference's examples run its dense engine off the TPU)."""
    return device.type == "cuda"


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work, so a host clock reads its end."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def print_summary(results: List[Dict], columns: Sequence[tuple]) -> None:
    """Print mean ± std (sample std, nan for one repetition) of each
    ``(key, label)`` column per (n_pts, method) group."""
    groups: Dict[tuple, List[Dict]] = {}
    for r in results:
        groups.setdefault((r["n_pts"], r["method"]), []).append(r)
    header = ["n_pts", "method"] + [label for _, label in columns]
    rows = []
    for (n_pts, method), rs in sorted(groups.items()):
        cells = [str(n_pts), method]
        for key, _ in columns:
            v = np.asarray([r[key] for r in rs], dtype=np.float64)
            std = v.std(ddof=1) if len(v) > 1 else float("nan")
            cells.append(f"{v.mean():.2f} ± {std:.2f}")
        rows.append(cells)
    widths = [max(len(c) for c in col) for col in zip(header, *rows)]
    for cells in [header] + rows:
        print("  ".join(c.rjust(w) for c, w in zip(cells, widths)))
