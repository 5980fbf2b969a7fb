#!/usr/bin/env python3
"""flooder command-line interface on PyTorch and CUDA.

The counterpart of ``flooder_tpu.cli``: the same pipeline (load .npy →
Flood complex → persistence → atomic pickle output → runtime statistics
table) and flag surface, with the devices ``cuda``, ``cuda:N`` and
``cpu`` (default ``cuda``; without CUDA it fails and says to pass
``--device cpu``). Each step is fenced and its device peak memory read by
``StepTimer``; ``--trace-dir`` writes a ``torch.profiler`` Chrome trace of
the Flood-complex step, which carries the pipeline's stages as
``flooder.*`` spans. Run it as ``python -m flooder_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import math
import pickle
import re
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

try:
    from rich import box
    from rich.console import Console
    from rich.table import Table

    _HAS_RICH = True
except Exception:  # pragma: no cover
    _HAS_RICH = False

from .utils.timing import StepStats, StepTimer


class _PlainConsole:
    def print(self, *args, **kwargs):
        text = " ".join(str(a) for a in args)
        print(re.sub(r"\[/?[a-z ]+\]", "", text))

    def status(self, *args, **kwargs):
        import contextlib

        return contextlib.nullcontext()


console = Console() if _HAS_RICH else _PlainConsole()


@dataclass
class RunMeta:
    input_file: str
    output_file: Optional[str]
    num_landmarks: int
    max_dimension: int
    fps_height: int
    batch_size: int
    device: str
    points_per_edge: Optional[int]
    num_rand: Optional[int]
    seed: Optional[int]
    use_pallas: bool
    n_points: int
    ambient_dim: int


def device_type(value: str) -> str:
    if value in ("cpu", "cuda"):
        return value
    if re.fullmatch(r"(cuda|cpu):\d+", value):
        return value
    if value.startswith("tpu"):
        raise argparse.ArgumentTypeError(
            f"'{value}' is a TPU device; this build targets CUDA/CPU. "
            "Use 'cuda', 'cuda:N', or 'cpu'."
        )
    raise argparse.ArgumentTypeError(
        f"Invalid device '{value}'. Must be 'cpu', 'cuda' or 'cuda:<id>'."
    )


def setup_cmdline_parsing() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flooder",
        description="Flood complex + persistent homology on CUDA "
        "(flooder-tpu, PyTorch port)",
    )

    g0 = p.add_argument_group("Flooder options")
    g0.add_argument(
        "--num-landmarks",
        metavar="INT",
        type=int,
        default=2000,
        help="Number of landmarks for Flood complex (default: %(default)s)",
    )
    g0.add_argument(
        "--max-dimension",
        metavar="INT",
        type=int,
        default=None,
        help="Compute PH up to max. dimension (exclusive) (default: ambient dim)",
    )
    g0.add_argument(
        "--fpsh",
        dest="fps_height",
        metavar="INT",
        type=int,
        default=9,
        help="FPS kd-height (accepted for compatibility; exact FPS ignores it)",
    )
    g0.add_argument(
        "--batch-size",
        metavar="INT",
        type=int,
        default=64,
        help="Batch size for Flood complex (default: %(default)s)",
    )
    g0.add_argument(
        "--device",
        type=device_type,
        default=None,
        help='Device: "cpu", "cuda" or "cuda:N" (default: cuda)',
    )
    g0.add_argument(
        "--seed",
        metavar="INT",
        type=int,
        default=None,
        help="Random seed (only used when --num-rand is set)",
    )
    g0.add_argument(
        "--no-pallas",
        "--no-triton",
        dest="no_pallas",
        action="store_true",
        help="Run the dense engine instead of the hand-written CUDA flood "
        "kernel (the kernel runs by default on CUDA)",
    )
    mex = g0.add_mutually_exclusive_group(required=False)
    mex.add_argument(
        "--points-per-edge",
        metavar="INT",
        type=int,
        default=None,
        help="Points per edge for Flood PH (default: 30 if neither option given)",
    )
    mex.add_argument(
        "--num-rand",
        metavar="INT",
        type=int,
        default=None,
        help="Number of random points per simplex (default: None)",
    )
    g1 = p.add_argument_group("Input/Output options")
    g1.add_argument(
        "--input-file",
        metavar="FILE",
        type=str,
        required=True,
        help="NumPy .npy file with a (N, D) point cloud",
    )
    g1.add_argument(
        "--output-file",
        metavar="FILE",
        type=str,
        default=None,
        help="Output pickle (.pkl) with persistence diagrams + metadata",
    )
    g1.add_argument(
        "-v", "--verbose", action="store_true", help="Print parsed arguments"
    )
    g1.add_argument(
        "--stats-json",
        metavar="FILE",
        type=str,
        default=None,
        help="Write runtime statistics to JSON",
    )
    g1.add_argument(
        "--trace-dir",
        metavar="DIR",
        type=str,
        default=None,
        help="Write a torch.profiler Chrome trace of the Flood-complex "
        "step, with the pipeline's stages as flooder.* spans",
    )
    return p


def validate_device(device_str: Optional[str]):
    """Resolve the requested device (None means ``cuda``) to a
    ``torch.device``; nothing falls back to the CPU."""
    from .utils.device import resolve_device

    try:
        return resolve_device(device_str)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"Device '{device_str or 'cuda'}' not available ({e}). "
            "Use --device cpu."
        ) from e


def load_point_cloud(path: Path) -> Tuple[np.ndarray, int, int]:
    """Load a point cloud from a NumPy .npy file (float32-coerced)."""
    if not path.exists():
        raise FileNotFoundError(f"Input file does not exist: {path}")
    try:
        arr = np.load(path, mmap_mode="r")
    except Exception as e:
        raise ValueError(f"Failed to load NumPy file '{path}': {e}") from e
    if arr.ndim != 2:
        raise ValueError(f"Expected a 2D array (N, D); got shape {arr.shape}")
    arr = np.asarray(arr, dtype=np.float32)
    n, d = arr.shape
    return arr, n, d


def effective_max_dim(user_max: Optional[int], ambient_dim: int) -> int:
    if user_max is None:
        return ambient_dim
    if user_max < 1:
        raise ValueError("--max-dimension must be >= 1")
    if user_max > ambient_dim:
        raise ValueError(
            f"--max-dimension ({user_max}) cannot exceed ambient dimension "
            f"({ambient_dim})"
        )
    return user_max


def resolve_simplex_representation(
    points_per_edge: Optional[int], num_rand: Optional[int]
) -> Tuple[Optional[int], Optional[int]]:
    if points_per_edge is None and num_rand is None:
        return 30, None
    return points_per_edge, num_rand


def maybe_seed(seed: Optional[int]) -> None:
    if seed is not None:
        np.random.seed(seed)


def save_output(path: Path, diagrams, meta: RunMeta) -> None:
    """Atomically write {diagrams, meta} as a pickle (tmp + rename)."""
    if path.suffix == "":
        path = path.with_suffix(".pkl")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    payload = {"diagrams": diagrams, "meta": asdict(meta)}
    with tmp.open("wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def print_stats_table(steps: List[StepStats], console) -> None:
    if not _HAS_RICH:
        for s in steps:
            print(f"{s.name}: wall={s.wall_s:.3f}s cpu={s.cpu_s:.3f}s")
        return
    tbl = Table(title="Flooder runtime statistics", box=box.SIMPLE_HEAVY)
    tbl.add_column("Step", justify="left")
    tbl.add_column("Wall (s)", justify="right")
    tbl.add_column("CPU (s)", justify="right")
    tbl.add_column("Device peak (MiB)", justify="right")
    tbl.add_column("RAM Δ (MiB)", justify="right")

    def fmt(x, nd=3):
        if x is None or (isinstance(x, float) and (math.isnan(x) or math.isinf(x))):
            return "—"
        return f"{x:.{nd}f}"

    for s in steps:
        tbl.add_row(
            s.name, fmt(s.wall_s), fmt(s.cpu_s), fmt(s.device_peak_mib),
            fmt(s.ram_delta_mib),
        )
    console.print(tbl)


def dump_stats_json(steps: List[StepStats], out_path: Optional[str]) -> None:
    if not out_path:
        return
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        json.dump([s.__dict__ for s in steps], f, indent=2)


def main() -> None:
    """Console entry point; prints the red error banner, then re-raises."""
    try:
        _run()
    except Exception as e:
        console.print(f"[red]Error:[/red] {e}")
        raise


def _run() -> None:
    parser = setup_cmdline_parsing()
    args = parser.parse_args()
    if args.verbose:
        console.print(vars(args))

    from . import flood_complex
    from .utils.device import as_tensor

    device = validate_device(args.device)

    stats: List[StepStats] = []

    with console.status("Loading point cloud...", spinner="dots"):
        with StepTimer("Loading", device) as t:
            pc_host, n_pts, dim = load_point_cloud(Path(args.input_file))
        stats.append(t.stats)
    console.print(f"✓ Loading point cloud ({n_pts},{dim}) done")

    max_dim = effective_max_dim(args.max_dimension, dim)
    points_per_edge, num_rand = resolve_simplex_representation(
        args.points_per_edge, args.num_rand
    )
    maybe_seed(args.seed if num_rand is not None else None)

    use_pallas = (not args.no_pallas) and device.type == "cuda"

    with console.status("Building Flood complex...", spinner="dots"):
        with StepTimer(
            "Flood complex", device, trace_dir=args.trace_dir
        ) as t:
            pc = as_tensor(pc_host, device=device)
            fc_st = flood_complex(
                pc,
                args.num_landmarks,
                max_dimension=max_dim,
                points_per_edge=points_per_edge,
                batch_size=args.batch_size,
                fps_h=args.fps_height,
                use_pallas=use_pallas,
                return_simplex_tree=True,
                num_rand=num_rand,
                device=device,
            )
        stats.append(t.stats)
    console.print(
        f"✓ Building Flood complex with {fc_st.num_simplices()} simplices done"
    )

    with console.status("Computing persistence...", spinner="dots"):
        with StepTimer("Persistence", device) as t:
            fc_st.compute_persistence()
            diagrams = [
                fc_st.persistence_intervals_in_dimension(i)
                for i in range(max_dim)
            ]
    console.print(f"✓ Computing persistence up to max. dim {max_dim} done")
    print()
    stats.append(t.stats)

    if args.output_file:
        meta = RunMeta(
            input_file=args.input_file,
            output_file=args.output_file,
            num_landmarks=args.num_landmarks,
            max_dimension=max_dim,
            fps_height=args.fps_height,
            batch_size=args.batch_size,
            device=str(device),
            points_per_edge=points_per_edge,
            num_rand=num_rand,
            seed=args.seed if num_rand is not None else None,
            use_pallas=use_pallas,
            n_points=n_pts,
            ambient_dim=dim,
        )
        save_output(Path(args.output_file), diagrams, meta)

    print_stats_table(stats, console)
    dump_stats_json(stats, args.stats_json)


if __name__ == "__main__":
    main()
