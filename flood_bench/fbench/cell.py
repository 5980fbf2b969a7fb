"""One run of one cell: set-up, the measured window (or the traced
phases), the check against the reference, and the result line.

The traffic is a closed loop with one client: cloud after cloud, each new
(made on the device from ``(seed, index)``), each handed to
``flooder_tpu_torch.flood_complex`` with a landmark count, so FPS runs
inside the call, and done when its diagrams (``st.persistence()``) are on
the host. The warm-up cloud is index 0; the window's clouds are 1, 2, ...

A traffic mix (``traffic/<name>.json``) says so in its keys, which
``check_traffic`` holds to what this client drives: ``loop`` "closed",
``clients`` 1, ``clouds`` "distinct", and ``mode`` "grid" (with
``points_per_edge``) or "random" (with ``num_rand``: the program draws
each pass's samples from the host numpy RNG, which the client seeds from
``(seed, index)`` before each call, and the reference draws them again
from that seed).
"""

from __future__ import annotations

import contextlib
import gc
import io
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, layout, reference
from .generators import make_cloud, stream_seed
from .guard import forbidden_modules
from .trace import parse_stages, reduce_profile

GIB = float(1 << 30)


class NoDevice(RuntimeError):
    """The machine lacks the chips the cell asks for."""


# What a mix may ask for, and the keys each sampling mode needs.
LOOPS, CLIENTS, CLOUDS = ("closed",), (1,), ("distinct",)
MODES = {"grid": "points_per_edge", "random": "num_rand"}


def check_traffic(traffic: dict) -> dict:
    """``traffic`` itself; ``ValueError`` where it asks for a loop, a
    client count, a kind of cloud or a sampling mode this client does not
    drive, or lacks the mode's parameter."""
    for key, allowed in (("loop", LOOPS), ("clients", CLIENTS),
                         ("clouds", CLOUDS), ("mode", tuple(MODES))):
        if traffic.get(key) not in allowed:
            raise ValueError(f"traffic {key} {traffic.get(key)!r}: this "
                             f"harness drives {', '.join(map(str, allowed))}")
    param = MODES[traffic["mode"]]
    if int(traffic.get(param, 0)) < 1:
        raise ValueError(f"{traffic['mode']} mode needs {param} >= 1")
    return traffic


class Stream:
    """The client: one cloud through the program, timed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import flooder_tpu_torch
        from flooder_tpu_torch.utils import stagetimer

        self.flood_complex = flooder_tpu_torch.flood_complex
        self.stagetimer = stagetimer
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.peak_abs = 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def cloud(self, index: int) -> torch.Tensor:
        return make_cloud(self.config, self.seed, index, self.device)

    def sampling(self, index: int) -> dict:
        """Cloud ``index``'s sampling, as ``reference.intervals`` takes it."""
        mode = self.traffic["mode"]
        out = {"mode": mode, MODES[mode]: int(self.traffic[MODES[mode]])}
        if mode == "random":
            out["host_seed"] = stream_seed(self.seed, index, 7) >> 32
        return out

    def run(self, index: int) -> dict:
        """Make cloud ``index`` and take it through the program."""
        cloud = self.cloud(index)
        sampling = self.sampling(index)
        if "host_seed" in sampling:
            np.random.seed(sampling["host_seed"])
        base = 0
        if self.cuda:
            self.peak_abs = max(self.peak_abs,
                                torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        param = MODES[sampling["mode"]]
        st = self.flood_complex(
            cloud, int(self.config["n_landmarks"]),
            max_dimension=int(self.config["max_dimension"]),
            return_simplex_tree=True, device=self.device,
            **{param: sampling[param]})
        t_call = time.perf_counter()
        pairs = st.persistence()
        t_pers = time.perf_counter() - t_call
        self._sync()
        out = {"index": index, "st": st, "diagram": pairs,
               "done": time.perf_counter(), "persistence_s": t_pers}
        if self.cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.peak_abs = max(self.peak_abs, peak)
            out["peak_bytes"] = peak - base
        return out


def _values(st) -> Dict[tuple, float]:
    return {tuple(v): f for v, f in st.get_simplices()}


class Answers:
    """What a run keeps of its answers: for every cloud whether it breaks
    what any answer holds, and ``k`` whole answers drawn from the seed as
    they come (reservoir sampling: each done cloud is as likely to be kept
    as any other), so that a run holds ``k`` answers, not every one."""

    def __init__(self, n_landmarks: int, k: int, seed: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 17])
        self.n_landmarks, self.k = n_landmarks, k
        self.kept: List[dict] = []
        self.done = 0
        self.bad = 0

    def add(self, r: dict):
        self.done += 1
        self.bad += int(compare.bad_answer(r["st"].num_vertices(),
                                           self.n_landmarks, r["diagram"]))
        if len(self.kept) < self.k:
            self.kept.append(r)
            return
        j = int(self.rng.integers(0, self.done))
        if j < self.k:
            self.kept[j] = r


def _check(stream: Stream, answers: Answers, log) -> Dict[str, float]:
    """The numbers of the run: every answer's shape, and the kept answers
    against the reference."""
    traffic = stream.traffic
    n_lms = int(stream.config["n_landmarks"])
    readings = {"bad_answers": answers.bad, "simplex_mismatch": 0,
                "filtration_gap": 0.0, "diagram_mismatch": 0}
    for r in sorted(answers.kept, key=lambda r: r["index"]):
        t0 = time.perf_counter()
        got = compare.check_cloud(
            stream.cloud(r["index"]), n_lms,
            stream.sampling(r["index"]), _values(r["st"]),
            compare.diagram_counter(r["diagram"]),
            int(traffic["check"]["simplices_per_dim"]), answers.rng)
        print(f"checked cloud {r['index']}: {got} in "
              f"{time.perf_counter() - t0:.2f} s", file=log)
        for k in ("simplex_mismatch", "filtration_gap", "diagram_mismatch"):
            readings[k] = max(readings[k], got[k])
    return readings


def _traced(stream: Stream, answers: Answers, log):
    """The traced phases: clouds with the program's fenced stage lines,
    then clouds under the profiler with no fences. Returns (clouds,
    per-layer context, device reading, breakdown)."""
    traffic = stream.traffic
    tr = traffic["trace"]
    stages, persistence_s = [], []
    idx = 1
    stream.stagetimer.ENABLED = True
    try:
        for _ in range(int(tr["stage_clouds"])):
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                r = stream.run(idx)
            answers.add(r)
            stages.append(parse_stages(buf.getvalue()))
            persistence_s.append(r["persistence_s"])
            idx += 1
    finally:
        stream.stagetimer.ENABLED = False
    acts = [torch.profiler.ProfilerActivity.CPU]
    if stream.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiled = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(int(tr["profile_clouds"])):
            with torch.profiler.record_function("cloud"):
                profiled.append(stream.run(idx))
            idx += 1
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == "cloud"
             and str(e.device_type()).endswith("CPU")]
    start = min(int(e.start_ns()) for e in spans)
    end = max(int(e.start_ns()) + int(e.duration_ns()) for e in spans)
    prof_red = reduce_profile(events, (start, end))
    cfg = stream.config
    k2_updates = []
    for r in profiled:
        answers.add(r)
        updates = reference.fps(stream.cloud(r["index"]),
                                int(cfg["n_landmarks"]), 0,
                                count_updates=True)[1]
        k2_updates.append(int(updates))
    print(f"work counts: k2 updates {k2_updates}", file=log)
    ctx = {
        "config": cfg, "traffic": traffic, "stages": stages,
        "persistence_s": persistence_s,
        "profile": prof_red, "n_profiled": len(profiled),
        "k2_updates": k2_updates,
    }
    device = {"busy_s": prof_red["busy_s"], "window_s": prof_red["window_s"]}
    breakdown = {"device_ops": prof_red["device_ops"],
                 "idle_gaps": prof_red["idle_gaps"]}
    return idx - 1, ctx, device, breakdown


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: Optional[str] = None,
             t_start: Optional[float] = None, log=sys.stderr,
             bench_dir: Path = layout.BENCH_DIR) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``device`` None means the chips the cell asks for (``NoDevice`` if
    the machine lacks them); tests pass "cpu". ``bench_dir`` holds the
    traffic mixes and metric readers.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = layout.load_benchmark(root)
    cell = layout.find_cell(bench, workload)
    config = layout.load_config(root, bench, cell["config"])
    traffic = check_traffic(layout.load_traffic(cell["traffic"], bench_dir))
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s)")
        device = "cuda:0"
    t_import = time.perf_counter()
    stream = Stream(config, traffic, seed, device)
    if stream.cuda:
        torch.zeros(1, device=stream.device)
    t_device = time.perf_counter()
    stream.run(0)  # warm-up: builds the kernels, every shape of the cell
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: to the harness {t_import - t_start:.3f}"
          f", program and device {t_device - t_import:.3f}, warm-up cloud "
          f"{time.perf_counter() - t_device:.3f}", file=log)

    metrics: Dict[str, dict] = {}
    result = {"correct": False, "attempted": 0, "failed": 0}
    dev_info: dict = {}
    breakdown = None
    answers = Answers(int(config["n_landmarks"]),
                      int(traffic["check"]["clouds"]), seed)
    if trace:
        result["attempted"], ctx, dev_info, breakdown = _traced(
            stream, answers, log)
        for m in layout.per_layer_metrics(bench, workload):
            value = layout.load_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        t0 = time.perf_counter()
        last, peak = t0, 0
        times = []
        idx = 1
        while time.perf_counter() - t0 < seconds:
            result["attempted"] += 1
            try:
                r = stream.run(idx)
            except RuntimeError as e:  # an answer that never comes
                result["failed"] += 1
                print(f"cloud {idx} failed: {e}", file=log)
            else:
                times.append(r["done"] - last)
                last, peak = r["done"], max(peak, r.get("peak_bytes", 0))
                answers.add(r)
            idx += 1
        if times:
            q = np.quantile(times, [0, 0.25, 0.5, 0.75, 1])
            print(f"window: {answers.done} clouds, s a cloud " + " ".join(
                f"{v:.4f}" for v in q), file=log)
        wanted = {m["name"]: m for m in
                  layout.end_to_end_metrics(bench, workload)}
        got = {
            "clouds_per_s": answers.done / max(last - t0, 1e-9),
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for name, m in wanted.items():
            if name in got:
                metrics[name] = {"value": got[name], "unit": m["unit"]}
    if stream.cuda:
        dev_info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(stream.device),
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(max(
                stream.peak_abs,
                torch.cuda.max_memory_allocated(stream.device))),
            **dev_info,
        }
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0, **dev_info}

    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded after the window: {', '.join(found)}")

    gc.collect()
    if stream.cuda:
        torch.cuda.empty_cache()
    readings = _check(stream, answers, log) if answers.done else {}
    ok = (bool(readings) and compare.verdict(readings)
          and result["failed"] == 0)
    result.update({"correct": ok, "metrics": metrics, "device": dev_info})
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": readings.get(k), "limit": lim}
                        for k, lim in compare.LIMITS.items()}
    return result
