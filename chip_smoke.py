#!/usr/bin/env python3
"""Chip smoke test of flooder_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``flooder_tpu_torch/csrc/`` (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version on the card, checks a small pipeline on the card
against the same pipeline on the CPU, and drives the main path at its
published size: a 1,000,000-point 3-D swiss-cheese cloud (seed 42),
FPS to 1000 landmarks, the Flood complex in grid mode (30 points per
edge) and persistence in dimensions 0-2. Every launch counter is set to 0
just before the main path and read just after; each kernel must have run.

K2 runs the whole greedy loop as one cooperative launch; besides the
main path's shapes it is held against its plain version on a cloud with
more chunks than the card holds CTAs at once, so that CTAs own several
chunks.

The kernel-stats path runs kernel K3 (``csrc/flood_stats.cu``): K3 is held
against its plain version and K1 on the tool's default 100k x 300 scene; on
the main path's dimension-3 operands it is held against K1 (the same
output, and its computed tiles equal K1's admitted units) and against its
plain version on 64 whole blocks (all witnesses, exact counters), and timed
beside K1 and its issue floor at both shapes; and the tool
(``python -m flooder_tpu_torch.tools.kernel_stats``) is driven at 1M x 1k
with the launch counters set to 0 just before it and read just after.

Phases added with the dense engine and float64 (each fails the run if its
check fails):

- dims: K1 and K3 against their plain versions at 5, 6 and 8 coordinates
  on seeded operands with several tiles a simplex and balls that cut
  sub-chunks; the reference's 5-D grid and 6-D random edge cases through
  ``flood_complex`` on the card against the CPU run; K1 timed on a 200k
  5-D cloud; the pair loop of every K1 and K3 instance read from the SASS.
- float64: K2's double instance against its plain version on the
  many-chunks cloud and the 1M cheese (1000 landmarks), timed beside
  float32; ``flood_complex`` in float64 (dense engine) against the float32
  kernel route on the two 3,000 x 150 clouds of the reference's
  test_float64, and timed on the 100k x 300 cheese.
- dense: ``use_pallas=False`` in float32 against the kernel route on the
  100k x 300 cheese, timed.

The cli phase (after the main path) saves the main path's cloud to a
``.npy`` and runs ``python -m flooder_tpu_torch.cli`` on it twice as a
subprocess, with the default device, the second time with
``--trace-dir``: its diagrams must equal the main path's within 1e-6, its
metadata and step stats must show the card, and its trace must hold K1
and K2. From the trace it prints the device busy share of the
Flood-complex step (the union of GPU kernel, memcpy and memset intervals
over the step's window); it also traces one warm main-path run in this
process the same way.

Output: ``#`` lines with every phase's result, then a ``{"kernels": ...}``
JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure ends the script with a
non-zero exit code and no result line; it exits 2 without CUDA.
"""

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

N_POINTS = 1_000_000
N_LANDMARKS = 1000
PPE = 30
REPS = 3
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. Both assume the 700 W power limit.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# H100 SXM fp64 outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_FP64 = 34e12
FLOOD_OPS_PER_PAIR = 9  # 3 sub, 3 mul, 2 add, 1 min per in-ball pair (3-D)
# fp32 instructions K1 issues per in-ball pair: the inner loop of
# flood_min_kernel<3> in SASS (cuobjdump -sass of build/flooder_tpu_torch/
# libflood.so) holds 48 FADD, 16 FMUL, 32 FFMA and 16 FMNMX for 16 pairs
# (4 witnesses x 4 samples), i.e. 3 sub, 1 mul, 2 FMA and 1 min a pair; its
# issue floor is that count over 128 fp32 lanes per SM at the max SM clock.
# A log line only: it is derived, not measured.
FLOOD_INSTR_PER_PAIR = 7
FP32_LANES_PER_SM = 128
FPS_OPS_PER_POINT = 9  # the same per visited point (and one compare)
FPS_MANY_CHUNKS_LANDMARKS = 64
K3_PLAIN_POINTS = 100_000  # the kernel-stats tool's default scene
K3_PLAIN_LANDMARKS = 300
K3_LONGEST_BLOCKS = 16  # K3's plain check at 1M x 1k: whole blocks
K3_SPREAD_BLOCKS = 48
HIGH_DIMS = (5, 6, 8)  # K1 and K3 held against their plain versions
DIM5_POINTS, DIM5_LANDMARKS, DIM5_PPE = 200_000, 64, 5  # K1 timed at 5-D
F64_LANDMARKS = 150  # the reference's test_float64 clouds: 3000 x 150
F64_POINTS = 3000
DENSE_POINTS, DENSE_LANDMARKS = 100_000, 300  # float64 and dense timing


def log(msg):
    print(f"# {msg}", flush=True)


def card_line(fields="name,power.limit"):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events, after
    one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def greedy_steps(points, idx):
    """Per-step farthest squared distances of an FPS index sequence
    (float64, on the points' device), the quantity two exact greedy runs
    must share."""
    import torch

    p = points.to(torch.float64)
    m = torch.full((p.shape[0],), float("inf"), dtype=p.dtype,
                   device=p.device)
    out = torch.empty(len(idx), dtype=p.dtype, device=p.device)
    for k, i in enumerate(idx.tolist()):
        out[k] = m[i]
        m = torch.minimum(m, ((p - p[i]) ** 2).sum(-1))
    return out.cpu().numpy()


def check_same_greedy(points, a, b, start):
    """The rule of tests/test_landmarks.py::_assert_same_greedy_selection:
    the same start, distinct picks and the same farthest distance at every
    step (an exact tie may pick another, equally far point). ``points`` is
    a tensor, ``a`` and ``b`` are numpy index arrays."""
    if not (a[0] == b[0] == start):
        raise AssertionError(f"FPS start differs: {a[0]} {b[0]} {start}")
    if len(set(a.tolist())) != len(a):
        raise AssertionError("FPS kernel picked a point twice")
    da, db = greedy_steps(points, a), greedy_steps(points, b)
    fin = np.isfinite(da)
    if not (np.isfinite(db) == fin).all():
        raise AssertionError("FPS step distances differ in finiteness")
    diff = np.abs(da[fin] - db[fin])
    if (diff > 1e-6 * np.maximum(da[fin], db[fin])).any():
        raise AssertionError(f"FPS greedy selection differs: {diff.max()}")
    return float(diff.max()) if len(diff) else 0.0


def flood_d2_diff(out_a, out_b, what):
    """Max |d2 diff| of two flood outputs, which must mark no-witness
    entries (>= 1e30) in the same places."""
    from flooder_tpu_torch.ops.cuda_flood import _MASKED_D2

    masked = out_a >= _MASKED_D2
    if not (masked == (out_b >= _MASKED_D2)).all():
        raise AssertionError(f"{what}: no-witness (inf) entries differ")
    err = (out_a[~masked] - out_b[~masked]).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"{what}: max |d2 diff| {err} > 1e-6")
    return err


def seeded_flood_operands(dim, device, r_count=1100, radius_max=3.0,
                          seed=7):
    """K1's operands at ``dim`` coordinates from ``CudaFloodEngine.prepare``
    (as tests/test_torch_cuda.py builds them): 16,384 uniform witnesses in
    [0, 5]^dim, 4 blocks of random simplices, radii in [0.1, radius_max)
    with every fourth 1e-5 (it meets boxes but holds no witness), 1100
    samples (3 tiles a simplex), the nearest-vertex bound on."""
    import torch

    from flooder_tpu_torch.ops import cuda_flood

    rng = np.random.default_rng(seed + dim)
    X = (rng.random((16384, dim)) * 5).astype(np.float32)
    eng = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    S, k = cuda_flood.BS * 4, dim + 1
    centers = (rng.random((S, dim)) * 5).astype(np.float32)
    radii = (rng.random(S) * (radius_max - 0.1) + 0.1).astype(np.float32)
    radii[::4] = 1e-5
    verts = centers[:, None, :] + (
        rng.random((S, k, dim)).astype(np.float32) - 0.5) * 0.3
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return eng.prepare(t(verts), w, t(centers), t(radii), True)[0]


def top_pass_operands(engine, landmarks, ppe, tight=True):
    """The operands flood_complex hands kernel K1 in its top-dimension pass
    (grid mode), and the number of top simplices."""
    import torch

    from flooder_tpu_torch.core import _grid_host
    from flooder_tpu_torch.ops.flood import simplex_bounding_balls
    from flooder_tpu_torch.topology import DelaunayComplex

    dev = landmarks.device
    dim = landmarks.shape[1]
    stree = DelaunayComplex(
        landmarks.cpu().numpy().astype(np.float64)
    ).create_simplex_tree()
    top = torch.as_tensor(stree._verts[dim], device=dev).long()
    verts = landmarks[top]
    centers, radii = simplex_bounding_balls(verts)
    order = torch.as_tensor(engine.order(centers), device=dev)
    operands, _, num = engine.prepare(
        verts[order], _grid_host(ppe, dim)[0], centers[order], radii[order],
        tight)
    return operands, num


def complex_dict(points, landmarks, device, **kw):
    """flood_complex as a {simplex: value} dict (float64 warnings muted)."""
    import flooder_tpu_torch as ft

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        st = ft.flood_complex(points, landmarks, return_simplex_tree=True,
                              device=device, **kw)
    return {tuple(s): f for s, f in st.get_simplices()}


def complex_diff(a, b, tol, what):
    """Max |value diff| of two complexes, which must hold the same simplices
    with inf in the same places and every finite value within ``tol``."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: the simplices differ")
    err = 0.0
    for s, v in a.items():
        if np.isinf(v) != np.isinf(b[s]):
            raise AssertionError(f"{what}: inf differs at {s}")
        if np.isfinite(v):
            err = max(err, abs(b[s] - v))
    if not err <= tol:
        raise AssertionError(f"{what}: max |diff| {err} > {tol}")
    return err


def sass_pair_loops(lib_path):
    """Per kernel instance of a built library, from ``cuobjdump -sass``:
    (instance, instructions of its pair loop, local-memory accesses in it,
    local-memory accesses in the whole kernel). The pair loop is the
    innermost backward branch whose body holds 16 FMNMX and FFMA, the
    inner loop of min_over_staged (4 witnesses x 4 samples). None where
    the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    from flooder_tpu_torch.native.build import kernel_instance

    exe = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                    "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    rows = []
    for block in text.split("Function : ")[1:]:
        name = kernel_instance(block.split(None, 1)[0])
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        best = None
        for addr, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            if (sum("FMNMX" in o for o in body) == 16
                    and any("FFMA" in o for o in body)
                    and (best is None or len(body) < len(best))):
                best = body
        rows.append((name, len(best) if best else None,
                     _local_accesses(best) if best else None,
                     _local_accesses(o for _, o in ins)))
    return rows


def _local_accesses(ops):
    return sum(("LDL" in o) or ("STL" in o) for o in ops)


def resident_ctas(regs, smem, threads):
    """CTAs an H100 SM holds at once (derived from the ptxas line, not
    measured): the least of its 65,536 registers (allocated per warp in
    units of 256), its 228 KB of shared memory (1 KB reserved a CTA),
    2,048 threads and 32 CTAs."""
    warps = threads // 32
    regs_per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (regs_per_warp * warps), 233472 // (smem + 1024),
               2048 // threads, 32)


def flood_occupancy(ptxas_rows, kernel, threads, dyn_smem):
    """(instance, shared bytes a CTA, resident CTAs and warps an SM) of the
    flood kernels' instances at rt 512; ``dyn_smem(dim)`` is the dynamic
    shared memory a CTA asks for."""
    rows = []
    for name, regs, _, smem in ptxas_rows:
        if name.startswith(kernel + "<"):
            dim = int(name[len(kernel) + 1:-1])
            total = smem + dyn_smem(dim)
            ctas = resident_ctas(regs, total, threads)
            rows.append((name, total, ctas, ctas * threads // 32))
    return rows


def issue_floor_ms(inball_pairs, sms, clock_mhz):
    """Derived issue floor of K1 and K3: FLOOD_INSTR_PER_PAIR fp32
    instructions per in-ball pair over the card's fp32 lanes at the max SM
    clock."""
    return 1e3 * FLOOD_INSTR_PER_PAIR * inball_pairs / (
        sms * FP32_LANES_PER_SM * clock_mhz * 1e6)


def flood_bound_ms(operands, inball_pairs):
    """Least time for K1's work: the larger of its operations (3 per
    coordinate per in-ball pair of the admitted units: sub, mul, add or min)
    over the fp32 peak and its bytes (every input read once, the output
    written once) over HBM."""
    samples = operands[0]
    in_bytes = sum(t.numel() * t.element_size() for t in operands)
    out_bytes = samples.numel() // samples.shape[-1] * 4
    ops_per_pair = FLOOD_OPS_PER_PAIR * samples.shape[-1] // 3
    t_ops = ops_per_pair * inball_pairs / PEAK_FP32
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else (
        "bytes")


def sorted_bars(d):
    d = np.asarray(d, dtype=np.float64).reshape(-1, 2)
    return d[np.lexsort((d[:, 1], d[:, 0]))]


def diagrams_diff(a, b, tol, what):
    """Max |diff| of two lists of diagrams: the same number of bars in
    every dimension, births and deaths within ``tol`` after sorting, inf
    in the same places."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} dimensions against {len(b)}")
    err = 0.0
    for dim, (da, db) in enumerate(zip(a, b)):
        da, db = sorted_bars(da), sorted_bars(db)
        if da.shape != db.shape:
            raise AssertionError(f"{what}: dimension {dim} has {len(da)} "
                                 f"bars against {len(db)}")
        inf = np.isinf(da)
        if not (inf == np.isinf(db)).all():
            raise AssertionError(f"{what}: inf differs in dimension {dim}")
        if (~inf).any():
            err = max(err, float(np.abs(da[~inf] - db[~inf]).max()))
    if not err <= tol:
        raise AssertionError(f"{what}: max |diff| {err} > {tol}")
    return err


GPU_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_busy(trace_dir, step):
    """Device activity of one step from the Chrome trace that StepTimer
    wrote into ``trace_dir``: the step's window (its ``record_function``
    span, which ends after the exit fence), the union of the intervals of
    every GPU kernel, memcpy and memset clipped to it, and per kernel name
    the count and summed duration (µs)."""
    paths = sorted(p for p in os.listdir(trace_dir) if p.endswith(".json"))
    if len(paths) != 1:
        raise AssertionError(f"trace dir holds {paths}, not one trace")
    with open(os.path.join(trace_dir, paths[0])) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == step]
    if len(spans) != 1:
        raise AssertionError(f"trace: {len(spans)} spans named {step!r}")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    gpu = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in GPU_EVENT_CATS]
    if not gpu:
        raise AssertionError("trace: no device activity (no GPU kernel, "
                             "memcpy or memset event)")
    ivals = sorted((max(w0, float(e["ts"])),
                    min(w1, float(e["ts"]) + float(e["dur"]))) for e in gpu)
    busy, end = 0.0, w0
    for a, b in ivals:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    kernels = {}
    for e in gpu:
        if e["cat"] == "kernel":
            n, us = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, us + float(e["dur"]))
    cats = {c: sum(e["cat"] == c for e in gpu) for c in GPU_EVENT_CATS}
    # host-side CUDA API calls in the window: where a cold step waits
    api = sorted(((float(e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X"
                  and e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and w0 <= float(e["ts"]) <= w1), reverse=True)
    return {"window_us": w1 - w0, "busy_us": busy, "kernels": kernels,
            "events": cats, "api_us": sum(d for d, _ in api),
            "api_top": [(n, round(d / 1e3, 3)) for d, n in api[:5]],
            "size_bytes": os.path.getsize(os.path.join(trace_dir, paths[0]))}


def kernel_in_trace(busy, name):
    """(launches, µs) of the kernels whose (mangled) name holds ``name``."""
    hits = [v for k, v in busy["kernels"].items() if name in k]
    return sum(n for n, _ in hits), sum(us for _, us in hits)


def run_cli(args):
    """``python -m flooder_tpu_torch.cli`` as a user runs it, from the
    checkout's root (so it loads the kernels this script built)."""
    res = subprocess.run(
        [sys.executable, "-m", "flooder_tpu_torch.cli", *map(str, args)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
    )
    if res.returncode != 0:
        raise AssertionError(f"CLI exit {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res


CLI_STEPS = ["Loading", "Flood complex", "Persistence"]


def cli_phase(X, diagrams):
    """The CLI on the main path's cloud, twice (the second run traced):
    its diagrams against the main path's, its metadata and stats, and the
    device busy share of its Flood-complex step from the trace."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cloud = os.path.join(tmp, "cheese.npy")
        np.save(cloud, X.cpu().numpy())
        trace_dir = os.path.join(tmp, "trace")
        for run in ("untraced", "traced"):
            pkl = os.path.join(tmp, f"{run}.pkl")
            stats_json = os.path.join(tmp, f"{run}.json")
            args = ["--input-file", cloud, "--num-landmarks", N_LANDMARKS,
                    "--points-per-edge", PPE, "--output-file", pkl,
                    "--stats-json", stats_json]
            if run == "traced":
                args += ["--trace-dir", trace_dir]
            t0 = time.perf_counter()
            run_cli(args)
            process_s = time.perf_counter() - t0
            with open(pkl, "rb") as f:
                payload = pickle.load(f)
            with open(stats_json) as f:
                steps = json.load(f)
            err = diagrams_diff(diagrams, payload["diagrams"], 1e-6,
                                f"CLI ({run}) against the main path")
            meta = payload["meta"]
            if not (meta["n_points"] == N_POINTS and meta["ambient_dim"] == 3
                    and meta["use_pallas"] is True
                    and meta["device"].startswith("cuda")):
                raise AssertionError(f"CLI ({run}) meta: {meta}")
            if [s["name"] for s in steps] != CLI_STEPS:
                raise AssertionError(f"CLI ({run}) steps: {steps}")
            flood = steps[1]
            peak = flood["device_peak_mib"]
            if not (flood["device_kind"] == "cuda" and peak is not None
                    and np.isfinite(peak) and peak > 0):
                raise AssertionError(f"CLI ({run}) Flood complex: {flood}")
            out[run] = {"steps": steps, "max_abs_err": err,
                        "process_s": process_s}
            if run == "traced":
                out["busy"] = trace_busy(trace_dir, "Flood complex")
    return out


def main():
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import flooder_tpu_torch as ft
    from flooder_tpu_torch.native import build
    from flooder_tpu_torch.ops import cuda_flood, cuda_flood_stats, cuda_fps
    from flooder_tpu_torch.ops.fps import farthest_point_sampling
    from flooder_tpu_torch.tools import kernel_stats
    from flooder_tpu_torch.tools.scene import block_slice, build_scene
    from flooder_tpu_torch.utils import StepTimer, stagetimer

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_cuda(["flood", "fps", "flood_stats"])
    log(f"kernel build: {time.perf_counter() - t0:.2f}s wall for flood, fps, "
        f"flood_stats in parallel; per source {build.BUILD_SECONDS}")
    raw8 = cuda_flood.SUB * 8 * 4  # K1's and K3's raw buffer at DIM 8
    # (kernel, threads a CTA, dynamic shared bytes at rt 512 and K3's nr 10)
    occupancy_of = {
        "flood": ("flood_min_kernel", 128, lambda d: raw8 if d == 8 else 0),
        "flood_stats": ("flood_stats_kernel", 256, lambda d: (
            10 * 512 + 8 * 10) * 4 + (raw8 if d == 8 else 0)),
    }
    for name, text in build.BUILD_LOG.items():
        rows = build.ptxas_kernels(text)
        log(f"ptxas {name}: (kernel, registers, spill-store bytes, static "
            f"smem bytes) {rows}")
        if name in occupancy_of:
            log(f"occupancy of {name} at rt 512 (K3 at nr 10), derived from "
                "ptxas: (kernel, shared bytes a CTA, CTAs an SM, warps an SM) "
                f"{flood_occupancy(rows, *occupancy_of[name])}")
    for name in ("flood", "flood_stats"):
        loops = sass_pair_loops(build.cuda_library(name))
        log(f"SASS {name}: (kernel, pair-loop instructions for 16 pairs, "
            f"local accesses in it, local accesses in the kernel) "
            f"{loops if loops is not None else 'cuobjdump not found'}")
    t0 = time.perf_counter()
    build.load_persistence()
    log(f"native persistence build: {time.perf_counter() - t0:.2f}s")

    # ---- K2 against its plain version -------------------------------------
    P = ft.generate_swiss_cheese_points(200_000, k=6, seed=7, device=dev)[0]
    a = cuda_fps.cuda_farthest_point_sampling(P, 256, 0).cpu().numpy()
    b = farthest_point_sampling(P, 256, 0).cpu().numpy()
    fps_err_small = check_same_greedy(P, a, b, 0)
    log(f"K2 fps 200k x 256: same greedy selection as the plain version, "
        f"max |step d2 diff| {fps_err_small}")
    del P
    # more chunks than co-resident CTAs: CTAs own several chunks
    ctas = cuda_fps.coresident_ctas(3)
    n_many = cuda_fps.FPS_CHUNK * (ctas + 5)
    P = torch.rand(n_many, 3, generator=torch.Generator(dev).manual_seed(11),
                   device=dev)
    a = cuda_fps.cuda_farthest_point_sampling(
        P, FPS_MANY_CHUNKS_LANDMARKS, 3).cpu().numpy()
    b = farthest_point_sampling(P, FPS_MANY_CHUNKS_LANDMARKS, 3).cpu().numpy()
    fps_err_many = check_same_greedy(P, a, b, 3)
    chunks = n_many // cuda_fps.FPS_CHUNK
    log(f"K2 fps {n_many} x {FPS_MANY_CHUNKS_LANDMARKS} ({chunks} chunks on "
        f"{ctas} co-resident CTAs): same "
        f"greedy selection as the plain version, max |step d2 diff| "
        f"{fps_err_many}")
    del P

    # ---- the main path's cloud, and K1 against its plain version -----------
    X = ft.generate_swiss_cheese_points(N_POINTS, k=6, seed=42, device=dev)[0]
    L = ft.generate_landmarks(X, N_LANDMARKS, start_idx=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = cuda_flood.CudaFloodEngine(X)
    torch.cuda.synchronize()
    log(f"engine set-up (pad, k-d order, boxes) for {N_POINTS} witnesses: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms (host clock)")
    # every tetrahedron of the main path's dimension-3 pass, at full width
    ops, n_tets = top_pass_operands(engine, L, PPE)
    out_k, stats_k = cuda_flood.flood_min(*ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    flood_err = flood_d2_diff(out_k, out_p, "K1 against its plain version")
    units_k = cuda_flood.kernel_operations(stats_k)[0]
    units_p = cuda_flood.kernel_operations(stats_p)[0]
    if not torch.equal(stats_k, stats_p):
        raise AssertionError(f"K1 admitted other units than its plain "
                             f"version: {units_k} against {units_p}")
    n_masked = int((out_k >= cuda_flood._MASKED_D2).sum())
    del ops, out_k, stats_k, out_p, stats_p
    log(f"K1 flood at the main path's shapes ({N_POINTS} witnesses, "
        f"{n_tets} tetrahedra, ppe {PPE}): max |d2 diff| {flood_err} against "
        f"the plain version, inf in the same places "
        f"({n_masked} entries), admitted units {units_k} (plain {units_p}), "
        f"equal per CTA; plain {plain_ms:.1f} ms (host clock, one run)")

    # ---- a small pipeline on the card against the CPU ----------------------
    Y = ft.generate_swiss_cheese_points(3000, seed=5, device="cpu")[0]
    res = {}
    for d in ("cpu", "cuda"):
        st = ft.flood_complex(Y, 40, points_per_edge=PPE,
                              return_simplex_tree=True, device=d)
        res[d] = {tuple(s): f for s, f in st.get_simplices()}
    if res["cpu"].keys() != res["cuda"].keys():
        raise AssertionError("pipeline: the card and the CPU differ in simplices")
    pipe_err = max(abs(res["cuda"][s] - v) for s, v in res["cpu"].items())
    if not pipe_err <= 1e-6:
        raise AssertionError(f"pipeline: card vs CPU filtration diff {pipe_err}")
    log(f"pipeline 3k x 40: card == CPU on {len(res['cpu'])} simplices, "
        f"max |diff| {pipe_err}")

    # ---- the main path ------------------------------------------------------
    def main_path():
        stree = ft.flood_complex(X, N_LANDMARKS, points_per_edge=PPE,
                                 return_simplex_tree=True)
        with stagetimer.stage("persistence"):
            stree.compute_persistence()
            diagrams = [stree.persistence_intervals_in_dimension(i)
                        for i in range(3)]
        torch.cuda.synchronize()
        return stree, diagrams

    main_path()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for rep in range(REPS):
        if rep == 0:
            cuda_fps.LAUNCHES = 0
            cuda_flood.LAUNCHES = 0
        t0 = time.perf_counter()
        stree, diagrams = main_path()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = {"fps": cuda_fps.LAUNCHES, "flood": cuda_flood.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches (one run): {launches}")
    if launches != {"fps": 1, "flood": 1}:
        raise AssertionError("the main path must launch K2 once and K1 once: "
                             f"{launches}")

    counts = [int(v.shape[0]) for v in stree._verts]
    vals = np.concatenate(stree._filt)
    if not np.isfinite(vals).all():
        raise AssertionError("main path: non-finite filtration values")
    if stree.make_filtration_non_decreasing():
        raise AssertionError("main path: filtration was not monotone")
    sizes = [len(d) for d in diagrams]
    if counts[0] != N_LANDMARKS or len(counts) != 4 or sizes[0] != N_LANDMARKS:
        raise AssertionError(f"main path: complex {counts}, diagrams {sizes}")
    if int(np.isinf(diagrams[0][:, 1]).sum()) != 1:
        raise AssertionError("main path: H0 must have one essential class")
    median = float(np.median(times))
    log(f"complex {counts} simplices; diagram sizes {sizes}; filtration in "
        f"[{vals.min():.6f}, {vals.max():.6f}]")
    log(f"main path {N_POINTS} x {N_LANDMARKS}: median {median:.4f}s reps "
        f"{[round(t, 4) for t in times]}; peak device memory "
        f"{peak / 2**30:.3f} GiB")

    # stage split: one more run with fenced stage timing
    buf = io.StringIO()
    stagetimer.ENABLED = True
    try:
        with contextlib.redirect_stderr(buf):
            t0 = time.perf_counter()
            with stagetimer.stage("main-path"):
                main_path()
    finally:
        stagetimer.ENABLED = False
    split = {}
    for name, sec in re.findall(r"^\[flooder-timing\] (.+): ([0-9.]+)s$",
                                buf.getvalue(), flags=re.M):
        split[name] = round(split.get(name, 0.0) + float(sec), 4)
    split["total"] = round(time.perf_counter() - t0, 4)
    log("stage split (s, fenced; nested stages overlap; 'main-path' is "
        f"the whole run): {json.dumps(split)}")

    # ---- cli: the command line on the main path's cloud --------------------
    t_phase = time.perf_counter()
    cli = cli_phase(X, diagrams)
    for run in ("untraced", "traced"):
        r = cli[run]
        table = [(s["name"], round(s["wall_s"], 4), round(s["cpu_s"], 4),
                  None if s["device_peak_mib"] is None
                  else round(s["device_peak_mib"], 1)) for s in r["steps"]]
        log(f"CLI {run} run (python -m flooder_tpu_torch.cli, default device, "
            f"{N_POINTS} x {N_LANDMARKS}, ppe {PPE}): diagrams == the main "
            f"path's, max |diff| {r['max_abs_err']}; steps (name, wall s, "
            f"cpu s, device peak MiB) {table}; process {r['process_s']:.2f}s")
    busy = cli["busy"]
    k1_n, k1_us = kernel_in_trace(busy, "flood_min_kernel")
    k2_n, k2_us = kernel_in_trace(busy, "fps_loop")
    if not (k1_n >= 1 and k2_n >= 1):
        raise AssertionError("CLI trace: K1 (flood_min_kernel) and K2 "
                             f"(fps_loop) must appear: {k1_n}, {k2_n}")
    window = busy["window_us"]
    walls = [cli[r]["steps"][1]["wall_s"] for r in ("untraced", "traced")]
    log(f"CLI Flood-complex step, traced (cold process, one run): device "
        f"busy {busy['busy_us'] / 1e3:.3f} ms of a {window / 1e3:.3f} ms "
        f"window, share {busy['busy_us'] / window:.4f} (union of "
        f"{busy['events']} GPU events); K1 {k1_n} launch(es) "
        f"{k1_us / 1e3:.3f} ms + K2 {k2_n} launch(es) {k2_us / 1e3:.3f} ms "
        f"= {(k1_us + k2_us) / 1e3:.3f} ms, share "
        f"{(k1_us + k2_us) / window:.4f}; {len(busy['kernels'])} kernel "
        f"names; CUDA API calls on the host {busy['api_us'] / 1e3:.3f} ms, "
        f"longest (name, ms) {busy['api_top']}; trace {busy['size_bytes']} "
        "bytes")
    log(f"CLI Flood-complex step wall: untraced {walls[0]:.4f}s, traced "
        f"{walls[1]:.4f}s (profiler start, stop and export included)")
    top = sorted(busy["kernels"].items(), key=lambda kv: -kv[1][1])[:8]
    log("CLI trace, kernels by summed time (name[:60], launches, ms): "
        f"{[(k[:60], n, round(us / 1e3, 3)) for k, (n, us) in top]}")
    # the same measurement in this process, on a warm main-path run
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with StepTimer("main path", dev, trace_dir=tmp) as t:
            t1 = time.perf_counter()
            main_path()
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        warm = trace_busy(tmp, "main path")
    w_k1 = kernel_in_trace(warm, "flood_min_kernel")
    w_k2 = kernel_in_trace(warm, "fps_loop")
    log(f"main path traced in this process (warm): device busy "
        f"{warm['busy_us'] / 1e3:.3f} ms of a {warm['window_us'] / 1e3:.3f} "
        f"ms window, share {warm['busy_us'] / warm['window_us']:.4f} "
        f"({warm['events']}); K1 {w_k1[0]} launch(es) {w_k1[1] / 1e3:.3f} "
        f"ms, K2 {w_k2[0]} launch(es) {w_k2[1] / 1e3:.3f} ms; CUDA API "
        f"calls on the host {warm['api_us'] / 1e3:.3f} ms; step wall "
        f"{t.stats.wall_s:.4f}s traced against the untraced median "
        f"{median:.4f}s: profiler start {t1 - t0:.4f}s, the run "
        f"{t2 - t1:.4f}s, fence, profiler stop and export {t3 - t2:.4f}s "
        "(host clock)")
    log(f"cli phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- kernel times at the main path's shapes -----------------------------
    ops, _ = top_pass_operands(engine, L, PPE)
    k1_ms = cuda_ms(lambda: cuda_flood.flood_min(*ops), 5)
    out_k1, stats_full = cuda_flood.flood_min(*ops)
    units, inball = cuda_flood.kernel_operations(stats_full)
    rt = ops[0].shape[2]
    k1_bound, k1_by = flood_bound_ms(ops, inball)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(card_line("clocks.max.sm").split()[0])
    k1_floor = issue_floor_ms(inball, sms, clock_mhz)
    log(f"K1 at 1M x 1k: {units} admitted (simplex, tile, sub-chunk) units, "
        f"{units * cuda_flood.SUB * rt} pairs without compaction, {inball} "
        f"in-ball pairs; kernel {k1_ms:.3f} ms, bound {k1_bound:.3f} ms "
        f"({k1_by}); issue floor {k1_floor:.3f} ms (derived: "
        f"{FLOOD_INSTR_PER_PAIR} fp32 instructions per in-ball pair from "
        f"the SASS, {sms} SMs x {FP32_LANES_PER_SM} lanes at "
        f"{clock_mhz:.0f} MHz)")

    # K2 against its plain version at the main path's shapes
    a = cuda_fps.cuda_farthest_point_sampling(X, N_LANDMARKS, 0).cpu().numpy()
    b = farthest_point_sampling(X, N_LANDMARKS, 0).cpu().numpy()
    fps_err = check_same_greedy(X, a, b, 0)
    log(f"K2 fps {N_POINTS} x {N_LANDMARKS}: same greedy selection as the "
        f"plain version, max |step d2 diff| {fps_err}")

    prep = cuda_fps._fps_prepare(X, 0)
    n0 = cuda_fps.LAUNCHES
    k2_ms = cuda_ms(lambda: cuda_fps.fps_kernel_run(prep, N_LANDMARKS), 5)
    k2_launches = (cuda_fps.LAUNCHES - n0) // 6  # warm-up + 5 timed runs
    if k2_launches != 1:
        raise AssertionError(f"K2 made {k2_launches} launches per run")
    k2_total = cuda_ms(
        lambda: cuda_fps.cuda_farthest_point_sampling(X, N_LANDMARKS, 0), 5
    )
    visits = int(cuda_fps.last_visits.item())
    k2_plain = cuda_ms(
        lambda: farthest_point_sampling(X, N_LANDMARKS, 0), 1
    )
    fps_bytes = X.numel() * 4 + N_LANDMARKS * 4
    fps_ops = FPS_OPS_PER_POINT * visits * cuda_fps.FPS_CHUNK
    k2_bound = 1e3 * max(fps_ops / PEAK_FP32, fps_bytes / PEAK_BYTES)
    k2_by = "operations" if fps_ops / PEAK_FP32 >= fps_bytes / PEAK_BYTES \
        else "bytes"
    log(f"K2 at 1M x 1k: greedy loop {k2_ms:.3f} ms in {k2_launches} "
        f"counted CUDA launch ({1e3 * k2_ms / (N_LANDMARKS - 1):.2f} us per "
        f"greedy step), with layout prep {k2_total:.3f} ms; {visits} chunk "
        f"visits; plain {k2_plain:.1f} ms; bound {k2_bound:.4f} ms ({k2_by})")

    # ---- K3 against its plain version on the tool's default scene ---------
    small = build_scene(K3_PLAIN_POINTS, K3_PLAIN_LANDMARKS)
    out_k, stats_k = cuda_flood_stats.flood_min_stats(*small.operands)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, stats_p = cuda_flood_stats.flood_stats_reference(*small.operands)
    torch.cuda.synchronize()
    k3_plain = 1e3 * (time.perf_counter() - t0)
    k3_err = flood_d2_diff(out_k, out_p, "K3 against its plain version")
    if not torch.equal(stats_k, stats_p):
        raise AssertionError("K3 counters differ from its plain version")
    k3_small_ms = cuda_ms(
        lambda: cuda_flood_stats.flood_min_stats(*small.operands), 5
    )
    # K1 on the same scene: the same output, and its in-ball pairs, which
    # K3 computes too, give K3's bound and issue floor here
    out_1, stats_1 = cuda_flood.flood_min(*small.operands)
    if not torch.equal(out_k, out_1):
        raise AssertionError("K3 differs from K1 at 100k x 300")
    units_small, inball_small = cuda_flood.kernel_operations(stats_1)
    if stats_k[:, cuda_flood_stats.COL_TILES].sum().item() != units_small:
        raise AssertionError("K3's tiles differ from K1's units at 100k x "
                             "300")
    k3_small_bound, k3_small_by = flood_bound_ms(small.operands, inball_small)
    k1_small_ms = cuda_ms(lambda: cuda_flood.flood_min(*small.operands), 5)
    k3_small_floor = issue_floor_ms(inball_small, sms, clock_mhz)
    log(f"K3 flood_stats {K3_PLAIN_POINTS} x {K3_PLAIN_LANDMARKS} "
        f"({small.num_simplices} simplices, "
        f"{small.operands[-1].numel()} pairs): max |d2 diff| {k3_err} "
        f"against the plain version, inf in the same places, counters "
        f"equal (column sums {stats_k.sum(0).tolist()}); output == K1's, "
        f"tiles == K1's {units_small} units, {inball_small} in-ball pairs; "
        f"kernel {k3_small_ms:.3f} ms (K1 {k1_small_ms:.3f} ms), bound "
        f"{k3_small_bound:.3f} ms ({k3_small_by}), issue floor "
        f"{k3_small_floor:.3f} ms (derived); plain {k3_plain:.1f} ms (host "
        f"clock, one run)")
    del small, out_k, stats_k, out_p, stats_p, out_1, stats_1

    # ---- K3 at the main path's shapes, against K1 ---------------------------
    out_k3, stats_k3 = cuda_flood_stats.flood_min_stats(*ops)
    k3_vs_k1 = flood_d2_diff(out_k3, out_k1, "K3 against K1")
    col = stats_k3.sum(0).tolist()
    k3_tiles = col[cuda_flood_stats.COL_TILES]
    k3_subchunks = col[cuda_flood_stats.COL_SUBCHUNKS]
    k3_visited = int(stats_k3[:: cuda_flood.BS, 0].sum())
    if k3_tiles != units:
        raise AssertionError(f"K3 computed {k3_tiles} tiles, K1 admitted "
                             f"{units} units")
    if k3_visited != ops[-1].numel():
        raise AssertionError("K3 visited other pairs than the work-list's")
    # ... and against its plain version on whole blocks of these operands:
    # the blocks with the longest pair lists and blocks spread over the rest
    lens = (ops[-2][1:] - ops[-2][:-1]).cpu().numpy()
    by_len = np.argsort(-lens, kind="stable")
    rest = np.sort(by_len[K3_LONGEST_BLOCKS:])
    blocks = np.concatenate([
        by_len[:K3_LONGEST_BLOCKS],
        rest[np.linspace(0, len(rest) - 1, K3_SPREAD_BLOCKS).astype(int)],
    ])
    sliced, rows = block_slice(ops, blocks.tolist())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, stats_p = cuda_flood_stats.flood_stats_reference(*sliced)
    torch.cuda.synchronize()
    k3_slice_plain = 1e3 * (time.perf_counter() - t0)
    out_s, stats_s = cuda_flood_stats.flood_min_stats(*sliced)
    k3_err_1m = flood_d2_diff(out_k3[rows], out_p,
                              "K3 against its plain version at 1M x 1k")
    flood_d2_diff(out_s, out_p, "K3 on the block slice against plain")
    if not (torch.equal(stats_k3[rows], stats_p)
            and torch.equal(stats_s, stats_p)):
        raise AssertionError("K3 counters at 1M x 1k differ from its plain "
                             "version")
    slice_pairs = sliced[-1].numel()
    log(f"K3 at 1M x 1k against its plain version on {len(blocks)} whole "
        f"blocks ({K3_LONGEST_BLOCKS} with the longest pair lists, "
        f"{slice_pairs} of {ops[-1].numel()} pairs, all {ops[1].shape[0]} "
        f"witnesses): max |d2 diff| {k3_err_1m}, inf in the same places, "
        f"every counter equal (column sums {stats_p.sum(0).tolist()}), in "
        f"the full run and on the slice; plain {k3_slice_plain:.1f} ms "
        f"(host clock, one run)")
    del sliced, rows, out_p, stats_p, out_s, stats_s
    k3_ms = cuda_ms(lambda: cuda_flood_stats.flood_min_stats(*ops), 5)
    k3_bound, k3_by = flood_bound_ms(ops, inball)
    nr = ops[0].shape[1]
    k3_dyn_smem = (nr * rt + 8 * nr) * 4
    log(f"K3 at 1M x 1k: max |d2 diff| {k3_vs_k1} against K1's output; "
        f"{k3_tiles} computed tiles == K1's {units} admitted units; "
        f"{k3_subchunks} admitted (simplex, sub-chunk) units; {k3_visited} "
        f"visited pairs == the work-list's; kernel {k3_ms:.3f} ms (K1 "
        f"{k1_ms:.3f} ms, ratio {k3_ms / k1_ms:.3f}), bound "
        f"{k3_bound:.3f} ms ({k3_by}), issue floor {k1_floor:.3f} ms "
        f"(derived, K1's in-ball pairs); dynamic smem {k3_dyn_smem} bytes a "
        f"CTA")
    del out_k1, out_k3, stats_k3

    # ---- the kernel-stats tool at 1M x 1k -----------------------------------
    cuda_fps.LAUNCHES = cuda_flood.LAUNCHES = cuda_flood_stats.LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = kernel_stats.main(["--points", str(N_POINTS), "--landmarks",
                                str(N_LANDMARKS), "--overhead"])
    tool_s = time.perf_counter() - t0
    tool_launches = {"fps": cuda_fps.LAUNCHES, "flood": cuda_flood.LAUNCHES,
                     "flood_stats": cuda_flood_stats.LAUNCHES}
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"kernel_stats tool record: {json.dumps(rec)}")
    log(f"kernel_stats tool launches (one run): {tool_launches}; "
        f"{tool_s:.2f}s (host clock, scene build included)")
    if rc != 0 or rec["parity_vs_production"] is not True:
        raise AssertionError("kernel_stats tool: no parity with production")
    if tool_launches["flood_stats"] <= 0:
        raise AssertionError("kernel_stats tool: K3 did not run")
    # the tool's scene is the main path's dimension-3 pass
    if (rec["computed_tiles"], rec["worklist_pairs"]) != (k3_tiles,
                                                          k3_visited):
        raise AssertionError("kernel_stats tool: other work than the main "
                             "path's dimension-3 pass")

    # ---- dims: K1 and K3 at 5-8 coordinates -------------------------------
    t_phase = time.perf_counter()
    k1_dim_err, k3_dim_err = {}, {}
    for dim in HIGH_DIMS:
        dops = seeded_flood_operands(dim, dev)
        out_d, stats_d = cuda_flood.flood_min(*dops)
        out_dp, stats_dp = cuda_flood.flood_pairs_reference(*dops)
        k1_dim_err[dim] = flood_d2_diff(out_d, out_dp,
                                        f"K1<{dim}> against its plain version")
        if not torch.equal(stats_d, stats_dp):
            raise AssertionError(f"K1<{dim}> admitted other units than its "
                                 "plain version")
        units_d, inball_d = cuda_flood.kernel_operations(stats_d)
        nr_d, rt_d = dops[0].shape[1:3]
        if not (nr_d >= 2 and 0 < inball_d < units_d * cuda_flood.SUB * rt_d):
            raise AssertionError(f"dim {dim}: operands must give several "
                                 "tiles a simplex and partly masked units")
        out_3, stats_3 = cuda_flood_stats.flood_min_stats(*dops)
        out_3p, stats_3p = cuda_flood_stats.flood_stats_reference(*dops)
        k3_dim_err[dim] = flood_d2_diff(out_3, out_3p,
                                        f"K3<{dim}> against its plain version")
        if not torch.equal(stats_3, stats_3p):
            raise AssertionError(f"K3<{dim}> counters differ from its plain "
                                 "version")
        if not (torch.equal(out_3, out_d) and stats_3[
                :, cuda_flood_stats.COL_TILES].sum().item() == units_d):
            raise AssertionError(f"K3<{dim}> differs from K1<{dim}>")
        log(f"dim {dim}: K1 max |d2 diff| {k1_dim_err[dim]} and K3 "
            f"{k3_dim_err[dim]} against their plain versions, inf in the same "
            f"places, {units_d} admitted units equal, K3 counters equal "
            f"(column sums {stats_3.sum(0).tolist()}), K3 == K1; {nr_d} tiles "
            f"a simplex, {inball_d} in-ball of "
            f"{units_d * cuda_flood.SUB * rt_d} pairs")
    del dops, out_d, stats_d, out_dp, stats_dp, out_3, stats_3, out_3p
    del stats_3p
    # the reference's 5-D grid and 6-D random edge cases, card against CPU
    edge_err = {}
    for case, shape, seed, n_lms, kw in (
            ("5d-grid", (1200, 5), 7, 24, dict(points_per_edge=4)),
            ("6d-random", (800, 6), 8, 16,
             dict(num_rand=32, points_per_edge=None))):
        pts = np.random.default_rng(seed).random(shape).astype(np.float32)
        res = {}
        for d in ("cpu", "cuda"):
            np.random.seed(3)
            k0 = cuda_flood.LAUNCHES
            res[d] = complex_dict(pts, n_lms, d, start_idx=0, **kw)
        if cuda_flood.LAUNCHES == k0:
            raise AssertionError(f"{case}: K1 did not run on the card")
        edge_err[case] = complex_diff(res["cpu"], res["cuda"], 1e-5, case)
        log(f"{case} {shape[0]} x {n_lms}: card == CPU on {len(res['cpu'])} "
            f"simplices (every dimension to {shape[1]}), max |diff| "
            f"{edge_err[case]}")
    # K1 timed on a 5-D cloud
    X5 = torch.rand(DIM5_POINTS, 5, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    L5 = ft.generate_landmarks(X5, DIM5_LANDMARKS, start_idx=0)
    ops5, n5 = top_pass_operands(cuda_flood.CudaFloodEngine(X5), L5,
                                 DIM5_PPE)
    k1_5d_ms = cuda_ms(lambda: cuda_flood.flood_min(*ops5), 5)
    _, stats5 = cuda_flood.flood_min(*ops5)
    units5, inball5 = cuda_flood.kernel_operations(stats5)
    k1_5d_bound, k1_5d_by = flood_bound_ms(ops5, inball5)
    s5, nr5, rt5 = ops5[0].shape[:3]
    log(f"K1<5> at {DIM5_POINTS} x {DIM5_LANDMARKS}, ppe {DIM5_PPE} "
        f"({n5} 5-simplices, {nr5} x {rt5} samples a simplex, "
        f"{ops5[-1].numel()} pairs, {units5} units, {inball5} in-ball pairs, "
        f"{s5 // cuda_flood.BS * nr5} CTAs of {rt5 // 4} threads): kernel "
        f"{k1_5d_ms:.3f} ms, bound {k1_5d_bound:.4f} ms ({k1_5d_by})")
    del X5, L5, ops5, stats5
    log(f"dims phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- float64: K2's double instance and the dense engine -----------------
    t_phase = time.perf_counter()
    ctas64 = cuda_fps.coresident_ctas(3, dtype=torch.float64)
    n_many64 = cuda_fps.FPS_CHUNK * (max(ctas, ctas64) + 5)
    P = torch.rand(n_many64, 3, generator=torch.Generator(dev).manual_seed(11),
                   device=dev).double()
    a = cuda_fps.cuda_farthest_point_sampling(
        P, FPS_MANY_CHUNKS_LANDMARKS, 3).cpu().numpy()
    b = farthest_point_sampling(P, FPS_MANY_CHUNKS_LANDMARKS, 3).cpu().numpy()
    fps64_err_many = check_same_greedy(P, a, b, 3)
    log(f"K2 float64 fps {n_many64} x {FPS_MANY_CHUNKS_LANDMARKS} "
        f"({n_many64 // cuda_fps.FPS_CHUNK} chunks on {ctas64} co-resident "
        f"CTAs): same greedy selection as the plain version, max |step d2 "
        f"diff| {fps64_err_many}")
    del P
    X64 = X.double()
    a = cuda_fps.cuda_farthest_point_sampling(X64, N_LANDMARKS, 0)
    b = farthest_point_sampling(X64, N_LANDMARKS, 0)
    fps64_err = check_same_greedy(X64, a.cpu().numpy(), b.cpu().numpy(), 0)
    prep64 = cuda_fps._fps_prepare(X64, 0)
    k2_64_ms = cuda_ms(lambda: cuda_fps.fps_kernel_run(prep64, N_LANDMARKS), 5)
    visits64 = int(cuda_fps.last_visits.item())
    k2_64_plain = cuda_ms(
        lambda: farthest_point_sampling(X64, N_LANDMARKS, 0), 1)
    fps64_ops = FPS_OPS_PER_POINT * visits64 * cuda_fps.FPS_CHUNK
    fps64_bytes = X64.numel() * 8 + N_LANDMARKS * 4
    k2_64_bound = 1e3 * max(fps64_ops / PEAK_FP64, fps64_bytes / PEAK_BYTES)
    k2_64_by = ("operations" if fps64_ops / PEAK_FP64 >= fps64_bytes /
                PEAK_BYTES else "bytes")
    del prep64
    log(f"K2 float64 at 1M x 1k: same greedy selection as the plain version "
        f"(max |step d2 diff| {fps64_err}); greedy loop {k2_64_ms:.3f} ms "
        f"({1e3 * k2_64_ms / (N_LANDMARKS - 1):.2f} us per greedy step; "
        f"float32 {k2_ms:.3f} ms, {1e3 * k2_ms / (N_LANDMARKS - 1):.2f} us); "
        f"{visits64} chunk visits; plain {k2_64_plain:.1f} ms; bound "
        f"{k2_64_bound:.4f} ms ({k2_64_by}, fp64 peak {PEAK_FP64 / 1e12:.0f} "
        "TFLOP/s)")
    # flood_complex in float64 (dense engine) against float32 (K1), on the
    # reference's test_float64 clouds
    f64_err = {}
    for cloud in ("torus", "cheese"):
        if cloud == "torus":
            P32 = ft.generate_noisy_torus_points_3d(F64_POINTS, seed=11,
                                                    device=dev)
        else:
            P32 = ft.generate_swiss_cheese_points(F64_POINTS, seed=11,
                                                  device=dev)[0]
        L32 = ft.generate_landmarks(P32, F64_LANDMARKS, start_idx=0)
        f32 = complex_dict(P32, L32, "cuda")
        f64 = complex_dict(P32.double(), L32.double(), "cuda")
        f64_err[cloud] = complex_diff(f32, f64, 3e-6,
                                      f"float64 against float32 ({cloud})")
        log(f"float64 {cloud} {F64_POINTS} x {F64_LANDMARKS}, ppe {PPE}: "
            f"dense engine on the card == K1 route in float32 on "
            f"{len(f32)} simplices, max |diff| {f64_err[cloud]}")
    C32 = ft.generate_swiss_cheese_points(DENSE_POINTS, k=6, seed=42,
                                          device=dev)[0]
    C64 = C32.double()
    n0 = cuda_fps.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c64 = complex_dict(C64, DENSE_LANDMARKS, "cuda")
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    if cuda_fps.LAUNCHES != n0 + 1:
        raise AssertionError("float64 flood_complex did not run K2 once")
    if not np.isfinite(list(c64.values())).all():
        raise AssertionError("float64 100k x 300: non-finite values")
    log(f"float64 flood_complex {DENSE_POINTS} x {DENSE_LANDMARKS}, ppe "
        f"{PPE} (K2 double, dense engine on the card, engine built in the "
        f"run): {f64_s:.3f}s host clock, {len(c64)} simplices, all finite")
    del C64, c64
    log(f"float64 phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- dense: use_pallas=False in float32 against the kernel route -------
    t_phase = time.perf_counter()
    LC = ft.generate_landmarks(C32, DENSE_LANDMARKS, start_idx=0)
    k1_route = complex_dict(C32, LC, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_route = complex_dict(C32, LC, "cuda", use_pallas=False)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_err = complex_diff(k1_route, dense_route, 1e-5,
                             "use_pallas=False against the kernel route")
    n_inf = sum(np.isinf(v) for v in k1_route.values())
    log(f"dense {DENSE_POINTS} x {DENSE_LANDMARKS}, ppe {PPE}: "
        f"use_pallas=False on the card == K1 route on {len(k1_route)} "
        f"simplices ({n_inf} inf), max |diff| {dense_err}; dense run "
        f"{dense_s:.3f}s host clock (engine built in the run)")
    del C32, LC, k1_route, dense_route
    log(f"dense phase: {time.perf_counter() - t_phase:.1f}s")

    no_lib = "none: no single PyTorch call computes this function"
    kernels = [
        {
            "name": "flood_min", "route": "cuda",
            "source": "flooder_tpu_torch/csrc/flood.cu",
            "replaces": "flooder_tpu/ops/pallas_flood.py:333",
            "launches": launches["flood"], "max_abs_err": flood_err,
            "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None, "library_note": no_lib,
            "admitted_units": units, "inball_pairs": inball,
            "ms_at_100k_x_300": k1_small_ms,
            "bound_ms_at_100k_x_300": k3_small_bound,
            "max_abs_err_by_dim": {str(d): e for d, e in k1_dim_err.items()},
            "ms_5d_200k_x_64": k1_5d_ms, "bound_ms_5d_200k_x_64": k1_5d_bound,
            "bound_by_5d": k1_5d_by,
        },
        {
            "name": "fps", "route": "cuda",
            "source": "flooder_tpu_torch/csrc/fps.cu",
            "replaces": "flooder_tpu/ops/pallas_fps.py:66",
            "launches": launches["fps"],
            "max_abs_err": fps_err, "ms": k2_ms,
            "ms_with_prepare": k2_total, "plain_ms": k2_plain,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
            "library_note": no_lib, "chunk_visits": visits,
            "us_per_step": 1e3 * k2_ms / (N_LANDMARKS - 1),
            "max_abs_err_many_chunks": fps_err_many,
            "max_abs_err_float64": fps64_err,
            "max_abs_err_float64_many_chunks": fps64_err_many,
            "ms_float64": k2_64_ms,
            "us_per_step_float64": 1e3 * k2_64_ms / (N_LANDMARKS - 1),
            "plain_ms_float64": k2_64_plain, "bound_ms_float64": k2_64_bound,
            "bound_by_float64": k2_64_by, "chunk_visits_float64": visits64,
        },
        {
            "name": "flood_min_stats", "route": "cuda",
            "source": "flooder_tpu_torch/csrc/flood_stats.cu",
            "replaces": "tools/kernel_stats.py:55",
            "launches": tool_launches["flood_stats"],
            "max_abs_err": k3_err_1m, "max_abs_err_vs_k1": k3_vs_k1,
            "max_abs_err_at_plain_shape": k3_err, "ms": k3_ms,
            "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
            "library_ms": None, "library_note": no_lib,
            "plain_shape": f"{K3_PLAIN_POINTS} x {K3_PLAIN_LANDMARKS}",
            "ms_at_plain_shape": k3_small_ms,
            "bound_ms_at_plain_shape": k3_small_bound,
            "plain_check_blocks": len(blocks),
            "plain_check_pairs": slice_pairs,
            "plain_ms_on_blocks": k3_slice_plain,
            "computed_tiles": k3_tiles, "admitted_subchunks": k3_subchunks,
            "visited_pairs": k3_visited,
            "max_abs_err_by_dim": {str(d): e for d, e in k3_dim_err.items()},
        },
    ]
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
