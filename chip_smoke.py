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
  (template instances, d2 within 1e-6) and at 9, 12, 16, 37, 38, 40 and 64
  (the runtime-width instance, d2 within 2 * dim * 2**-24 * d2, the bound
  of two fp32 summation orders: one FMA a coordinate against separate
  rounding; +inf from 38 on) on seeded operands with several tiles a
  simplex and balls that cut sub-chunks; every count exact and K3 == K1
  bit for bit; the reference's 5-D grid and 6-D random
  edge cases through
  ``flood_complex`` on the card against the CPU run; the pair loop of
  every K1 and K3 instance read from the SASS.
- few (K1's few-sample instances, tiles of 128 samples up to 384 samples
  a simplex, a warp a tile): against their plain version at 3 and 5
  coordinates with 1, 64, 126 and 256 samples a simplex (d2 within 1e-6,
  inf in place, every count equal); K1 timed on a 200k 5-D cloud at 5
  points per edge (126 samples a 5-simplex); random mode (num_rand 64 and
  256, ``np.random.seed`` fixed) on the main path's 1M x 1k cloud through
  flood_complex and persistence, with the launch counters set to 0 just
  before each run and read just after, its stages fenced, each pass's K1
  timed on its own operands and held against its plain version on two
  whole blocks, and random mode against the dense engine on the 100k x
  300 cut (within 1e-5). Bounds and issue floors count real sample rows
  only; the launch's CTAs, derived occupancy, units and in-ball pairs on
  real samples and on all slots are printed. Past 8 coordinates
  (few_wide_grid) it holds flood_min_few_wide (9-16) and
  flood_min_few_slabs (17 and more) on seeded operands at 9-64
  coordinates with 1-384 samples a simplex against their plain version
  (the runtime-width bar, inf in place, every count equal), against
  flood_min_wide on the same 128-sample tiles (bit for bit, the same
  counts) and against K3 (bit for bit, its tiles equal to K1's units).
  ``--only few`` runs the build and this phase alone.
- float64: K2's double instance against its plain version on the
  many-chunks cloud and the 1M cheese (1000 landmarks), timed beside
  float32; ``flood_complex`` in float64 (dense engine) against the float32
  kernel route on the two 3,000 x 150 clouds of the reference's
  test_float64, and timed on the 100k x 300 cheese.
- dense: ``use_pallas=False`` in float32 against the kernel route on the
  100k x 300 cheese, timed.
- wide (the runtime-width instances): generate_landmarks (K2) at 9, 12,
  16, 40 and 100 coordinates, K2 against its plain version there and at
  64 coordinates in float32 and 16 in float64, and timed at
  1,000,000 uniform points (``--seed``) of 64 coordinates in float32 and
  16 in float64; K3 beside K1 at 64 coordinates; and the slice's path, a
  1,000,000-point 10-D swiss cheese (seed 42) through generate_landmarks,
  flood_complex (24 landmarks, max_dimension 3, grid mode, points per edge
  30 lowered to 15, and to 10 if K1's launch passes 20 s, each cut
  printed) and persistence, with the launch counters set to 0 just before
  it and read just after and its stages fenced; then K1's time and
  in-ball pairs from the path's own launch (printed first, with its
  issue floor from the SASS pair loop, the in-ball share of admitted
  witness slots and the launch order's tail, derived from the per-CTA
  in-ball pairs), K2's picks against its plain version on the path's
  cloud, K1's plain version on two whole blocks of that launch (the
  longest and one from the middle; the runtime-width bar, counts exact),
  a finite, monotone filtration with one essential H0 class, random
  mode on the same cloud and landmarks (wide_random_mode: num_rand 64 and
  256, ``np.random.seed`` fixed, the launch counters set to 0 just before
  each run and read just after: one K2 launch and four few-sample K1
  launches; each pass's K1 timed beside flood_min_wide on the same
  operands, equal to it bit for bit, and held against its plain version
  on two whole blocks; the diagram sizes printed), and the kernel route
  against the dense engine on a 100,000-point cut. ``--only few_wide``
  runs the build, the few phase's blocks past 8 coordinates and this
  random mode alone.

The cli phase (after the main path) saves the main path's cloud to a
``.npy`` and runs ``python -m flooder_tpu_torch.cli`` on it twice as a
subprocess, with the default device, the second time with
``--trace-dir``: its diagrams must equal the main path's within 1e-6, its
metadata and step stats must show the card, and its trace must hold K1
and K2. From the trace it prints the device busy share of the
Flood-complex step (the union of GPU kernel, memcpy and memset intervals
over the step's window); it also traces one warm main-path run in this
process the same way.

The mesh phase (``flooder_tpu_torch.parallel``, one process over a grid of
devices; the meshes name ``cuda:0`` several times) holds the 2x2, 1x3
and 4x1 meshes of the card against the same meshes on the CPU (K1's plain
version in every shard) on a 20,000-point torus in grid and random mode,
and the dense and float64 2x2 meshes the same way; then it drives the
main path's 1M x 1k through 2x2, 1x4 and 1x3 meshes: each complex and its
diagrams must equal the main path's, K1 must launch once per shard, and it
prints the fenced time beside one card's and the per-shard balance and K1
time with the LPT assignment and with the contiguous split. The examples
phase runs each of ``flooder_tpu_torch/examples`` with ``--small`` on the
card.

Each kernel instance's SASS is printed as a digest (``sass_digests``), so
two builds can be compared instance by instance; the build section also
compares them with REFERENCE_DIGESTS, those of every instance that existed
before the few-sample instances past 8 coordinates.

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
L2_BYTES = 50e6  # H100 L2 cache (NVIDIA data sheet)
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
# K1 and K3 held against their plain versions: template instances at 5-8
# coordinates, the runtime-width instance past 8 (37 and 38: a masked d2 is
# finite at 37 coordinates and +inf from 38 on)
WIDE_DIMS = (9, 12, 16, 37, 38, 40, 64)
HIGH_DIMS = (5, 6, 8) + WIDE_DIMS
DIM5_POINTS, DIM5_LANDMARKS, DIM5_PPE = 200_000, 64, 5  # K1 timed at 5-D
# few phase: K1's few-sample instances (tiles of 128 samples, a warp a tile)
# against their plain version on seeded operands of R samples a simplex,
# and random mode on the main path's cloud (np.random.seed before each run)
FEW_DIMS, FEW_R = (3, 5), (1, 64, 126, 256)
FEW_NUM_RAND = (64, 256)
FEW_WEIGHT_SEED = 0
# ... and past 8 coordinates (flood_min_few_wide at 9-16, flood_min_few_slabs
# past 16), also against flood_min_wide on the same tiles and K3
FEW_WIDE_DIMS, FEW_WIDE_R = (9, 12, 16, 17, 37, 38, 40, 64), (1, 64, 126,
                                                              256, 384)
F64_LANDMARKS = 150  # the reference's test_float64 clouds: 3000 x 150
F64_POINTS = 3000
DENSE_POINTS, DENSE_LANDMARKS = 100_000, 300  # float64 and dense timing
# mesh phase: small meshes on the card against the CPU ((devices, simplex
# axis) requests), and meshes of the one card at the main path's size
MESH_SMALL_POINTS, MESH_SMALL_LANDMARKS, MESH_SMALL_PPE = 20_000, 120, 8
MESH_NUM_RAND = 64
MESH_SMALL = ((4, 2), (3, 1), (4, 4))  # 2x2, 1x3, 4x1
MESH_FULL = ((4, 2), (4, 1), (3, 1))  # 2x2, 1x4, 1x3
# wide phase: generate_landmarks past 8 coordinates, K2 against its plain
# version ((dim, dtype, points), 256 landmarks), and at full size (1M
# uniform points from --seed, 1000 landmarks from index 0), against its
# plain version there too
WIDE_FPS_CHECKS = ((9, "float32", 100_000), (12, "float32", 100_000),
                   (16, "float32", 200_000), (40, "float32", 100_000),
                   (100, "float32", 100_000))
WIDE_FPS_CHECK_LANDMARKS = 256
WIDE_FPS_FULL = ((64, "float32"), (16, "float64"))
# the slice's path: a 1M-point 10-D swiss cheese (seed 42), 24 FPS landmarks
# from index 0, max_dimension 3, grid mode. Points per edge: 30 is asked
# for, and lowered (30 -> 15 -> 10) while the path's K1 launch passes
# WIDE_K1_LIMIT_S. 30 is cut without a launch: it has 5x the samples a
# simplex of 15 (5,120 against 1,024), and the run prints that projection
# from its own launch at 15, an upper estimate (10 -> 15, 4x the samples,
# took 2.4x the time on an H100; at that rate 30 still takes ~2.8x).
WIDE_POINTS, WIDE_DIM, WIDE_LANDMARKS, WIDE_TOP_DIM = 1_000_000, 10, 24, 3
WIDE_PPE_ASKED, WIDE_PPE_CUTS = 30, (15, 10)
WIDE_K1_LIMIT_S = 20.0
WIDE_LONGEST_BLOCKS, WIDE_SPREAD_BLOCKS = 1, 1  # K1's plain check, blocks
WIDE_CUT_POINTS, WIDE_CUT_PPE = 100_000, 5  # against the dense engine
# random mode on the 10-D path's cloud and landmarks (np.random.seed fixed):
# each pass's K1 timed beside flood_min_wide on the same tiles
WIDE_NUM_RAND, WIDE_RANDOM_REPS = (64, 256), 3
# SASS digests (sass_digests) of every instance that existed before the
# few-sample instances past 8 coordinates, as CUDA 12.8's nvcc built them
# for sm_90a: the build section prints how this build compares
REFERENCE_DIGESTS = {
    "flood": {
        "flood_min_few<8>": "c356c54beddd",
        "flood_min_few<7>": "f9e2aefb3c69",
        "flood_min_few<6>": "a17c3751e325",
        "flood_min_few<5>": "b4b514cc599c",
        "flood_min_few<4>": "844f5e1def53",
        "flood_min_few<3>": "ab610fa739fa",
        "flood_min_few<2>": "2832d1d71fba",
        "flood_min_few<1>": "f4304b0aa3ce",
        "flood_min_kernel<8>": "475e3a84b9b0",
        "flood_min_kernel<7>": "b95d9b5fcb2a",
        "flood_min_kernel<6>": "ed27c15613e9",
        "flood_min_kernel<5>": "532678c958f2",
        "flood_min_kernel<4>": "e5ad70430529",
        "flood_min_kernel<3>": "7358e95274b5",
        "flood_min_kernel<2>": "7af48e90aacb",
        "flood_min_kernel<1>": "d7e52a1200e8",
        "flood_min_wide": "f20020c5e5ae"},
    "fps": {
        "fps_loop<float,8>": "c47e0cece738",
        "fps_loop<float,7>": "445d4ade0caa",
        "fps_loop<float,6>": "2edf27b06b81",
        "fps_loop<float,5>": "3c4fd6d19b0d",
        "fps_loop<float,4>": "c5d52a15e22e",
        "fps_loop<float,3>": "6215bae82232",
        "fps_loop<float,2>": "c72fd876063f",
        "fps_loop<float,1>": "10b82d0d1fd0",
        "fps_loop<float,wide>": "9707ce1a4d6c",
        "fps_loop<double,8>": "033a21200d3b",
        "fps_loop<double,7>": "8ac5da1d15da",
        "fps_loop<double,6>": "d42a32eae713",
        "fps_loop<double,5>": "54005e9e4218",
        "fps_loop<double,4>": "d8d2eefa8ede",
        "fps_loop<double,3>": "f02c595c80c4",
        "fps_loop<double,2>": "ec264959f0b9",
        "fps_loop<double,1>": "7d4f6607db60",
        "fps_loop<double,wide>": "f1c8db0037b8"},
    "flood_stats": {
        "flood_stats_kernel<8>": "e29499754c13",
        "flood_stats_kernel<7>": "0850bd07586b",
        "flood_stats_kernel<6>": "792cf99fc546",
        "flood_stats_kernel<5>": "4f2ea6c7aca9",
        "flood_stats_kernel<4>": "f12114e28f98",
        "flood_stats_kernel<3>": "545fbe0d78c7",
        "flood_stats_kernel<2>": "07628a0463e6",
        "flood_stats_kernel<1>": "72492b9bfb21",
        "flood_stats_wide": "f1f671579639"}}


def log(msg):
    print(f"# {msg}", flush=True)


def card_line(fields="name,power.limit"):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm_up=True):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events, after
    one warm-up run unless ``warm_up`` is false: for launches of seconds,
    whose kernel is already loaded)."""
    import torch

    if warm_up:
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
    if np.array_equal(a, b):
        return 0.0  # the same picks: the same distance at every step
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


def wide_d2_diff(out_k, out_p, dim, what):
    """A runtime-width kernel's output against its plain version: no-witness
    entries (>= 1e30) and +inf in the same places, and every other d2
    within 2 * dim * 2**-24 * d2 of the plain one, the fp32 bound of two
    summation orders of dim terms (the kernel's one FMA a coordinate, the
    plain version's separately rounded products and sums). Returns (max
    |d2 diff|, its largest share of the bar)."""
    import torch

    from flooder_tpu_torch.ops.cuda_flood import _MASKED_D2

    masked = out_p >= _MASKED_D2
    if not (torch.equal(out_k >= _MASKED_D2, masked)
            and torch.equal(torch.isinf(out_k), torch.isinf(out_p))):
        raise AssertionError(f"{what}: no-witness (inf) entries differ")
    a, b = out_k[~masked].double(), out_p[~masked].double()
    diff = (a - b).abs()
    bar = 2 * dim * 2.0**-24 * b
    if bool((diff > bar).any()):
        worst = int(torch.argmax(diff - bar))
        raise AssertionError(f"{what}: |d2 diff| {diff[worst].item()} > "
                             f"{bar[worst].item()} at d2 {b[worst].item()}")
    if diff.numel() == 0:
        return 0.0, 0.0
    share = torch.where(bar > 0, diff / bar, torch.zeros_like(diff))
    return diff.max().item(), share.max().item()


def seeded_flood_operands(dim, device, r_count=1100, radius_max=3.0,
                          seed=7):
    """K1's operands at ``dim`` coordinates from ``CudaFloodEngine.prepare``
    (as tests/test_torch_cuda.py builds them): 16,384 uniform witnesses in
    [0, 5]^dim, 4 blocks of random simplices, radii in [0.1, radius_max)
    (past 8 coordinates, where such balls hold no witness, the distance of
    the 2nd to 299th nearest witness) with every fourth 1e-5 (it meets
    boxes but holds no witness), 1100 samples (3 tiles a simplex), the
    nearest-vertex bound on."""
    import torch

    from flooder_tpu_torch.ops import cuda_flood

    rng = np.random.default_rng(seed + dim)
    X = (rng.random((16384, dim)) * 5).astype(np.float32)
    eng = cuda_flood.CudaFloodEngine(torch.from_numpy(X).to(device))
    S, k = cuda_flood.BS * 4, dim + 1
    centers = (rng.random((S, dim)) * 5).astype(np.float32)
    radii = (rng.random(S) * (radius_max - 0.1) + 0.1).astype(np.float32)
    if dim > cuda_flood.KERNEL_MAX_DIM:
        d = np.sort(np.linalg.norm(X[None] - centers[:, None], axis=-1), 1)
        radii = d[np.arange(S), rng.integers(2, 300, S)].astype(np.float32)
    radii[::4] = 1e-5
    verts = centers[:, None, :] + (
        rng.random((S, k, dim)).astype(np.float32) - 0.5) * 0.3
    w = rng.random((r_count, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return eng.prepare(t(verts), w, t(centers), t(radii), True)[0]


def top_pass_inputs(engine, landmarks, ppe):
    """What flood_complex hands an engine in its top-dimension pass (grid
    mode): the top simplices' vertices, the grid weights, and their balls'
    centers and radii, in the engine's visit order."""
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
    return verts[order], _grid_host(ppe, dim)[0], centers[order], radii[order]


def top_pass_operands(engine, landmarks, ppe, tight=True):
    """The operands flood_complex hands kernel K1 in its top-dimension pass
    (grid mode), and the number of top simplices."""
    operands, _, num = engine.prepare(
        *top_pass_inputs(engine, landmarks, ppe), tight)
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
    (instance, instructions of its pair loop, fp32 instructions a pair
    (template instances) or a pair and coordinate (runtime width), LDS in
    it, local-memory accesses in it, local-memory accesses in the whole
    kernel). A template instance's pair loop is the innermost backward
    branch whose body holds 16 FMNMX and FFMA, the inner loop of
    min_over_staged (4 witnesses x 4 samples): its FADD, FMUL, FFMA and
    FMNMX over 16. A runtime-width instance's is the innermost one with
    64 FFMA or more and no FMNMX, the coordinate loop of wide_accumulate
    (8 samples x 8 witnesses, one FFMA a pair and coordinate): its FADD,
    FMUL and FFMA over its FFMA. None where the toolkit has no
    cuobjdump."""
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
        wide = name.endswith("_wide")
        best = None
        for addr, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            mnmx, ffma = (sum(_op(o) == k for o in body)
                          for k in ("FMNMX", "FFMA"))
            if ((mnmx == 0 and ffma >= 64) if wide else
                    (mnmx == 16 and ffma > 0)) and (
                    best is None or len(body) < len(best)):
                best = body
        per = None
        if best:
            fp32 = sum(_op(o) in ("FADD", "FMUL", "FFMA", "FMNMX")
                       for o in best)
            per = fp32 / (sum(_op(o) == "FFMA" for o in best) if wide
                          else 16)
        rows.append((name, len(best) if best else None, per,
                     sum(_op(o) == "LDS" for o in best) if best else None,
                     _local_accesses(best) if best else None,
                     _local_accesses(o for _, o in ins)))
    return rows


def _op(ins):
    """The opcode of a SASS instruction without its modifiers and
    predicate, e.g. ``FFMA`` or ``LDS``."""
    words = ins.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_digests(lib_path):
    """{instance: sha1 of its SASS} of a built library, from ``cuobjdump
    -sass`` with the addresses and encodings dropped: two builds whose
    instance has the same digest compiled it to the same instructions.
    None where the toolkit has no cuobjdump."""
    import hashlib

    from torch.utils.cpp_extension import CUDA_HOME

    from flooder_tpu_torch.native.build import kernel_instance

    exe = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                    "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = kernel_instance(block.split(None, 1)[0])
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)
        body = "\n".join(" ".join(i.split()) for i in ins)
        out[name] = hashlib.sha1(body.encode()).hexdigest()[:12]
    return out


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
    """(instance, shared bytes a CTA, resident CTAs and warps an SM) of a
    flood kernel's instances at ``threads`` a CTA; ``dyn_smem(dim)`` is the
    dynamic shared memory a CTA asks for."""
    rows = []
    for name, regs, _, smem in ptxas_rows:
        if name.startswith(kernel + "<"):
            dim = int(name[len(kernel) + 1:-1])
            total = smem + dyn_smem(dim)
            ctas = resident_ctas(regs, total, threads)
            rows.append((name, total, ctas, ctas * threads // 32))
    return rows


def issue_floor_ms(inball_pairs, sms, clock_mhz,
                   instr_per_pair=FLOOD_INSTR_PER_PAIR):
    """Derived issue floor of K1 and K3: ``instr_per_pair`` fp32
    instructions per in-ball pair (FLOOD_INSTR_PER_PAIR at 3 coordinates)
    over the card's fp32 lanes at the max SM clock."""
    return 1e3 * instr_per_pair * inball_pairs / (
        sms * FP32_LANES_PER_SM * clock_mhz * 1e6)


def wide_occupancy(build):
    """(instance, dim, nr, registers, shared bytes a CTA, CTAs and warps an
    SM) of the runtime-width instances at rt 512 (256 threads a CTA) on the
    10-D path's width and at 64 coordinates (K3 at nr 10), and of K1's
    few-sample ones at rt 128 (FEW_WIDE_WARPS warps a CTA) at 10, 16 and 64,
    from the ptxas lines and the kernels' own shared-memory sizes; empty
    when this process built neither library (no ptxas lines)."""
    import ctypes

    lib = build.load_cuda("flood")
    lib.flood_wide_smem_bytes.restype = ctypes.c_longlong
    lib.flood_wide_smem_bytes.argtypes = [ctypes.c_int]
    slib = build.load_cuda("flood_stats")
    slib.flood_stats_wide_smem_bytes.restype = ctypes.c_longlong
    slib.flood_stats_wide_smem_bytes.argtypes = [ctypes.c_int] * 2
    regs = {name: (r, sm) for text in build.BUILD_LOG.values()
            for name, r, _, sm in build.ptxas_kernels(text)}
    if not {"flood_min_wide", "flood_stats_wide"} <= regs.keys():
        return []
    rows = []
    for dim in (WIDE_DIM, max(WIDE_DIMS)):
        for name, nr, dyn in (
                ("flood_min_wide", 1, lib.flood_wide_smem_bytes(dim)),
                ("flood_stats_wide", 10,
                 slib.flood_stats_wide_smem_bytes(dim, 10))):
            r, static = regs[name]
            ctas = resident_ctas(r, static + dyn, 256)
            rows.append((name, dim, nr, r, static + dyn, ctas, ctas * 8))
    # the few-sample instances (FEW_WIDE_WARPS warps a CTA) at 10 and 16
    # coordinates (one slab) and 64 (slabs)
    from flooder_tpu_torch.ops import cuda_flood

    threads = 32 * getattr(cuda_flood, "FEW_WIDE_WARPS", 0)
    for dim in (WIDE_DIM, 16, max(WIDE_DIMS)):
        name = threads and cuda_flood.k1_instance(cuda_flood.FEW_RT, dim)
        if name in regs:
            r, static = regs[name]
            total = static + k1_dyn_smem(name, dim)
            ctas = resident_ctas(r, total, threads)
            rows.append((name, dim, 1, r, total, ctas,
                         ctas * threads // 32))
    return rows


def launch_order_tail(stats, blk_ptr, slots):
    """The tail of K1's launch order, derived (not measured): each CTA's
    in-ball pairs, taken as its duration, list-scheduled in launch order
    (longest work-list first) on ``slots`` resident CTAs; returns the
    makespan over the mean slot's work (1.0 for a perfect balance)."""
    import heapq

    from flooder_tpu_torch.ops.cuda_flood import _cta_order

    nr = stats.shape[0] // (blk_ptr.numel() - 1)
    work = stats[:, 1].reshape(-1, nr)[_cta_order(blk_ptr).long()]
    load = [0.0] * slots
    for w in work.reshape(-1).double().tolist():
        heapq.heappush(load, heapq.heappop(load) + w)
    return max(load) / (sum(load) / slots)


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


def real_pairs(stats, nr, rt, r_count):
    """K1's in-ball pairs on real sample rows: the stats count every slot of
    a tile, and the slots past ``r_count`` repeat the last real row."""
    per_tile = stats[:, 1].reshape(-1, nr).sum(0).tolist()
    return sum(p // rt * min(rt, r_count - r * rt)
               for r, p in enumerate(per_tile))


def k1_launch_shape(ops, tiled=False):
    """(instance, CTAs, threads a CTA) of K1's launch on these operands: the
    instance ``cuda_flood.k1_instance`` names (a checkout without it: the
    few-sample instance for tiles of FEW_RT samples at 1-8 coordinates, else
    the instance for tiles of up to 512), or with ``tiled`` the latter, as
    ``cuda_flood.flood_min_tiled`` launches it."""
    from flooder_tpu_torch.ops import cuda_flood

    s_total, nr, rt, dim = ops[0].shape
    n_blk = s_total // cuda_flood.BS
    if tiled:
        inst = ("flood_min_wide" if dim > cuda_flood.KERNEL_MAX_DIM
                else f"flood_min_kernel<{dim}>")
    elif hasattr(cuda_flood, "k1_instance"):
        inst = cuda_flood.k1_instance(rt, dim)
    elif dim > cuda_flood.KERNEL_MAX_DIM:
        inst = "flood_min_wide"
    elif rt == getattr(cuda_flood, "FEW_RT", None):
        inst = f"flood_min_few<{dim}>"
    else:
        inst = f"flood_min_kernel<{dim}>"
    if inst.startswith("flood_min_few"):
        warps = (cuda_flood.FEW_WARPS if dim <= cuda_flood.KERNEL_MAX_DIM
                 else cuda_flood.FEW_WIDE_WARPS)
        return inst, -(-n_blk * cuda_flood.BS * nr // warps), 32 * warps
    if inst == "flood_min_wide":
        return inst, n_blk * nr, rt // 2
    return inst, n_blk * nr, rt // 4


def k1_env():
    """What K1's launch records read of this build and card: SMs, the max SM
    clock, each instance's fp32 instructions a pair (a pair and coordinate
    past 8 coordinates) from its SASS pair loop, and its ptxas row."""
    import torch

    from flooder_tpu_torch.native import build

    return dict(
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        clock_mhz=float(card_line("clocks.max.sm").split()[0]),
        loops={r[0]: r[2] for r in sass_pair_loops(
            build.cuda_library("flood")) or () if r[2]},
        ptxas={row[0]: row[1:] for text in build.BUILD_LOG.values()
               for row in build.ptxas_kernels(text)})


def k1_dyn_smem(inst, dim):
    """Dynamic shared memory a CTA of K1's instance asks for."""
    import ctypes

    from flooder_tpu_torch.native import build
    from flooder_tpu_torch.ops import cuda_flood

    if inst == "flood_min_kernel<8>":
        return cuda_flood.SUB * 8 * 4  # its raw buffer
    name = {"flood_min_wide": "flood_wide_smem_bytes",
            "flood_min_few_wide": "flood_few_wide_smem_bytes",
            "flood_min_few_slabs": "flood_few_wide_smem_bytes"}.get(inst)
    if name is None:
        return 0
    fn = getattr(build.load_cuda("flood"), name)
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int]
    return int(fn(dim))


def launch_record(ops, stats, r_count, env, tiled=False):
    """K1's launch on these operands (``tiled``: as k1_launch_shape): its
    shape, derived occupancy, work (units, in-ball pairs on real samples and
    on all slots), bound and issue floor, both on real samples. Returns
    (record, text)."""
    from flooder_tpu_torch.ops import cuda_flood

    inst, ctas, threads = k1_launch_shape(ops, tiled)
    s_total, nr, rt, dim = ops[0].shape
    units, padded = cuda_flood.kernel_operations(stats)
    real = real_pairs(stats, nr, rt, r_count)
    bound, by = flood_bound_ms(ops, real)
    per = env["loops"].get(inst)
    wide = dim > cuda_flood.KERNEL_MAX_DIM
    instr = (per * dim + 1 if wide else per) if per else 2 * dim + 1
    floor = issue_floor_ms(real, env["sms"], env["clock_mhz"], instr)
    occ = "not derived (no ptxas lines in this process)"
    if inst in env["ptxas"]:
        regs, _, smem = env["ptxas"][inst]
        smem += k1_dyn_smem(inst, dim)
        per_sm = resident_ctas(regs, smem, threads)
        occ = (f"{per_sm} CTAs, {per_sm * threads // 32} warps an SM "
               f"({regs} registers, {smem} shared bytes a CTA)")
    text = (f"{inst}, {ctas} CTAs of {threads} threads ({nr} x {rt} "
            f"slots a simplex for {r_count} samples; derived occupancy "
            f"{occ}), {units} units, {real} in-ball pairs on real samples "
            f"({padded} on all slots), bound {bound:.4f} ms ({by}), issue "
            f"floor {floor:.4f} ms ({instr:g} fp32 instructions a pair, real "
            "samples)")
    return dict(instance=inst, ctas=ctas, threads=threads, units=units,
                inball_real=real, inball_slots=padded, bound_ms=bound,
                bound_by=by, issue_floor_ms=floor), text


def random_mode_run(X, landmarks, num_rand, top_dim, what):
    """flood_complex in random mode (``np.random.seed(FEW_WEIGHT_SEED)``,
    ``landmarks`` a count: K2 picks them) and persistence, with the launch
    counters set to 0 just before and read just after, the stages fenced
    and K1's launches kept where the engine makes them. Fails unless K2 ran
    once and K1 once a pass through its few-sample instances, and the
    filtration is finite and monotone with one essential H0 class. Returns
    dict(calls [(ops, (out, stats))], launches, complex_s, persistence_s,
    stage_split_s, simplices, bars)."""
    import torch

    import flooder_tpu_torch as ft
    from flooder_tpu_torch.ops import cuda_flood, cuda_fps
    from flooder_tpu_torch.utils import stagetimer

    k1 = cuda_flood.flood_min
    calls = []

    def flood_min_kept(*ops):
        res = k1(*ops)
        calls.append((ops, res))
        return res

    # a checkout whose few-sample instances take these tiles counts them
    few_count = hasattr(cuda_flood, "FEW_LAUNCHES") and (
        X.shape[1] <= cuda_flood.KERNEL_MAX_DIM
        or hasattr(cuda_flood, "k1_instance"))
    cuda_fps.LAUNCHES = cuda_flood.LAUNCHES = 0
    if few_count:
        cuda_flood.FEW_LAUNCHES = 0
    np.random.seed(FEW_WEIGHT_SEED)
    torch.cuda.synchronize()
    buf = io.StringIO()
    stagetimer.ENABLED, cuda_flood.flood_min = True, flood_min_kept
    try:
        with contextlib.redirect_stderr(buf):
            t0 = time.perf_counter()
            stree = ft.flood_complex(X, landmarks, num_rand=num_rand,
                                     points_per_edge=None,
                                     max_dimension=top_dim,
                                     return_simplex_tree=True)
            t1 = time.perf_counter()
            stree.compute_persistence()
            diagrams = [stree.persistence_intervals_in_dimension(i)
                        for i in range(min(top_dim, 3))]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        stagetimer.ENABLED, cuda_flood.flood_min = False, k1
    launches = {"fps": cuda_fps.LAUNCHES, "flood": cuda_flood.LAUNCHES}
    if few_count:
        launches["flood_few"] = cuda_flood.FEW_LAUNCHES
    log(f"{what} launches (one run): {launches}")
    passes = top_dim + 1
    if (launches["fps"], launches["flood"], len(calls)) != (
            1, passes, passes) or (few_count and
                                   launches["flood_few"] != passes):
        raise AssertionError(f"{what} must launch K2 once and K1's "
                             f"few-sample instances once a pass: {launches}")
    split = {}
    for name, sec in re.findall(r"^\[flooder-timing\] (.+): ([0-9.]+)s$",
                                buf.getvalue(), flags=re.M):
        split[name] = round(split.get(name, 0.0) + float(sec), 4)
    vals = np.concatenate(stree._filt)
    if not np.isfinite(vals).all():
        raise AssertionError(f"{what}: non-finite values")
    if stree.make_filtration_non_decreasing():
        raise AssertionError(f"{what}: not monotone")
    if int(np.isinf(diagrams[0][:, 1]).sum()) != 1:
        raise AssertionError(f"{what}: H0 must have one essential class")
    return dict(calls=calls, launches=launches, complex_s=t1 - t0,
                persistence_s=t2 - t1, stage_split_s=split,
                simplices=[int(v.shape[0]) for v in stree._verts],
                bars=[len(d) for d in diagrams])


def plain_on_blocks(ops, out_k, stats_k, what):
    """K1's plain version on two whole blocks of a launch (the one with the
    longest pair list and one from the middle): every count equal, d2
    within 1e-6 (1-8 coordinates) or the runtime-width bar, inf in place.
    Returns (max |d2 diff|, blocks, pairs)."""
    import torch

    from flooder_tpu_torch.ops import cuda_flood
    from flooder_tpu_torch.tools.scene import block_slice

    lens = (ops[-2][1:] - ops[-2][:-1]).cpu().numpy()
    by_len = np.argsort(-lens, kind="stable")
    blocks = [int(by_len[0]), int(by_len[int(np.count_nonzero(lens)) // 2])]
    sliced, rows = block_slice(ops, blocks)
    out_p, stats_p = cuda_flood.flood_pairs_reference(*sliced)
    nr, dim = ops[0].shape[1], ops[0].shape[3]
    stats_rows = stats_k.reshape(-1, nr, 2)[torch.as_tensor(
        blocks, device=stats_k.device)].reshape(-1, 2)
    what = f"{what}, blocks {blocks}"
    if not torch.equal(stats_rows, stats_p):
        raise AssertionError(f"{what}: counts differ from the plain "
                             "version's")
    if dim > cuda_flood.KERNEL_MAX_DIM:
        err = wide_d2_diff(out_k[rows], out_p, dim, what)[0]
    else:
        err = flood_d2_diff(out_k[rows], out_p, what)
    return err, blocks, sliced[-1].numel()


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


def shard_balance(engine, inputs, assign=None):
    """Per-shard work of the mesh engine's top pass at the main path's
    shapes: (work-list pairs, admitted units, in-ball pairs, K1 ms) per
    (simplex shard, witness shard). ``assign`` replaces the LPT
    assignment for this call (the contiguous split), else LPT runs."""
    from flooder_tpu_torch.ops import cuda_flood
    from flooder_tpu_torch.parallel import sharding

    lpt = sharding.balance_chunk_assignment
    if assign is not None:
        sharding.balance_chunk_assignment = assign
    try:
        shards = engine.shard_operands(*inputs, True)[0]
    finally:
        sharding.balance_chunk_assignment = lpt
    rows = []
    for row in shards:
        for ops in row:
            units, inball = cuda_flood.kernel_operations(
                cuda_flood.flood_min(*ops)[1])
            ms = cuda_ms(lambda: cuda_flood.flood_min(*ops), 3)
            rows.append((ops[-1].numel(), units, inball, ms))
    return rows


def max_mean(values):
    v = np.asarray(values, dtype=np.float64)
    return float(v.max() / v.mean()) if v.mean() > 0 else float("nan")


def mesh_phase(X, main_complex, diagrams, k1_ms):
    """The mesh path: small meshes on the card against the same meshes on
    the CPU (every shard's K1 against its plain version), the dense and
    float64 mesh engines, and the main path's 1M x 1k through 2x2, 1x4 and
    1x3 meshes of the one card."""
    import torch

    import flooder_tpu_torch as ft
    from flooder_tpu_torch.ops import cuda_flood, cuda_fps
    from flooder_tpu_torch.parallel import MeshCudaFloodEngine, make_mesh

    res = {}
    # ---- small: the card against the CPU ----------------------------------
    Y = ft.generate_noisy_torus_points_3d(MESH_SMALL_POINTS, seed=4,
                                          device="cpu")
    LY = ft.generate_landmarks(Y, MESH_SMALL_LANDMARKS, start_idx=0,
                               device="cuda").cpu()
    small_err = {}
    for n, sp in MESH_SMALL:
        card = make_mesh(["cuda:0"] * n, simplex_parallel=sp)
        host = make_mesh(["cpu"] * n, simplex_parallel=sp)
        name = "x".join(map(str, card.shape.values()))
        k0 = cuda_flood.LAUNCHES
        got = complex_dict(Y, LY, None, mesh=card,
                           points_per_edge=MESH_SMALL_PPE)
        if cuda_flood.LAUNCHES != k0 + n:  # one pass, one launch a shard
            raise AssertionError(f"mesh {name}: {cuda_flood.LAUNCHES - k0} "
                                 f"K1 launches, not {n}")
        want = complex_dict(Y, LY, None, mesh=host,
                            points_per_edge=MESH_SMALL_PPE)
        small_err[name, "grid"] = complex_diff(want, got, 1e-6,
                                               f"mesh {name} grid, card vs CPU")
        np.random.seed(1)
        got_r = complex_dict(Y, LY, None, mesh=card, num_rand=MESH_NUM_RAND,
                             points_per_edge=None)
        if name == "2x2":
            # the CPU's random-mode result is the same for every mesh
            # (tests/test_torch_sharding.py), so it is computed once
            np.random.seed(1)
            want_r = complex_dict(Y, LY, None, mesh=host,
                                  num_rand=MESH_NUM_RAND, points_per_edge=None)
        small_err[name, "random"] = complex_diff(
            want_r, got_r, 1e-6, f"mesh {name} random, card vs CPU")
    log(f"mesh small {MESH_SMALL_POINTS} x {MESH_SMALL_LANDMARKS} torus, ppe "
        f"{MESH_SMALL_PPE} and {MESH_NUM_RAND} random samples: card meshes "
        f"(K1 once per shard and pass) == the CPU meshes (K1's plain "
        f"version) on {len(want)} simplices, max |diff| "
        f"{ {'/'.join(k): v for k, v in small_err.items()} }")
    card = make_mesh(["cuda:0"] * 4, simplex_parallel=2)
    host = make_mesh(["cpu"] * 4, simplex_parallel=2)
    dense_err = complex_diff(
        complex_dict(Y, LY, None, mesh=host, use_pallas=False,
                     points_per_edge=MESH_SMALL_PPE),
        complex_dict(Y, LY, None, mesh=card, use_pallas=False,
                     points_per_edge=MESH_SMALL_PPE),
        1e-6, "dense mesh 2x2, card vs CPU")
    f64_err = complex_diff(
        complex_dict(Y.double(), LY.double(), None, mesh=host,
                     points_per_edge=MESH_SMALL_PPE),
        complex_dict(Y.double(), LY.double(), None, mesh=card,
                     points_per_edge=MESH_SMALL_PPE),
        1e-6, "float64 mesh 2x2, card vs CPU")
    log(f"mesh small 2x2: dense engine (use_pallas=False) card == CPU, max "
        f"|diff| {dense_err}; float64 card == CPU, max |diff| {f64_err}")
    res["small_max_abs_err"] = max(small_err.values())
    res["dense_max_abs_err"] = dense_err
    res["float64_max_abs_err"] = f64_err

    # ---- full width: the main path's cloud through meshes of one card -----
    def fenced(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = ft.flood_complex(X, N_LANDMARKS, points_per_edge=PPE,
                              max_dimension=3, return_simplex_tree=True,
                              mesh=mesh)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    fenced(None)  # warm
    single_s = float(np.median([fenced(None)[1] for _ in range(REPS)]))
    L = ft.generate_landmarks(X, N_LANDMARKS, start_idx=0)
    res["meshes"] = {}
    for n, sp in MESH_FULL:
        mesh = make_mesh(["cuda:0"] * n, simplex_parallel=sp)
        name = "x".join(map(str, mesh.shape.values()))
        fenced(mesh)  # warm: builds and caches the engine
        cuda_fps.LAUNCHES = cuda_flood.LAUNCHES = 0
        st, first_s = fenced(mesh)
        launches = {"fps": cuda_fps.LAUNCHES, "flood": cuda_flood.LAUNCHES}
        if launches != {"fps": 1, "flood": n}:
            raise AssertionError(f"mesh {name} at {N_POINTS} x {N_LANDMARKS}: "
                                 f"launches {launches}, not K2 once and K1 "
                                 f"{n} times")
        got = {tuple(s): f for s, f in st.get_simplices()}
        err = complex_diff(main_complex, got, 2e-6,
                           f"mesh {name} against the main path")
        st.compute_persistence()
        d_err = diagrams_diff(
            diagrams, [st.persistence_intervals_in_dimension(i)
                       for i in range(3)], 2e-6,
            f"mesh {name} diagrams against the main path")
        times = [first_s] + [fenced(mesh)[1] for _ in range(REPS - 1)]
        eng = MeshCudaFloodEngine(X, mesh)
        inputs = top_pass_inputs(eng, L, PPE)
        lpt = shard_balance(eng, inputs)
        contiguous = shard_balance(
            eng, inputs, lambda loads, bins: np.arange(len(loads),
                                                       dtype=np.int32))
        del eng, inputs
        bal = {}
        for label, rows in (("lpt", lpt), ("contiguous", contiguous)):
            cols = list(zip(*rows))
            bal[label] = {
                "pairs_max_mean": max_mean(cols[0]),
                "units_max_mean": max_mean(cols[1]),
                "inball_max_mean": max_mean(cols[2]),
                "k1_ms": list(cols[3]), "k1_ms_sum": float(sum(cols[3])),
                "k1_ms_max": float(max(cols[3])),
                "pairs": list(cols[0]), "inball": list(cols[2]),
            }
        res["meshes"][name] = {
            "launches": launches["flood"], "max_abs_err": err,
            "diagrams_max_abs_err": d_err,
            "flood_complex_s": float(np.median(times)), "reps_s": times,
            "balance": bal,
        }
        log(f"mesh {name} ({n} x cuda:0) at {N_POINTS} x {N_LANDMARKS}, ppe "
            f"{PPE}: complex == the main path's (max |diff| {err}), diagrams "
            f"== (max |diff| {d_err}); K1 launches {launches['flood']} "
            f"(= n_ss x n_ws), K2 {launches['fps']}; fenced flood_complex "
            f"median {np.median(times):.4f}s {[round(t, 4) for t in times]} "
            f"against one card {single_s:.4f}s")
        for label in ("lpt", "contiguous"):
            b = bal[label]
            log(f"mesh {name} top pass, {label} assignment: per shard "
                f"pairs {b['pairs']}, in-ball pairs {b['inball']}; max/mean "
                f"pairs {b['pairs_max_mean']:.4f}, admitted units "
                f"{b['units_max_mean']:.4f}, in-ball pairs "
                f"{b['inball_max_mean']:.4f}; K1 ms per shard "
                f"{[round(t, 3) for t in b['k1_ms']]}, sum "
                f"{b['k1_ms_sum']:.3f} ms against one launch {k1_ms:.3f} ms")
    res["single_flood_complex_s"] = single_s
    return res


EXAMPLES = ("example_01_cheese_3d", "example_02_torus_3d",
            "example_03_figure_eight_2d", "example_04_featurization")


def examples_phase():
    """Each port example's ``main(["--small"])`` in process on the default
    device (cuda): a clean return, K1 launched, and its wall time."""
    import importlib

    import torch

    from flooder_tpu_torch.ops import cuda_flood

    walls = {}
    for name in EXAMPLES:
        main = importlib.import_module(
            f"flooder_tpu_torch.examples.{name}").main
        buf = io.StringIO()
        k0 = cuda_flood.LAUNCHES
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(["--small"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if cuda_flood.LAUNCHES == k0:
            raise AssertionError(f"{name}: K1 did not run on the card")
        text = re.sub(r"\x1b\[[0-9;]*m", "", buf.getvalue())
        tail = [ln for ln in text.splitlines() if ln.strip()][-1]
        log(f"{name} --small on cuda: {walls[name]:.2f}s wall, "
            f"{cuda_flood.LAUNCHES - k0} K1 launches; last line: {tail}")
    return walls


def wide_phase(seed):
    """The runtime-width instances: K2 past 8 coordinates against its plain
    version and at full size (1M x 64 float32, 1M x 16 float64), K3 beside
    K1 at 64 coordinates, and the slice's path, a 1M-point 10-D swiss cheese
    through generate_landmarks (K2), flood_complex (K1) and persistence,
    with K2's plain version on the path's cloud, K1's plain version on whole
    blocks of the path's launch, random mode on the same cloud
    (wide_random_mode) and the dense engine on a 100k cut. Returns the
    numbers of the kernels line."""
    import torch

    import flooder_tpu_torch as ft
    from flooder_tpu_torch.core import _grid_host
    from flooder_tpu_torch.native import build
    from flooder_tpu_torch.ops import cuda_flood, cuda_flood_stats, cuda_fps
    from flooder_tpu_torch.ops.fps import farthest_point_sampling
    from flooder_tpu_torch.tools.scene import block_slice
    from flooder_tpu_torch.utils import stagetimer

    dev = torch.device("cuda")
    # K1 wide's fp32 instructions a pair and coordinate, from its SASS
    loops = sass_pair_loops(build.cuda_library("flood")) or ()
    per_coord = next((r[2] for r in loops if r[0] == "flood_min_wide"), None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(card_line("clocks.max.sm").split()[0])
    gen = torch.Generator(dev).manual_seed(seed)
    out = {"fps_err": {}, "fps_full": {}}

    # ---- K2's runtime-width instance against its plain version ----------
    for dim, dt, n in WIDE_FPS_CHECKS:
        P = torch.rand(n, dim, generator=gen, device=dev,
                       dtype=getattr(torch, dt))
        f0 = cuda_fps.LAUNCHES
        L = ft.generate_landmarks(P, WIDE_FPS_CHECK_LANDMARKS, start_idx=0)
        if cuda_fps.LAUNCHES != f0 + 1:
            raise AssertionError(f"generate_landmarks at {dim} coordinates "
                                 "did not launch K2 once")
        a = cuda_fps.cuda_farthest_point_sampling(
            P, WIDE_FPS_CHECK_LANDMARKS, 0)
        if not torch.equal(L, P[a]):
            raise AssertionError(f"generate_landmarks at {dim} coordinates "
                                 "differs from K2's selection")
        b = farthest_point_sampling(P, WIDE_FPS_CHECK_LANDMARKS, 0)
        err = check_same_greedy(P, a.cpu().numpy(), b.cpu().numpy(), 0)
        out["fps_err"][f"{dim}-{dt}"] = err
        log(f"K2 wide: generate_landmarks on {n} uniform points of {dim} "
            f"coordinates ({dt}), {WIDE_FPS_CHECK_LANDMARKS} landmarks, one "
            f"K2 launch; same greedy selection as the plain version, max "
            f"|step d2 diff| {err}")
    for dim, dt in WIDE_FPS_FULL:
        P = torch.rand(WIDE_POINTS, dim, generator=gen, device=dev,
                       dtype=getattr(torch, dt))
        prep = cuda_fps._fps_prepare(P, 0)
        ms = cuda_ms(lambda: cuda_fps.fps_kernel_run(prep, N_LANDMARKS), 3)
        visits = int(cuda_fps.last_visits.item())
        del prep
        got = []
        plain_ms = cuda_ms(lambda: got.append(
            farthest_point_sampling(P, N_LANDMARKS, 0)), 1, warm_up=False)
        b = got[0]
        a = cuda_fps.cuda_farthest_point_sampling(P, N_LANDMARKS, 0)
        err = check_same_greedy(P, a.cpu().numpy(), b.cpu().numpy(), 0)
        peak = PEAK_FP64 if dt == "float64" else PEAK_FP32
        t_ops = 3 * dim * visits * cuda_fps.FPS_CHUNK / peak
        # a cloud larger than L2 is read from HBM at every chunk visit
        read_gb = visits * cuda_fps.FPS_CHUNK * dim * P.element_size() / 1e9
        cloud = P.numel() * P.element_size()
        streamed = 1e9 * read_gb if cloud > L2_BYTES else cloud
        t_bytes = (streamed + N_LANDMARKS * 4) / PEAK_BYTES
        bound = 1e3 * max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        out["fps_full"][f"{dim}-{dt}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            chunk_visits=visits, max_abs_err=err)
        log(f"K2 wide fps {WIDE_POINTS} x {N_LANDMARKS}, {dim} coordinates "
            f"{dt} (uniform, seed {seed}): same greedy selection as the plain "
            f"version (max |step d2 diff| {err}); greedy loop {ms:.3f} ms "
            f"({1e3 * ms / (N_LANDMARKS - 1):.2f} us a step), {visits} chunk "
            f"visits of {WIDE_POINTS // cuda_fps.FPS_CHUNK + 1} chunks x "
            f"{N_LANDMARKS - 1} steps ({read_gb:.1f} GB of coordinates "
            f"streamed); plain {plain_ms:.1f} ms; bound {bound:.4f} ms ({by}: "
            f"operations {1e3 * t_ops:.4f} ms, bytes {1e3 * t_bytes:.4f} ms, "
            f"the visits' bytes where the cloud passes the "
            f"{L2_BYTES / 1e6:.0f} MB L2)")
        del P, a, b

    # ---- K3's runtime-width instance beside K1's, timed -----------------
    dops = seeded_flood_operands(max(WIDE_DIMS), dev)
    k1_ms = cuda_ms(lambda: cuda_flood.flood_min(*dops), 5)
    k3_ms = cuda_ms(lambda: cuda_flood_stats.flood_min_stats(*dops), 5)
    k3_plain_ms = cuda_ms(
        lambda: cuda_flood_stats.flood_stats_reference(*dops), 1,
        warm_up=False)
    _, st = cuda_flood.flood_min(*dops)
    inball = cuda_flood.kernel_operations(st)[1]
    k3_bound, k3_by = flood_bound_ms(dops, inball)
    out["k3"] = dict(ms=k3_ms, k1_ms=k1_ms, plain_ms=k3_plain_ms,
                     bound_ms=k3_bound, bound_by=k3_by, inball_pairs=inball)
    log(f"K3 wide at {max(WIDE_DIMS)} coordinates (the dims phase's seeded "
        f"operands, {inball} in-ball pairs): kernel {k3_ms:.3f} ms (K1 "
        f"{k1_ms:.3f} ms), bound {k3_bound:.4f} ms ({k3_by}), plain "
        f"{k3_plain_ms:.1f} ms")
    del dops, st

    # ---- the slice's path: 1M x 10-D swiss cheese --------------------------
    X = ft.generate_swiss_cheese_points(
        WIDE_POINTS, rect_min=(0.0,) * WIDE_DIM, rect_max=(1.0,) * WIDE_DIM,
        k=6, seed=42, device=dev)[0]
    k1 = cuda_flood.flood_min
    per_simplex = {p: int(np.prod(cuda_flood._tile_geometry(
        _grid_host(p, WIDE_TOP_DIM)[0].shape[0])[:2]))
        for p in (WIDE_PPE_ASKED,) + WIDE_PPE_CUTS}

    def wide_path(ppe):
        """The path through the entry points, with the counts set to 0 and
        its stages fenced (FLOODER_TIMING's stage split; the stages take
        seconds). K1's launches are timed and kept where the engine makes
        them: (operands, (out, stats), ms)."""
        calls = []

        def flood_min_timed(*ops):
            res = []
            ms = cuda_ms(lambda: res.append(k1(*ops)), 1, warm_up=False)
            calls.append((ops, res[0], ms))
            return res[0]

        cuda_fps.LAUNCHES = cuda_flood.LAUNCHES = 0
        cuda_flood_stats.LAUNCHES = 0
        torch.cuda.synchronize()
        buf = io.StringIO()
        stagetimer.ENABLED, cuda_flood.flood_min = True, flood_min_timed
        try:
            with contextlib.redirect_stderr(buf):
                t0 = time.perf_counter()
                with stagetimer.stage("fps"):
                    L = ft.generate_landmarks(X, WIDE_LANDMARKS, start_idx=0)
                stree = ft.flood_complex(X, L, max_dimension=WIDE_TOP_DIM,
                                         points_per_edge=ppe,
                                         return_simplex_tree=True)
                t1 = time.perf_counter()
                stree.compute_persistence()
                diagrams = [stree.persistence_intervals_in_dimension(i)
                            for i in range(WIDE_TOP_DIM)]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        finally:
            stagetimer.ENABLED, cuda_flood.flood_min = False, k1
        launches = {"fps": cuda_fps.LAUNCHES, "flood": cuda_flood.LAUNCHES}
        split = {}
        for name, sec in re.findall(
                r"^\[flooder-timing\] (.+): ([0-9.]+)s$", buf.getvalue(),
                flags=re.M):
            split[name] = round(split.get(name, 0.0) + float(sec), 4)
        log(f"wide path launches (one run, ppe {ppe}): {launches}")
        if launches != {"fps": 1, "flood": 1} or len(calls) != 1:
            raise AssertionError("the 10-D path must launch K2 once and K1 "
                                 f"once: {launches}")
        return dict(L=L, stree=stree, diagrams=diagrams, k1=calls[0],
                    launches=launches, complex_s=t1 - t0,
                    persistence_s=t2 - t1, stage_split_s=split)

    # K1's in-ball pairs and ms are printed first; points per edge is cut
    # while the launch passes WIDE_K1_LIMIT_S
    cuts = [WIDE_PPE_ASKED]
    for ppe in WIDE_PPE_CUTS:
        run = wide_path(ppe)
        ops, (out_k, stats_k), k1_ms = run["k1"]
        units, inball = cuda_flood.kernel_operations(stats_k)
        k1_bound, k1_by = flood_bound_ms(ops, inball)
        s_total, nr, rt, _ = ops[0].shape
        n_top = int(run["stree"]._verts[WIDE_TOP_DIM].shape[0])
        floor = "not derived (no cuobjdump)"
        if per_coord:
            instr = per_coord * WIDE_DIM + 1
            floor = (f"{issue_floor_ms(inball, sms, clock_mhz, instr):.1f} "
                     f"ms (derived: {per_coord:.2f} x {WIDE_DIM} + 1 = "
                     f"{instr:.2f} fp32 instructions an in-ball pair from "
                     f"the SASS pair loop, {sms} SMs x {FP32_LANES_PER_SM} "
                     f"lanes at {clock_mhz:.0f} MHz)")
        ctas = [row[5] for row in wide_occupancy(build)
                if row[:2] == ("flood_min_wide", WIDE_DIM)]
        tail = "not derived (no ptxas lines in this process)"
        if ctas:
            tail = (f"{launch_order_tail(stats_k, ops[-2], sms * ctas[0]):.4f}"
                    f" (derived: the CTAs' in-ball pairs list-scheduled in "
                    f"launch order on {sms * ctas[0]} resident CTAs, makespan "
                    f"over the mean)")
        log(f"K1 wide, the 10-D path's top pass ({WIDE_POINTS} witnesses, "
            f"{n_top} tetrahedra, ppe {ppe}, {nr} x {rt} samples a simplex, "
            f"{ops[-1].numel()} pairs): {inball} in-ball pairs, {units} "
            f"admitted units, in-ball share of their witness slots "
            f"{inball / (units * cuda_flood.SUB * rt):.4f}; kernel "
            f"{k1_ms:.1f} ms (the path's launch), bound {k1_bound:.1f} ms "
            f"({k1_by}); issue floor {floor}; launch-order tail {tail}")
        if ppe == WIDE_PPE_CUTS[0]:
            at_asked = k1_ms / 1e3 * (per_simplex[WIDE_PPE_ASKED]
                                      / per_simplex[ppe])
            log(f"points per edge cut from {WIDE_PPE_ASKED} to {ppe} without "
                f"a launch: linear in the samples a simplex {per_simplex}, "
                f"K1 would take {at_asked:.1f} s at {WIDE_PPE_ASKED} (limit "
                f"{WIDE_K1_LIMIT_S:.0f} s a launch)")
        cuts.append(ppe)
        if k1_ms / 1e3 <= WIDE_K1_LIMIT_S:
            break
        log(f"K1 wide took {k1_ms / 1e3:.2f} s at ppe {ppe}, past "
            f"{WIDE_K1_LIMIT_S:.0f} s" + (
                "" if ppe == WIDE_PPE_CUTS[-1] else ": points per edge cut"))
        if ppe != WIDE_PPE_CUTS[-1]:
            del run, ops, out_k, stats_k
    log(f"points per edge: {' -> '.join(map(str, cuts))}")

    stree, diagrams, L = run["stree"], run["diagrams"], run["L"]
    counts = [int(v.shape[0]) for v in stree._verts]
    vals = np.concatenate(stree._filt)
    if not np.isfinite(vals).all():
        raise AssertionError("10-D path: non-finite filtration values")
    if stree.make_filtration_non_decreasing():
        raise AssertionError("10-D path: filtration was not monotone")
    sizes = [len(d) for d in diagrams]
    if int(np.isinf(diagrams[0][:, 1]).sum()) != 1:
        raise AssertionError("10-D path: H0 must have one essential class")
    out["path"] = {k: run[k] for k in ("launches", "complex_s",
                                       "persistence_s", "stage_split_s")}
    log(f"10-D path {WIDE_POINTS} x {WIDE_LANDMARKS}, ppe {ppe}: complex "
        f"{counts} simplices, all finite and monotone, one essential H0 "
        f"class; diagram sizes {sizes}; filtration in [{vals.min():.6f}, "
        f"{vals.max():.6f}]; landmarks + flood_complex "
        f"{run['complex_s']:.2f}s, persistence {run['persistence_s']:.2f}s "
        f"(host clock)")
    log(f"10-D path stage split (s, fenced; nested stages overlap): "
        f"{json.dumps(run['stage_split_s'])}")
    del stree, diagrams, run

    # K2's pick on the path against its plain version on the same cloud
    a = cuda_fps.cuda_farthest_point_sampling(X, WIDE_LANDMARKS, 0)
    if not torch.equal(L, X[a]):
        raise AssertionError("10-D path: the landmarks differ from K2's "
                             "selection")
    b = farthest_point_sampling(X, WIDE_LANDMARKS, 0)
    out["path_fps_err"] = check_same_greedy(X, a.cpu().numpy(),
                                            b.cpu().numpy(), 0)
    log(f"K2 wide on the 10-D path's cloud ({WIDE_POINTS} points, "
        f"{WIDE_LANDMARKS} landmarks): the path's landmarks are its picks, "
        f"the same greedy selection as the plain version, max |step d2 "
        f"diff| {out['path_fps_err']}")
    del a, b

    # K1's plain version on whole blocks of the path's launch: the longest
    # and a spread
    lens = (ops[-2][1:] - ops[-2][:-1]).cpu().numpy()
    by_len = np.argsort(-lens, kind="stable")
    rest = np.sort(by_len[WIDE_LONGEST_BLOCKS:])
    blocks = np.concatenate([
        by_len[:WIDE_LONGEST_BLOCKS],
        rest[np.linspace(0, len(rest) - 1, WIDE_SPREAD_BLOCKS + 2)
             .astype(int)[1:-1]],
    ]).tolist()
    sliced, rows = block_slice(ops, blocks)
    got = []
    plain_ms = cuda_ms(lambda: got.append(
        cuda_flood.flood_pairs_reference(*sliced)), 1, warm_up=False)
    out_p, stats_p = got[0]
    stats_rows = stats_k.reshape(-1, nr, 2)[torch.as_tensor(blocks,
                                                            device=dev)]
    if not torch.equal(stats_rows.reshape(-1, 2), stats_p):
        raise AssertionError("K1 wide's counts differ from its plain "
                             "version's on whole blocks of the 10-D path")
    blocks_err, blocks_share = wide_d2_diff(
        out_k[rows], out_p, WIDE_DIM,
        "K1 wide against its plain version on whole blocks of the 10-D path")
    out["k1"] = dict(ms=k1_ms, bound_ms=k1_bound, bound_by=k1_by,
                     max_abs_err_on_blocks=blocks_err,
                     inball_pairs=inball, admitted_units=units,
                     plain_ms_on_blocks=plain_ms, blocks=len(blocks),
                     ppe=ppe, ppe_cuts=cuts, tetrahedra=n_top)
    log(f"K1 wide against its plain version on {len(blocks)} whole blocks "
        f"of the 10-D path's launch ({WIDE_LONGEST_BLOCKS} with the longest "
        f"pair list, blocks {blocks}, {sliced[-1].numel()} pairs, all "
        f"{ops[1].shape[0]} witnesses): max |d2 diff| {blocks_err} (largest "
        f"share of the 2 * dim * 2**-24 * d2 bar {blocks_share:.4f}), inf in "
        f"the same places, every count equal; plain {plain_ms:.1f} ms")
    del ops, out_k, stats_k, sliced, rows, out_p, stats_p

    # ---- random mode on the same cloud: K1's few-sample instance ----------
    t0 = time.perf_counter()
    out["random_mode"] = wide_random_mode(X, k1_env())
    log(f"wide random mode: {time.perf_counter() - t0:.1f}s")

    # ---- a 100k cut of the same cloud against the dense engine ------------
    Xc = X[:WIDE_CUT_POINTS]
    del X
    Lc = ft.generate_landmarks(Xc, WIDE_LANDMARKS, start_idx=0)
    kw = dict(points_per_edge=WIDE_CUT_PPE, max_dimension=WIDE_TOP_DIM)
    kernel_route = complex_dict(Xc, Lc, "cuda", **kw)
    dense_route = complex_dict(Xc, Lc, "cuda", use_pallas=False, **kw)
    err = complex_diff(kernel_route, dense_route, 1e-5,
                       "10-D cut: use_pallas=False against the kernel route")
    out["cut_err"] = err
    log(f"10-D cut {WIDE_CUT_POINTS} x {WIDE_LANDMARKS}, ppe {WIDE_CUT_PPE}: "
        f"K1 route == the dense engine on {len(kernel_route)} simplices, max "
        f"|diff| {err}")
    return out


def few_wide_grid(env):
    """K1's few-sample instances past 8 coordinates (flood_min_few_wide at
    9-16, flood_min_few_slabs past 16) on seeded operands at FEW_WIDE_DIMS x
    FEW_WIDE_R: against the plain version (the runtime-width bar, inf in
    place, every count equal, one few-sample launch each), against
    flood_min_wide on the same 128-sample tiles (``flood_min_tiled``: bit
    for bit, the same counts) and against K3's runtime-width instance (bit
    for bit, its computed tiles equal to K1's units). Returns {"dim-R": max
    |d2 diff|}."""
    import torch

    from flooder_tpu_torch.ops import cuda_flood, cuda_flood_stats

    dev = torch.device("cuda")
    tiled = getattr(cuda_flood, "flood_min_tiled", None)
    errs = {}
    for dim in FEW_WIDE_DIMS:
        share, units, n_inf, n_masked, insts = 0.0, [], 0, 0, set()
        for r_count in FEW_WIDE_R:
            ops = seeded_flood_operands(dim, dev, r_count=r_count)
            what = f"K1 at {dim} coordinates, {r_count} samples a simplex"
            insts.add(k1_launch_shape(ops)[0])
            before = (cuda_flood.LAUNCHES,
                      getattr(cuda_flood, "FEW_LAUNCHES", 0))
            out_k, stats_k = cuda_flood.flood_min(*ops)
            torch.cuda.synchronize()
            if tiled is not None and (
                    cuda_flood.LAUNCHES, cuda_flood.FEW_LAUNCHES) != (
                    before[0] + 1, before[1] + 1):
                raise AssertionError(f"{what}: not one few-sample launch")
            out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
            err, sh = wide_d2_diff(out_k, out_p, dim, what)
            if not torch.equal(stats_k, stats_p):
                raise AssertionError(f"{what}: counts differ from the plain "
                                     "version's")
            if tiled is not None:
                out_t, stats_t = tiled(*ops)
                if not (torch.equal(out_k, out_t)
                        and torch.equal(stats_k, stats_t)):
                    raise AssertionError(f"{what}: differs from "
                                         "flood_min_wide at rt 128")
            out_3, stats_3 = cuda_flood_stats.flood_min_stats(*ops)
            units.append(cuda_flood.kernel_operations(stats_k)[0])
            if not (torch.equal(out_3, out_k) and stats_3[
                    :, cuda_flood_stats.COL_TILES].sum().item() == units[-1]):
                raise AssertionError(f"{what}: K3 differs from K1")
            errs[f"{dim}-{r_count}"] = err
            share = max(share, sh)
            masked = out_p >= cuda_flood._MASKED_D2
            n_masked += int(masked.sum())
            n_inf += int(torch.isinf(out_p).sum())
        log(f"few past 8 coordinates, dim {dim} ({', '.join(sorted(insts))}),"
            f" R {list(FEW_WIDE_R)}: max |d2 diff| "
            f"{max(errs[f'{dim}-{r}'] for r in FEW_WIDE_R)} against the plain "
            f"version (largest share of the 2 * dim * 2**-24 * d2 bar "
            f"{share:.4f}), inf in the same places ({n_masked - n_inf} finite "
            f">= 1e30, {n_inf} +inf), every count equal; "
            + ("== flood_min_wide at rt 128 bit for bit with its counts; "
               if tiled is not None else "")
            + f"K3 == K1, tiles == units {units}")
    return errs


def wide_random_mode(X, env):
    """Random mode on the 10-D path: ``X`` (the wide phase's 1M-point 10-D
    cheese), its WIDE_LANDMARKS K2 landmarks, max_dimension WIDE_TOP_DIM,
    num_rand WIDE_NUM_RAND (``np.random.seed`` fixed), through
    random_mode_run; each pass's K1 timed on its own operands (mean of
    WIDE_RANDOM_REPS after a warm-up) beside flood_min_wide on the same
    128-sample tiles (what they took before the few-sample instance: bit for
    bit, the same counts), and held against its plain version on 2 whole
    blocks; bounds and issue floors on real samples. Returns the numbers of
    the kernels line."""
    import torch

    from flooder_tpu_torch.ops import cuda_flood

    tiled = getattr(cuda_flood, "flood_min_tiled", cuda_flood.flood_min)
    out = {}
    for num_rand in WIDE_NUM_RAND:
        what = f"wide random mode num_rand {num_rand}"
        run = random_mode_run(X, WIDE_LANDMARKS, num_rand, WIDE_TOP_DIM, what)
        passes = []
        for d, (ops, (out_k, stats_k)) in enumerate(run["calls"]):
            ms = cuda_ms(lambda: cuda_flood.flood_min(*ops), WIDE_RANDOM_REPS)
            got = []  # the warm-up's result
            tiled_ms = cuda_ms(lambda: got.append(tiled(*ops)) if not got
                               else tiled(*ops), WIDE_RANDOM_REPS)
            out_t, stats_t = got.pop()
            if not (torch.equal(out_k, out_t)
                    and torch.equal(stats_k, stats_t)):
                raise AssertionError(f"{what}, pass {d}: differs from "
                                     "flood_min_wide at rt 128")
            del out_t, stats_t
            rec, text = launch_record(ops, stats_k, num_rand, env)
            rec_t, text_t = launch_record(ops, stats_k, num_rand, env, True)
            err, blocks, pairs = plain_on_blocks(
                ops, out_k, stats_k, f"{what}, pass {d}")
            passes.append(dict(
                dim=d, simplices=run["simplices"][d], ms=ms,
                tiled_ms=tiled_ms, tiled_ctas=rec_t["ctas"],
                tiled_threads=rec_t["threads"], max_abs_err_on_blocks=err,
                **rec))
            log(f"{what}, pass {d} ({run['simplices'][d]} simplices): kernel "
                f"{ms:.3f} ms, flood_min_wide at rt 128 {tiled_ms:.3f} ms "
                f"(means of {WIDE_RANDOM_REPS} after a warm-up, the pass's own "
                f"operands; equal bit for bit, the same counts); {text}; "
                f"flood_min_wide: {text_t.split(', ', 1)[1].split('), ')[0]}"
                f"); plain version on blocks {blocks} ({pairs} pairs): max "
                f"|d2 diff| {err}, every count equal")
        out[str(num_rand)] = dict(passes=passes, **{k: run[k] for k in (
            "launches", "complex_s", "persistence_s", "stage_split_s",
            "bars", "simplices")})
        log(f"{what}: complex {run['simplices']} simplices, finite and "
            f"monotone, one essential H0 class; diagram sizes {run['bars']}; "
            f"landmarks + flood_complex {run['complex_s']:.4f}s, persistence "
            f"{run['persistence_s']:.4f}s (host clock, fenced stages); K1 "
            f"{sum(p['ms'] for p in passes):.3f} ms over the passes "
            f"(flood_min_wide at rt 128: "
            f"{sum(p['tiled_ms'] for p in passes):.3f} ms)")
        log(f"{what} stage split (s, fenced; nested stages overlap): "
            f"{json.dumps(run['stage_split_s'])}")
        del run, ops, out_k, stats_k
    return out


def few_phase(X=None):
    """K1's few-sample instances (tiles of 128 samples, a warp a tile): held
    against their plain version on seeded operands at FEW_DIMS x FEW_R and,
    past 8 coordinates, at FEW_WIDE_DIMS x FEW_WIDE_R (few_wide_grid), timed
    on a 200k 5-D cloud, and driven through random mode on the main path's
    1M x 1k cloud (``X``, made here when None) with the launch counters set
    to 0 just before each run and read just after, each pass's K1 held
    against its plain version on whole blocks, and random mode against the
    dense engine on the 100k x 300 cut. Bounds and issue floors count real
    sample rows only. Returns the numbers of the kernels line."""
    import torch

    import flooder_tpu_torch as ft
    from flooder_tpu_torch.core import _grid_host
    from flooder_tpu_torch.ops import cuda_flood

    dev = torch.device("cuda")
    env = k1_env()
    out = {"seeded_max_abs_err": {}, "random_mode": {}, "cut_vs_dense": {}}
    # ---- seeded operands against the plain version -----------------------
    for dim in FEW_DIMS:
        for r_count in FEW_R:
            ops = seeded_flood_operands(dim, dev, r_count=r_count)
            out_k, stats_k = cuda_flood.flood_min(*ops)
            out_p, stats_p = cuda_flood.flood_pairs_reference(*ops)
            what = f"K1 at {dim} coordinates, {r_count} samples a simplex"
            err = flood_d2_diff(out_k, out_p, what)
            if not torch.equal(stats_k, stats_p):
                raise AssertionError(f"{what}: counts differ from the plain "
                                     "version's")
            out["seeded_max_abs_err"][f"{dim}-{r_count}"] = err
            n_inf = int((out_p >= cuda_flood._MASKED_D2).sum())
            log(f"few {what}: max |d2 diff| {err} against the plain "
                f"version, inf in the same places ({n_inf}), every count "
                f"equal; {launch_record(ops, stats_k, r_count, env)[1]}")
    del ops, out_k, stats_k, out_p, stats_p
    out["wide_grid"] = few_wide_grid(env)

    # ---- K1 timed on a 5-D cloud ------------------------------------------
    X5 = torch.rand(DIM5_POINTS, 5, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    L5 = ft.generate_landmarks(X5, DIM5_LANDMARKS, start_idx=0)
    ops5, n5 = top_pass_operands(cuda_flood.CudaFloodEngine(X5), L5,
                                 DIM5_PPE)
    ms5 = cuda_ms(lambda: cuda_flood.flood_min(*ops5), 5)
    _, stats5 = cuda_flood.flood_min(*ops5)
    rec5, text5 = launch_record(ops5, stats5,
                                _grid_host(DIM5_PPE, 5)[0].shape[0], env)
    out["k1_5d"] = dict(ms=ms5, simplices=n5, pairs=ops5[-1].numel(), **rec5)
    log(f"few K1<5> at {DIM5_POINTS} x {DIM5_LANDMARKS}, ppe {DIM5_PPE} ({n5} "
        f"5-simplices, {ops5[-1].numel()} pairs): kernel {ms5:.3f} ms (mean "
        f"of 5 after a warm-up); {text5}")
    del X5, L5, ops5, stats5

    # ---- random mode at the main path's size --------------------------------
    if X is None:
        X = ft.generate_swiss_cheese_points(N_POINTS, k=6, seed=42,
                                            device=dev)[0]
    for num_rand in FEW_NUM_RAND:
        what = f"few random mode num_rand {num_rand}"
        run = random_mode_run(X, N_LANDMARKS, num_rand, 3, what)
        passes = []
        for d, (ops, (out_k, stats_k)) in enumerate(run["calls"]):
            ms = cuda_ms(lambda: cuda_flood.flood_min(*ops), 5)
            rec, text = launch_record(ops, stats_k, num_rand, env)
            err, blocks, pairs = plain_on_blocks(
                ops, out_k, stats_k, f"random mode {num_rand}, pass {d}")
            passes.append(dict(dim=d, simplices=run["simplices"][d], ms=ms,
                               max_abs_err_on_blocks=err, **rec))
            log(f"{what}, pass {d} ({passes[-1]['simplices']} simplices): "
                f"kernel {ms:.3f} ms (mean of 5 after a warm-up, the pass's "
                f"own operands); {text}; plain version on blocks {blocks} "
                f"({pairs} pairs): max |d2 diff| {err}, every count equal")
        out["random_mode"][str(num_rand)] = dict(
            passes=passes, **{k: run[k] for k in (
                "launches", "complex_s", "persistence_s", "stage_split_s",
                "bars")})
        log(f"few random mode {N_POINTS} x {N_LANDMARKS}, num_rand "
            f"{num_rand}: complex {run['simplices']} simplices, finite and "
            f"monotone, one essential H0 class; diagram bars {run['bars']}; "
            f"flood_complex {run['complex_s']:.4f}s, persistence "
            f"{run['persistence_s']:.4f}s (host clock, fenced stages); K1 "
            f"{sum(p['ms'] for p in passes):.3f} ms over the passes")
        log(f"{what} stage split (s, fenced; nested stages overlap): "
            f"{json.dumps(run['stage_split_s'])}")
        del run, ops, out_k, stats_k
    del X

    # ---- the 100k x 300 cut against the dense engine ------------------------
    C = ft.generate_swiss_cheese_points(DENSE_POINTS, k=6, seed=42,
                                        device=dev)[0]
    for num_rand in FEW_NUM_RAND:
        res = {}
        for route, kw in (("kernel", {}), ("dense", {"use_pallas": False})):
            np.random.seed(FEW_WEIGHT_SEED)
            res[route] = complex_dict(C, DENSE_LANDMARKS, "cuda",
                                      num_rand=num_rand, points_per_edge=None,
                                      **kw)
        err = complex_diff(res["kernel"], res["dense"], 1e-5,
                           f"random mode {num_rand} on the cut: "
                           "use_pallas=False against the kernel route")
        out["cut_vs_dense"][str(num_rand)] = err
        log(f"few random mode num_rand {num_rand} on the cut {DENSE_POINTS} x "
            f"{DENSE_LANDMARKS}: K1 route == the dense engine on "
            f"{len(res['kernel'])} simplices, max |diff| {err}")
    return out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the wide phase's uniform clouds")
    ap.add_argument("--only", choices=["few", "few_wide"],
                    help="build and run this phase alone (few_wide: K1's "
                    "few-sample instances past 8 coordinates, the seeded "
                    "grid and random mode on the 10-D path), and print its "
                    "numbers as the last line (no result line): from the "
                    "root of another checkout through runpy, it times that "
                    "checkout's K1 on the same inputs")
    args = ap.parse_args(argv)
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
    # (rt, kernel, threads a CTA, dynamic shared bytes; K3 at nr 10); an
    # older checkout (--only few from its root) has no few-sample instances
    few_threads = 32 * getattr(cuda_flood, "FEW_WARPS", 1)
    occupancy_of = {
        "flood": [(512, "flood_min_kernel", 128,
                   lambda d: raw8 if d == 8 else 0),
                  (128, "flood_min_few", few_threads, lambda d: 0)],
        "flood_stats": [(512, "flood_stats_kernel", 256, lambda d: (
            10 * 512 + 8 * 10) * 4 + (raw8 if d == 8 else 0))],
    }
    for name, text in build.BUILD_LOG.items():
        rows = build.ptxas_kernels(text)
        log(f"ptxas {name}: (kernel, registers, spill-store bytes, static "
            f"smem bytes) {rows}")
        for rt, *of in occupancy_of.get(name, ()):
            log(f"occupancy of {of[0]} at rt {rt} (K3 at nr 10), derived "
                "from ptxas: (kernel, shared bytes a CTA, CTAs an SM, warps "
                f"an SM) {flood_occupancy(rows, *of)}")
    log(f"occupancy of the runtime-width instances, derived from ptxas: "
        f"{wide_occupancy(build)}")
    for name in ("flood", "flood_stats"):
        loops = sass_pair_loops(build.cuda_library(name))
        log(f"SASS {name}: (kernel, pair-loop instructions, fp32 "
            f"instructions a pair (a pair and coordinate for *_wide), LDS in "
            f"the loop, local accesses in it, local accesses in the kernel) "
            f"{loops if loops is not None else 'cuobjdump not found'}")
    for name in ("flood", "fps", "flood_stats"):
        digests = sass_digests(build.cuda_library(name))
        log(f"SASS digests {name}: {json.dumps(digests)}")
        if digests is not None:
            ref = REFERENCE_DIGESTS[name]
            same = [k for k in ref if digests.get(k) == ref[k]]
            log(f"SASS digests {name} against REFERENCE_DIGESTS: {len(same)} "
                f"of {len(ref)} instances equal; differ or missing "
                f"{sorted(set(ref) - set(same))}; new "
                f"{sorted(set(digests) - set(ref))}")
    t0 = time.perf_counter()
    build.load_persistence()
    log(f"native persistence build: {time.perf_counter() - t0:.2f}s")
    if args.only == "few":
        t_phase = time.perf_counter()
        few = few_phase()
        log(f"few phase: {time.perf_counter() - t_phase:.1f}s")
        print(json.dumps({"few": few}), flush=True)
        return 0
    if args.only == "few_wide":
        t_phase = time.perf_counter()
        env = k1_env()
        grid = few_wide_grid(env)
        X10 = ft.generate_swiss_cheese_points(
            WIDE_POINTS, rect_min=(0.0,) * WIDE_DIM,
            rect_max=(1.0,) * WIDE_DIM, k=6, seed=42, device=dev)[0]
        random_mode = wide_random_mode(X10, env)
        log(f"few_wide: {time.perf_counter() - t_phase:.1f}s")
        print(json.dumps({"wide_grid": grid, "random_mode": random_mode}),
              flush=True)
        return 0

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

    # ---- dims: K1 and K3 at 5-64 coordinates ------------------------------
    t_phase = time.perf_counter()
    k1_dim_err, k3_dim_err = {}, {}
    for dim in HIGH_DIMS:
        wide = dim > cuda_flood.KERNEL_MAX_DIM
        diff = ((lambda a, b, what: wide_d2_diff(a, b, dim, what)) if wide
                else (lambda a, b, what: (flood_d2_diff(a, b, what), None)))
        dops = seeded_flood_operands(dim, dev)
        out_d, stats_d = cuda_flood.flood_min(*dops)
        out_dp, stats_dp = cuda_flood.flood_pairs_reference(*dops)
        k1_dim_err[dim], k1_share = diff(
            out_d, out_dp, f"K1<{dim}> against its plain version")
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
        k3_dim_err[dim], k3_share = diff(
            out_3, out_3p, f"K3<{dim}> against its plain version")
        if not torch.equal(stats_3, stats_3p):
            raise AssertionError(f"K3<{dim}> counters differ from its plain "
                                 "version")
        if not (torch.equal(out_3, out_d) and stats_3[
                :, cuda_flood_stats.COL_TILES].sum().item() == units_d):
            raise AssertionError(f"K3<{dim}> differs from K1<{dim}>")
        masked_d = out_dp >= cuda_flood._MASKED_D2
        n_inf = int(torch.isinf(out_dp).sum())
        if wide and bool((masked_d & torch.isfinite(out_dp)).any()) != (
                dim < 38):
            raise AssertionError(f"dim {dim}: a masked d2 must be finite "
                                 "below 38 coordinates and +inf from 38 on")
        bar = (f" (bar 2 * dim * 2**-24 * d2; largest share of it: K1 "
               f"{k1_share:.4f}, K3 {k3_share:.4f})" if wide else "")
        log(f"dim {dim}: K1 max |d2 diff| {k1_dim_err[dim]} and K3 "
            f"{k3_dim_err[dim]} against their plain versions{bar}, "
            f"inf in the same places ({int(masked_d.sum()) - n_inf} finite "
            f">= 1e30, {n_inf} +inf), {units_d} admitted units equal, K3 "
            f"counters equal (column sums {stats_3.sum(0).tolist()}), K3 == "
            f"K1; {nr_d} tiles a simplex, {inball_d} in-ball of "
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
    log(f"dims phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- few: K1's few-sample instances and random mode at full size ------
    t_phase = time.perf_counter()
    few = few_phase(X)
    log(f"few phase: {time.perf_counter() - t_phase:.1f}s")

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

    # ---- wide: the runtime-width instances past 8 coordinates ---------------
    t_phase = time.perf_counter()
    wide = wide_phase(args.seed)
    log(f"wide phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- mesh: K1 once per shard ---------------------------------------------
    t_phase = time.perf_counter()
    main_complex = {tuple(sm): f for sm, f in stree.get_simplices()}
    mesh = mesh_phase(X, main_complex, diagrams, k1_ms)
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- examples: the port's examples 01-04 on the card --------------------
    t_phase = time.perf_counter()
    example_walls = examples_phase()
    log(f"examples phase: {time.perf_counter() - t_phase:.1f}s")

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
            "ms_5d_200k_x_64": few["k1_5d"]["ms"],
            "bound_ms_5d_200k_x_64": few["k1_5d"]["bound_ms"],
            "bound_by_5d": few["k1_5d"]["bound_by"],
            "few_samples": few,
            "mesh": mesh,
            "wide_10d_path": wide["k1"],
            "wide_10d_path_launches": wide["path"]["launches"]["flood"],
            "wide_10d_random_mode": wide["random_mode"],
            "max_abs_err_wide_cut_vs_dense": wide["cut_err"],
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
            "max_abs_err_wide": wide["fps_err"],
            "wide_1m": wide["fps_full"],
            "wide_10d_path_launches": wide["path"]["launches"]["fps"],
            "max_abs_err_wide_10d_path": wide["path_fps_err"],
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
            "wide_64d_seeded": wide["k3"],
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
