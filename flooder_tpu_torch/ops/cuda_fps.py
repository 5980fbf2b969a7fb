"""Exact greedy farthest-point sampling on the card: kernel K2.

Counterpart of ``flooder_tpu.ops.pallas_fps``. ``_fps_prepare`` lays the
cloud out as the TPU kernel's did (Hilbert sort, 8192-point chunks with
bounding boxes), as torch ops; ``csrc/fps.cu`` runs the whole greedy loop
as one cooperative launch with the same chunk skip and tie rule, for
float32 and float64 clouds of any width (fixed-width instances for 1-8
coordinates, a runtime-width one past 8, where ``flooder_tpu`` runs its XLA
loop). The wrapper launches the kernel for a CUDA tensor and uses the plain
version ``ops/fps.py`` for a CPU tensor, and nothing else; a CUDA cloud of
another dtype raises.

The Hilbert sort codes the first ``63 // bits`` coordinates
(``cuda_flood._coded_axes``): every coordinate up to 63 (the TPU layout's
codes, which ``flooder_tpu`` builds up to 8), and a code that stays inside
int64, alike on the CPU and the card, past that. The sort only groups
points into chunks: it changes which chunks a step skips, and the pick among
exactly tied points, never a step's farthest distance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_flood import hilbert_codes, morton_codes
from .fps import farthest_point_sampling

FPS_CHUNK = 8192
KERNEL_DTYPES = (torch.float32, torch.float64)

# CUDA launches of the greedy-loop kernel, as counted by ``fps_run`` while
# it enqueues them (1 per FPS run of at least 2 samples).
LAUNCHES = 0
# Chunk visits of the last kernel run (device int64 counter).
last_visits = None


def _fps_prepare(points: torch.Tensor, start_idx: int, chunk: int = FPS_CHUNK):
    """Hilbert-sort the cloud and lay it out for the kernel.

    Returns (pts_t (dim, N_pad) sorted and transposed, box_lo / box_hi
    (dim, nchunks) chunk boxes, sorted_start (1,) int32, order (N,) with
    ``original_index = order[sorted_index]``). Padding columns copy the
    start point: their min-distance is 0 after the first fold, so they are
    never selected.
    """
    n, dim = points.shape
    bits = max(1, min(10, 24 // dim))
    codes = (
        hilbert_codes(points, bits) if dim > 1 else morton_codes(points, bits)
    )
    order = torch.argsort(codes, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=points.device)
    sorted_start = inv[start_idx : start_idx + 1].to(torch.int32)
    pts_t = points[order].t()
    n_pad = -(-max(n, chunk) // chunk) * chunk
    if n_pad != n:
        pad = points[start_idx].reshape(dim, 1).expand(dim, n_pad - n)
        pts_t = torch.cat([pts_t, pad], dim=1)
    pts_t = pts_t.contiguous()
    boxes = pts_t.reshape(dim, n_pad // chunk, chunk)
    return (
        pts_t,
        boxes.amin(2).contiguous(),
        boxes.amax(2).contiguous(),
        sorted_start,
        order,
    )


@functools.lru_cache(maxsize=None)
def _lib():
    from ..native.build import load_cuda

    lib = load_cuda("fps")
    lib.fps_run.restype = ctypes.c_int
    lib.fps_run.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int]
        + [ctypes.c_void_p] * 6
        + [ctypes.c_int]
        + [ctypes.c_void_p] * 4
    )
    lib.fps_coresident_ctas.restype = ctypes.c_int
    lib.fps_coresident_ctas.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.flooder_cuda_error_string.restype = ctypes.c_char_p
    lib.flooder_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: " + lib.flooder_cuda_error_string(rc).decode()
        )


def coresident_ctas(dim: int, device=None, dtype=torch.float32) -> int:
    """How many CTAs of the kernel for ``dim`` coordinates of ``dtype``
    (float32 or float64) the card holds at once (SMs x resident blocks per
    SM, by the occupancy query that ``fps_run`` sizes its grid with): the
    kernel's grid is min(chunks, this)."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA FPS kernel takes float32 or float64, "
                        f"got {dtype}")
    lib = _lib()
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.fps_coresident_ctas(dim, int(dtype == torch.float64),
                                     FPS_CHUNK, ctypes.byref(ctas))
    _raise_on(lib, rc, "fps occupancy query")
    return ctas.value


def fps_kernel_run(prep, n_samples: int) -> torch.Tensor:
    """Run the kernel's greedy loop on a prepared layout; returns the
    (n_samples,) int32 selection in SORTED order."""
    global LAUNCHES, last_visits
    pts_t, box_lo, box_hi, sorted_start, _ = prep
    dim, npad = pts_t.shape
    nchunks = box_lo.shape[1]
    dev, dt = pts_t.device, pts_t.dtype
    lib = _lib()
    # the running mins and the exchanged maxima are in the cloud's type
    mind2 = torch.full((npad,), float("inf"), dtype=dt, device=dev)
    cmax = torch.full((nchunks,), float("inf"), dtype=dt, device=dev)
    cbest = torch.zeros(nchunks, dtype=torch.int32, device=dev)
    xv = torch.empty(2 * nchunks, dtype=dt, device=dev)
    xi = torch.empty(2 * nchunks, dtype=torch.int32, device=dev)
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_samples, dtype=torch.int32, device=dev)
    out[:1] = sorted_start
    visits = torch.zeros(1, dtype=torch.int64, device=dev)
    launched = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fps_run(
            pts_t.data_ptr(), dim, int(dt == torch.float64), npad,
            FPS_CHUNK, box_lo.data_ptr(),
            box_hi.data_ptr(), nchunks, mind2.data_ptr(), cmax.data_ptr(),
            cbest.data_ptr(), xv.data_ptr(), xi.data_ptr(), out.data_ptr(),
            n_samples, visits.data_ptr(), bar.data_ptr(), stream,
            ctypes.byref(launched),
        )
    LAUNCHES += launched.value
    _raise_on(lib, rc, "fps kernel launch")
    last_visits = visits
    return out


def cuda_farthest_point_sampling(
    points: torch.Tensor, n_samples: int, start_idx: int = 0
) -> torch.Tensor:
    """K2: exact greedy FPS. Returns (n_samples,) int64 indices.

    A CPU tensor goes to the plain version; a CUDA tensor launches
    ``csrc/fps.cu`` or raises (float32 or float64, at least 1 coordinate).
    """
    if points.device.type == "cpu":
        return farthest_point_sampling(points, n_samples, start_idx)
    if points.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA FPS kernel takes float32 or float64, "
                        f"got {points.dtype}")
    n, dim = points.shape
    if dim < 1:
        raise ValueError("the CUDA FPS kernel takes at least 1 coordinate")
    if not 0 <= start_idx < n or not 1 <= n_samples <= n:
        raise IndexError(f"start {start_idx} / samples {n_samples} vs {n}")
    if n >= 2**31:
        raise ValueError("the CUDA FPS kernel indexes points with int32")
    prep = _fps_prepare(points.contiguous(), int(start_idx))
    out = fps_kernel_run(prep, n_samples)
    return prep[4][out.long()]
