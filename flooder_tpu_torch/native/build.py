"""Build and load the port's native code.

Two kinds of source, both in this package and nowhere else:

- ``native/src/persistence.cpp`` (the Z/2 boundary reduction) and
  ``native/src/flood_cpu.cpp`` (the dense engine's min-distance reduction
  for CPU tensors), each compiled with the host C++ compiler (``$CXX``,
  default ``g++``) into a plain shared library.
- ``csrc/<name>.cu``: the hand-written Hopper kernels (with the headers
  ``csrc/*.cuh`` they share), compiled with ``nvcc`` for ``sm_90a`` into
  shared libraries with a plain C interface and loaded with ``ctypes`` (no
  PyTorch headers, so a build takes seconds).

Everything is built at first use into ``build/flooder_tpu_torch/`` beside
the package (git-ignored), never at import. A failed build raises with the
compiler's output: there is no fallback. Libraries are written to a
temporary name and renamed into place, so processes that build at the same
time never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR.parent / "build" / "flooder_tpu_torch"
PERSISTENCE_SRC = PKG_DIR / "native" / "src" / "persistence.cpp"
PERSISTENCE_LIB = BUILD_DIR / "_persistence.so"
FLOOD_CPU_SRC = PKG_DIR / "native" / "src" / "flood_cpu.cpp"
FLOOD_CPU_LIB = BUILD_DIR / "_flood_cpu.so"
CUDA_SRC_DIR = PKG_DIR / "csrc"

# Kernels are built for Hopper only. -fmad=false keeps every a*b+c as a
# rounded multiply and a rounded add, the same arithmetic as the plain
# PyTorch versions, except where a kernel writes an FMA out (the flood
# kernels' per-pair distance, csrc/flood_common.cuh).
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # library name -> compiler output
BUILD_SECONDS: Dict[str, float] = {}


def _stale(lib: Path, *srcs: Path) -> bool:
    return not lib.exists() or any(
        lib.stat().st_mtime < src.stat().st_mtime for src in srcs
    )


def _tmp_name(lib: Path) -> Path:
    return lib.with_name(f".{lib.name}.{os.getpid()}.tmp")


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path, t0):
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed (exit {proc.returncode}):\n"
            f"{' '.join(proc.args)}\n{out}"
        )
    os.replace(tmp, lib)


def _start(cmd, tmp: Path):
    tmp.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        cmd + ["-o", str(tmp)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    exe = shutil.which("nvcc")
    if exe is None and CUDA_HOME:
        exe = os.path.join(CUDA_HOME, "bin", "nvcc")
    if exe is None or not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the "
            "CUDA kernels cannot be built"
        )
    return exe


def cuda_source(name: str) -> Path:
    return CUDA_SRC_DIR / f"{name}.cu"


def cuda_library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_cuda(names: Iterable[str]) -> None:
    """Compile the named ``csrc/*.cu`` kernels that are missing or stale,
    one ``nvcc`` process each, all started together."""
    headers = sorted(CUDA_SRC_DIR.glob("*.cuh"))
    procs = []
    for name in names:
        src = cuda_source(name)
        lib = cuda_library(name)
        if not _stale(lib, src, *headers):
            continue
        tmp = _tmp_name(lib)
        cmd = [_nvcc(), *NVCC_FLAGS, str(src)]
        procs.append((name, _start(cmd, tmp), tmp, lib, time.perf_counter()))
    errors = []
    for args in procs:
        try:
            _finish(*args)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


# Kernel names in the libraries; a name that contains another comes first
# (``flood_min_few_wide`` before ``flood_min_few``).
KERNEL_NAMES = ("flood_stats_kernel", "fps_loop", "flood_min_wide",
                "flood_stats_wide", "flood_min_few_wide",
                "flood_min_few_slabs", "flood_min_few")


_TYPE_ARGS = {"f": "float", "d": "double"}


def kernel_instance(mangled: str) -> str:
    """A kernel's readable name with its template arguments, from its
    mangled name, e.g. ``fps_loop<double,3>``; K2's runtime-width instance
    (width argument 0) reads ``fps_loop<float,wide>``, and the flood
    kernels' runtime-width instances are ``flood_min_wide``,
    ``flood_min_few_wide``, ``flood_min_few_slabs`` and
    ``flood_stats_wide``. Unknown names stay unchanged."""
    known = [k for k in KERNEL_NAMES if k in mangled]
    if not known:
        return mangled
    args = [_TYPE_ARGS.get(t) or ("wide" if n == "0" else n) for n, t in
            re.findall(r"Li(\d+)E|(?<=I)([fd])(?=Li)", mangled)]
    return known[0] + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(text: str):
    """(kernel, registers, spill-store bytes, static shared bytes) of each
    entry function in a build's ``-Xptxas=-v`` output, with its template
    arguments, e.g. ``("flood_stats_kernel<3>", 72, 24, 22592)`` or
    ``("fps_loop<double,3>", ...)``."""
    rows = []
    for block in re.split(r"Compiling entry function '", text)[1:]:
        name = kernel_instance(block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        smem = re.search(r"(\d+) bytes smem", block)
        rows.append((name, int(regs.group(1)) if regs else None,
                     int(spill.group(1)) if spill else None,
                     int(smem.group(1)) if smem else 0))
    return rows


def load_cuda(name: str) -> ctypes.CDLL:
    """Load (building first if needed) the kernel library ``lib<name>.so``."""
    with _lock:
        if name not in _loaded:
            build_cuda([name])
            _loaded[name] = ctypes.CDLL(str(cuda_library(name)))
        return _loaded[name]


def _load_host(name: str, src: Path, lib_path: Path, bind) -> ctypes.CDLL:
    """Load (building first if missing or stale) the host library
    ``lib_path`` from the C++ source ``src``; ``bind`` sets its
    signatures. A failed build raises."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if _stale(lib_path, src):
            tmp = _tmp_name(lib_path)
            cxx = os.environ.get("CXX", "g++")
            cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", str(src)]
            _finish(name, _start(cmd, tmp), tmp, lib_path,
                    time.perf_counter())
        lib = ctypes.CDLL(str(lib_path))
        bind(lib)
        _loaded[name] = lib
        return lib


def _bind_persistence(lib):
    lib.flood_reduce.restype = ctypes.c_int64
    lib.flood_reduce.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]


def _bind_flood_cpu(lib):
    for name, scalar in (("flood_min_dist_f32", ctypes.c_float),
                         ("flood_min_dist_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        p = ctypes.POINTER(scalar)
        fn.argtypes = [ctypes.c_int64] * 4 + [p] * 5 + [ctypes.c_int64, p]


def load_persistence() -> ctypes.CDLL:
    """Load (building first if needed) the native persistence reduction."""
    return _load_host("persistence", PERSISTENCE_SRC, PERSISTENCE_LIB,
                      _bind_persistence)


def load_flood_cpu() -> ctypes.CDLL:
    """Load (building first if needed) the dense engine's native CPU
    reduction, ``flood_min_dist_f32`` / ``flood_min_dist_f64``."""
    return _load_host("flood_cpu", FLOOD_CPU_SRC, FLOOD_CPU_LIB,
                      _bind_flood_cpu)
