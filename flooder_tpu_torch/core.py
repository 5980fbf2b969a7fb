"""Flood complex construction: PyTorch orchestration.

Counterpart of ``flooder_tpu.core`` on the same host/device split: the
host owns the combinatorics (Delaunay over the landmarks, columnar
SimplexTree assembly, persistence); the device owns the dense geometry
(FPS, bounding balls, sample tiles, the masked min-distance reduction).
On a CUDA device FPS and the reduction run through the hand-written
kernels K2 (``csrc/fps.cu``) and K1 (``csrc/flood.cu``); on the CPU the
same code runs their plain PyTorch versions.

Engines, as the reference routes them: a float32 cloud takes the kernel
engine (K1) by default, on the card and on the CPU; ``use_pallas=False``
(or ``use_triton=False``) and every float64 cloud take the dense engine
(``ops/flood.py``: torch ops on the card, the native reduction on the
CPU), and float64 warns that it may be slow; ``use_pallas=True`` with
float64 raises ``TypeError``. FPS of a CUDA float64 cloud runs K2's double
instance. With ``mesh=`` (``parallel.make_mesh``) the same choice picks the
mesh kernel engine (``MeshCudaFloodEngine``: K1 once per shard) or the
dense mesh engine (``MeshFloodEngine``); the inputs and the result live on
the mesh's first device.
"""

from __future__ import annotations

import itertools
import threading
import warnings
import weakref
from functools import lru_cache
from numbers import Integral
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .ops.cuda_flood import CudaFloodEngine
from .ops.cuda_fps import cuda_farthest_point_sampling
from .ops.flood import DenseFloodEngine, simplex_bounding_balls
from .parallel.sharding import (Mesh, MeshCudaFloodEngine, MeshFloodEngine,
                                mesh_device)
from .topology import DelaunayComplex, SimplexTree
from .utils import stagetimer
from .utils.device import DeviceLike, as_tensor
from .utils.stagetimer import fence, stage

SUPPORTED_DTYPES = (torch.float32, torch.float64)

# Engine cache: repeat flood_complex calls on the SAME witness tensor skip
# the witness ordering. The filtration does not depend on the engine's
# state (the ordering is a performance permutation; the min-fold is
# permutation invariant), so a hit changes nothing but wall clock. Entries
# key on the tensor OBJECT (weakref identity: a dead referent frees the
# engine's device memory; id() alone would be unsound under id reuse).
# Capacity 2: engines pin the ordered witness copy in device memory.
_ENGINE_CACHE: List[tuple] = []
_ENGINE_CACHE_CAP = 2
_ENGINE_CACHE_LOCK = threading.Lock()


def _auto_wchunk(n_points: int) -> int:
    """The dense engine's witness chunk for a cloud of ``n_points``: small
    clouds get small chunks, so narrow windows drag in few padded
    witnesses."""
    c = 128
    while c < 4096 and c * 64 < n_points:
        c *= 2
    return c


def _cached_engine(points, key, build):
    with _ENGINE_CACHE_LOCK:
        for i, (ref, k, eng) in enumerate(_ENGINE_CACHE):
            if k == key and ref() is points:
                _ENGINE_CACHE.append(_ENGINE_CACHE.pop(i))
                stagetimer.count("engine_cache_hit")
                return eng
        # evict BEFORE building, so peak memory never holds CAP+1 engines
        live = [e for e in _ENGINE_CACHE if e[0]() is not None]
        _ENGINE_CACHE[:] = live[-(_ENGINE_CACHE_CAP - 1):]
    eng = build()
    with _ENGINE_CACHE_LOCK:
        _ENGINE_CACHE.append((weakref.ref(points), key, eng))
        del _ENGINE_CACHE[:-_ENGINE_CACHE_CAP]
    return eng


# ---------------------------------------------------------------------------
# sampling weights
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _grid_host(n: int, dim: int):
    """Barycentric grid on the unit ``dim``-simplex with ``n`` points per
    edge, plus per-face grid-row and vertex indices (stars-and-bars:
    C(n+dim-1, dim) points; for every vertex-subset face the rows lying on
    it, so one top-dimension pass yields the values of all faces)."""
    combs = np.asarray(
        list(itertools.combinations(range(n + dim - 1), dim)), dtype=np.int64
    ).reshape(-1, dim)
    c = combs.shape[0]
    padded = np.concatenate(
        [
            np.full((c, 1), -1, dtype=np.int64),
            combs,
            np.full((c, 1), n + dim - 1, dtype=np.int64),
        ],
        axis=1,
    )
    grid = np.diff(padded, axis=1) - 1  # (C, dim + 1) integer weights

    face_idxs: List[np.ndarray] = []
    vertex_idxs: List[np.ndarray] = []
    all_axes = np.arange(dim + 1)
    for k in range(dim + 1):
        fk, vk = [], []
        for comb in itertools.combinations(range(dim + 1), k):
            comb_arr = np.asarray(comb, dtype=np.int64)
            if len(comb) == 0:
                mask = np.ones(len(grid), dtype=bool)
            else:
                mask = (grid[:, comb_arr] == 0).all(axis=1)
            fk.append(np.flatnonzero(mask))
            vk.append(all_axes[~np.isin(all_axes, comb_arr)])
        face_idxs.append(np.stack(fk))
        vertex_idxs.append(np.stack(vk))

    grid_f = grid.astype(np.float64) / (n - 1)
    return grid_f, vertex_idxs, face_idxs


def generate_grid(
    n: int, dim: int, device: DeviceLike = None, dtype=torch.float32
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Grid of points on the unit simplex.

    Args:
        n: Number of points per edge.
        dim: Dimension of the simplex.
        device: device of the returned tensors (default "cuda").
        dtype: dtype of the weight tensor.

    Returns:
        (grid (C, dim+1) weights, vertex_idxs per face-codim, face_idxs per
        face-codim).
    """
    grid, vertex_idxs, face_idxs = _grid_host(n, dim)
    arr = as_tensor(grid, dtype=dtype, device=device)
    return (
        arr,
        [as_tensor(v, device=arr.device) for v in vertex_idxs],
        [as_tensor(f, device=arr.device) for f in face_idxs],
    )


def generate_uniform_weights(num_rand, dim, device: DeviceLike = None,
                             dtype=torch.float32) -> torch.Tensor:
    """``num_rand`` uniform points on the unit ``dim``-simplex.

    Normalized exponentials ``-log(1-U)`` drawn from the HOST numpy global
    RNG, as ``flooder_tpu`` draws them: ``np.random.seed(s)`` reproduces
    the weights in both packages and on every device.
    """
    if dim == 0:
        w = np.ones((num_rand, 1))
    else:
        u = np.random.rand(num_rand, dim + 1)
        w = -np.log(1.0 - u)
        w = w / w.sum(axis=1, keepdims=True)
    return as_tensor(w, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# landmarks
# ---------------------------------------------------------------------------


def generate_landmarks(
    points,
    n_lms: int,
    fps_h: Union[None, int] = None,
    start_idx: Union[int, None] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Select landmarks by exact greedy farthest-point sampling.

    A CUDA float32 or float64 cloud runs kernel K2; a CPU cloud runs the
    plain version. ``fps_h`` (the bucket height of the original flooder's
    approximate FPS) is accepted and ignored.

    Args:
        points: (P, d) cloud (numpy array or tensor), moved to ``device``.
        n_lms: number of landmarks (clamped to P; must be > 0).
        fps_h: ignored.
        start_idx: index of the first landmark; None draws one from the
            host numpy RNG (``np.random.randint``).
        device: device to run on (default "cuda").

    Returns:
        (n_lms, d) tensor on ``device``.
    """
    if n_lms <= 0:
        raise RuntimeError(f"Number of landmarks ({n_lms}) must be positive")
    del fps_h
    pts = as_tensor(points, device=device)
    n_pts = pts.shape[0]
    n_lms = min(n_lms, n_pts)
    if start_idx is None:
        start_idx = int(np.random.randint(n_pts))
    idx = cuda_farthest_point_sampling(pts, n_lms, int(start_idx))
    return pts[idx]


# ---------------------------------------------------------------------------
# flood complex
# ---------------------------------------------------------------------------


def _min_combine_faces(faces: np.ndarray, vals: np.ndarray):
    """Combine duplicate face rows by taking the min of their values."""
    from .topology._keys import row_keys

    faces = np.sort(np.ascontiguousarray(faces, dtype=np.int32), axis=1)
    keys = row_keys(faces)
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    vals_s = np.asarray(vals, dtype=np.float64)[order]
    starts = np.flatnonzero(
        np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
    )
    mins = np.minimum.reduceat(vals_s, starts)
    return faces[order[starts]], mins


def flood_complex(
    points,
    landmarks: Union[int, torch.Tensor, np.ndarray],
    max_dimension: Union[None, int] = None,
    points_per_edge: Union[None, int] = 30,
    num_rand: int = None,
    batch_size: Union[None, int] = 64,
    use_pallas: Optional[bool] = None,
    return_simplex_tree: bool = False,
    fps_h: Union[None, int] = None,
    start_idx: Union[int, None] = 0,
    use_triton: Optional[bool] = None,
    wchunk: Optional[int] = None,
    mesh=None,
    landmarks_in_cloud: Optional[bool] = None,
    device: DeviceLike = None,
) -> Union[dict, SimplexTree]:
    """Construct a Flood complex from witness points and landmarks.

    Given N witness points and L landmarks, build the Delaunay
    triangulation of the landmarks and give each simplex the covering
    radius ``max over sample points s of (min over witnesses w in the
    simplex's bounding ball of |s - w|)``, estimated on a barycentric grid
    (or on random samples) of each simplex.

    Args:
        points: (N, d) float32 or float64 witnesses (numpy array or
            tensor).
        landmarks: a landmark count (FPS-sampled from ``points``) or
            explicit (L, d) landmark coordinates. Tensor landmarks must
            lie on the device of a tensor cloud, else ``RuntimeError`` as
            in flooder_tpu; numpy inputs carry no device.
        max_dimension: top simplex dimension (default: ambient dimension).
        points_per_edge: grid resolution per edge (grid mode, default 30).
        num_rand: if set, this many random samples per simplex instead of
            the grid (weights from the host numpy RNG).
        batch_size: simplices per batch of the dense engine (None: all);
            the kernel engine's block geometry is fixed.
        use_pallas / use_triton: None selects the kernel engine for
            float32 and the dense engine for float64; True forces the
            kernel engine (float32 only), False the dense engine.
        return_simplex_tree: return a SimplexTree instead of a dict.
        fps_h: ignored (see generate_landmarks).
        start_idx: FPS start index (None = random, host numpy RNG).
        wchunk: witness chunk of the dense engine (None: by cloud size);
            the kernel engine's chunk is fixed.
        mesh: a ``parallel.make_mesh`` mesh: simplex blocks split over its
            "simplex" axis, the cloud over its "witness" axis, partial
            minima combined by min. Inputs and result are on its first
            device.
        landmarks_in_cloud: every landmark is one of ``points``, which
            enables the exact nearest-vertex bound. Auto-True when the
            landmarks are FPS-sampled here.
        device: device to run on (default "cuda", or the mesh's first
            device); inputs are moved there.

    Returns:
        dict mapping simplex tuples to filtration values, or a SimplexTree.
    """
    stagetimer.new_record()
    if use_triton is not None and use_pallas is None:
        use_pallas = use_triton
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a flooder_tpu_torch.parallel.Mesh (from "
                f"make_mesh), not {type(mesh).__name__}"
            )
        if device is None:
            device = mesh.first_device
        elif (torch.device(device).type != mesh.first_device.type
              or mesh_device(device) != mesh.first_device):
            raise ValueError(
                f"device {device} is not the mesh's first device "
                f"{mesh.first_device}"
            )

    # the device of the caller's cloud (None for numpy, which has none)
    points_device = (points.device if isinstance(points, torch.Tensor)
                     else None)
    points = as_tensor(points, device=device)
    if points.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"dtype ({points.dtype}) not supported")
    dtype = points.dtype
    if dtype == torch.float64:
        if use_pallas:
            raise TypeError("the kernel flood engine takes float32 only; "
                            "float64 runs the dense engine")
        warnings.warn(
            "Using float64 on accelerator backends might be slow",
            RuntimeWarning,
            stacklevel=2,
        )
    dense = use_pallas is False or dtype == torch.float64
    if wchunk is None:
        wchunk = _auto_wchunk(points.shape[0])
    if max_dimension is None:
        max_dimension = points.shape[1]
    if isinstance(landmarks, Integral):
        with stage("fps"):
            landmarks = generate_landmarks(
                points,
                min(int(landmarks), points.shape[0]),
                fps_h,
                start_idx=start_idx,
                device=points.device,
            )
            fence(landmarks)
        if landmarks_in_cloud is None:
            landmarks_in_cloud = True
    else:
        if (isinstance(landmarks, torch.Tensor) and points_device is not None
                and landmarks.device != points_device):
            raise RuntimeError(
                f"landmarks.device ({landmarks.device}) != points.device "
                f"({points_device})"
            )
        landmarks = as_tensor(landmarks, device=points.device)
    tight = bool(landmarks_in_cloud)
    if landmarks.dtype != points.dtype:
        raise RuntimeError(
            f"landmarks.dtype ({landmarks.dtype}) != points.dtype "
            f"({points.dtype})"
        )
    dev = points.device

    with stage("landmarks-d2h"):
        lms_host = landmarks.detach().cpu().numpy().astype(np.float64)

    # Build the engine before the host Delaunay: its witness ordering is
    # queued on the device and runs while the host triangulates.
    with stage("engine-init"):
        if mesh is not None and dense:
            engine = _cached_engine(
                points, ("mesh-dense", wchunk, mesh),
                lambda: MeshFloodEngine(points, wchunk, mesh),
            )
        elif mesh is not None:
            engine = _cached_engine(
                points, ("mesh-cuda", mesh),
                lambda: MeshCudaFloodEngine(points, mesh),
            )
        elif dense:
            engine = _cached_engine(
                points, ("dense", wchunk),
                lambda: DenseFloodEngine(points, wchunk),
            )
        else:
            engine = _cached_engine(
                points, ("cuda-flood",), lambda: CudaFloodEngine(points)
            )

    with stage("delaunay"):
        stree = DelaunayComplex(lms_host).create_simplex_tree()
        levels = stree._verts  # columnar access within the package

    for d in range(max_dimension + 1):
        # Grid mode derives face filtrations from the top-dimension pass.
        if num_rand is None and d < max_dimension:
            continue
        if d >= len(levels):
            continue
        d_simplices = levels[d]
        num_simplices = d_simplices.shape[0]
        if num_simplices == 0:
            continue

        with stage(f"dim{d}:balls+order"):
            sim_verts = landmarks[torch.as_tensor(d_simplices, device=dev)
                                  .long()]  # (S, d+1, dim)
            centers, radii = simplex_bounding_balls(sim_verts)
            order_host = engine.order(centers)
            order = torch.as_tensor(order_host, device=dev)
            sim_verts = sim_verts[order]
            centers = centers[order]
            radii = radii[order]
            simplices_sorted = d_simplices[order_host]

        bsz = num_simplices if batch_size is None else int(batch_size)
        if num_rand is None:
            weights, vertex_idxs, face_idxs = _grid_host(
                points_per_edge, max_dimension
            )
            with stage(f"dim{d}:distances"):
                if dense:
                    dists = engine.min_distances(
                        sim_verts, weights, centers, radii, bsz
                    )  # (S, R)
                    faces_max = [
                        dists[:, torch.as_tensor(t, device=dev)].amax(-1)
                        for t in face_idxs
                    ]
                else:
                    faces_max = engine.min_distances_facemax(
                        sim_verts, weights, centers, radii, tight=tight,
                        face_tables=face_idxs,
                    )
                fvals_all = [f.cpu().numpy() for f in faces_max]
            with stage(f"dim{d}:assembly"):
                # A face shared by several top simplices takes the min of
                # their ball-restricted estimates (order independent).
                for codim, vertex_idx in enumerate(vertex_idxs):
                    faces = simplices_sorted[:, vertex_idx]
                    face_dim = max_dimension - codim
                    uniq_faces, min_vals = _min_combine_faces(
                        faces.reshape(-1, face_dim + 1),
                        fvals_all[codim].reshape(-1),
                    )
                    stree.assign_filtrations(face_dim, uniq_faces, min_vals)
        else:
            weights = generate_uniform_weights(num_rand, d, device="cpu",
                                               dtype=dtype)
            with stage(f"dim{d}:distances"):
                if dense:
                    vals = engine.min_distances(
                        sim_verts, weights, centers, radii, bsz
                    ).amax(-1)
                else:
                    vals = engine.min_distances_facemax(
                        sim_verts, weights, centers, radii, tight=tight,
                        face_tables=None,
                    )
                vals_host = vals.cpu().numpy()
            with stage(f"dim{d}:assembly"):
                stree.assign_filtrations(d, simplices_sorted, vals_host)

    with stage("monotonicity"):
        stree.make_filtration_non_decreasing()

    if return_simplex_tree:
        return stree
    with stage("dict-out"):
        return dict(
            (tuple(simplex), filtr) for simplex, filtr in stree.get_simplices()
        )
