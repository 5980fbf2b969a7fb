"""flooder_tpu_torch: the Flood complex on PyTorch and CUDA (NVIDIA Hopper).

A port of ``flooder_tpu`` that keeps its API: construct the Flood complex
(a lightweight filtered simplicial complex over a Euclidean point cloud)
and compute its persistent homology. The two hot loops run as kernels
written by hand for ``sm_90a``: exact greedy FPS (``csrc/fps.cu``) and the
masked min-distance reduction (``csrc/flood.cu``). Everything else is
PyTorch on the device and numpy/scipy/C++ on the host.

Entry points take ``device=None``, meaning ``"cuda"``, and raise when CUDA
is absent unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.

Public API:
    - flood_complex(points, landmarks, ...)
    - generate_landmarks(points, n_lms, ...)
    - save_to_disk(obj, path, ...)
    - generate_swiss_cheese_points / generate_annulus_points_2d /
      generate_noisy_torus_points_3d / generate_figure_eight_points_2d
"""

from .io import save_to_disk
from .core import (
    flood_complex,
    generate_landmarks,
    generate_grid,
    generate_uniform_weights,
)
from .synthetic_data_generators import (
    generate_swiss_cheese_points,
    generate_annulus_points_2d,
    generate_noisy_torus_points_3d,
    generate_figure_eight_points_2d,
)

__version__ = "1.0.1"

__all__ = [
    "flood_complex",
    "generate_landmarks",
    "save_to_disk",
    "generate_swiss_cheese_points",
    "generate_annulus_points_2d",
    "generate_noisy_torus_points_3d",
    "generate_figure_eight_points_2d",
]
