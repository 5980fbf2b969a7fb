"""Host topology layer of the PyTorch port (numpy and scipy only).

- :class:`SimplexTree`: columnar filtered complex with a gudhi-compatible
  surface.
- :class:`DelaunayComplex`: Delaunay triangulation (scipy's Qhull).
- Persistent homology: the C++ twist/clearing boundary reduction built
  from ``native/src/persistence.cpp``.
- :class:`AlphaComplex`: the alpha filtration over the Delaunay
  triangulation, the oracle of the flood complex.
- :func:`bottleneck_distance`: exact bottleneck matching of diagrams.
"""

from .simplex_tree import SimplexTree
from .delaunay import DelaunayComplex
from .alpha import AlphaComplex
from .bottleneck import bottleneck_distance

__all__ = [
    "SimplexTree",
    "DelaunayComplex",
    "AlphaComplex",
    "bottleneck_distance",
]
