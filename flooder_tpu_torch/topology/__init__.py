"""Host topology layer of the PyTorch port (numpy and scipy only).

- :class:`SimplexTree`: columnar filtered complex with a gudhi-compatible
  surface.
- :class:`DelaunayComplex`: Delaunay triangulation (scipy's Qhull).
- Persistent homology: the C++ twist/clearing boundary reduction built
  from ``native/src/persistence.cpp``.

``AlphaComplex`` and ``bottleneck_distance`` are not ported yet.
"""

from .simplex_tree import SimplexTree
from .delaunay import DelaunayComplex

__all__ = ["SimplexTree", "DelaunayComplex"]
