"""Multi-device meshes of the PyTorch port (one process, many devices)."""

from .sharding import (
    Mesh,
    MeshCudaFloodEngine,
    MeshFloodEngine,
    make_mesh,
    sharded_flood_min_distances,
)

__all__ = [
    "Mesh",
    "MeshCudaFloodEngine",
    "MeshFloodEngine",
    "make_mesh",
    "sharded_flood_min_distances",
]
