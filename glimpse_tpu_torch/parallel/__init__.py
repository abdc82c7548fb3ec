"""Device meshes: the points/tracks axis cut over devices, the batched
tracker over such a mesh, and the run of one process per card."""
from . import mesh, tracker
from .mesh import (
    gather_points,
    get_mesh,
    initialize_distributed,
    local_points_slice,
    points_sharding,
    replicated_sharding,
    shard_batch,
)
from .tracker import MeshState, MeshTracker, slice_generators

__all__ = [
    "mesh", "tracker", "get_mesh", "points_sharding", "replicated_sharding", "shard_batch", "initialize_distributed",
    "local_points_slice", "gather_points", "MeshTracker", "MeshState", "slice_generators",
]
