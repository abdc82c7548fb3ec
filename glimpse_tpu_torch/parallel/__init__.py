"""Device meshes: the points/tracks axis cut over devices, and the batched
tracker over such a mesh."""
from . import mesh, tracker
from .mesh import get_mesh, points_sharding, replicated_sharding, shard_batch
from .tracker import MeshTracker

__all__ = ["mesh", "tracker", "get_mesh", "points_sharding", "replicated_sharding", "shard_batch", "MeshTracker"]
