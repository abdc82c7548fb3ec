"""Device meshes over the points axis for the batched tracker.

The counterpart of :mod:`glimpse_tpu.parallel.mesh`. A mesh is a 1-D
sequence of ``torch.device`` entries over the *points* axis: per-point
arrays (particles, weights, templates, motion parameters) are cut into one
contiguous slice per entry and each slice lives on its entry's device;
images and cameras are replicated. Every tracker operation is pointwise
over points, so the slices never exchange data (see
:class:`~glimpse_tpu_torch.parallel.tracker.MeshTracker`).

A device may repeat in a mesh: ``get_mesh(devices=["cuda"] * 4)`` holds
four slices on one card, and ``["cpu"] * 3`` three on the host.

Several processes (one per card, or several sharing one) set up with
:func:`initialize_distributed`, each track their
:func:`local_points_slice` on a tracker of their own, and one collective,
:func:`gather_points`, stitches the results; the step needs no collective.

The two cuts differ. :class:`PointsSharding` (a mesh within one process)
cuts by ``numpy.array_split``: the first ``n % size`` slices hold one point
more than the others. :func:`local_points_slice` (one slice a process) cuts
as the reference does, ceil-divided: every process but the last holds
``ceil(n / processes)`` points, the last the rest, possibly none. For 10
points over 4 they are (3, 3, 2, 2) and (3, 3, 3, 1).
"""
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D sequence of devices under one axis name."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (config.points_axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)


def get_mesh(n_devices: Optional[int] = None, axis: str = None, devices: Sequence[Device] = None) -> Mesh:
    """A 1-D mesh over the points axis.

    Arguments:
        n_devices: Number of devices (default: all of ``devices``).
        axis: Mesh axis name (default: ``config.points_axis``).
        devices: The mesh's devices, in order, repeats allowed (default:
            every CUDA device). A host with no card raises unless it is
            named: ``devices=["cpu"]``.
    """
    if devices is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError('get_mesh found no CUDA device; to run on the CPU, pass devices=["cpu"]')
        devices = [f"cuda:{i}" for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("A mesh needs at least one device")
    return Mesh(tuple(devices), (axis or config.points_axis,))


@dataclasses.dataclass(frozen=True)
class PointsSharding:
    """Array axis ``axis`` cut into one contiguous slice per mesh entry:
    the first ``n % size`` slices hold one point more than the others."""

    mesh: Mesh
    axis: int = 0

    def slices(self, n: int) -> List[slice]:
        """The slice of ``n`` points that each mesh entry holds."""
        bounds = np.cumsum([0] + [len(part) for part in np.array_split(np.arange(n), self.mesh.size)])
        return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """The whole array on every mesh entry."""

    mesh: Mesh


def points_sharding(mesh: Mesh, points_axis_index: int = 0) -> PointsSharding:
    """The sharding that cuts array axis ``points_axis_index`` over the mesh."""
    return PointsSharding(mesh, points_axis_index)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    """The sharding that copies an array to every mesh entry."""
    return ReplicatedSharding(mesh)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh, points_axes: dict = None) -> list:
    """Place a tree (dicts, lists and tuples of arrays or tensors) on a mesh.

    ``points_axes`` maps ``id(leaf)`` to the leaf's points axis; unlisted
    leaves are replicated. Returns one tree per mesh entry, of the same
    structure, whose leaves are tensors on that entry's device: its slice
    of each points-axis leaf, a copy of every other leaf.
    """
    points_axes = points_axes or {}
    n_by_axis = {}

    def find_n(leaf):
        axis = points_axes.get(id(leaf))
        if axis is not None:
            n_by_axis.setdefault(int(np.shape(leaf)[axis]), axis)
        return leaf

    _map_tree(find_n, tree)
    if len(n_by_axis) > 1:
        raise ValueError(f"Points-axis leaves disagree on the number of points: {sorted(n_by_axis)}")
    n = next(iter(n_by_axis), 0)
    slices = points_sharding(mesh).slices(n)
    shards = []
    for device, sl in zip(mesh.devices, slices):

        def put(leaf: Any, device=device, sl=sl):
            t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
            axis = points_axes.get(id(leaf))
            if axis is not None:
                t = t.narrow(axis, sl.start, sl.stop - sl.start)
            return t.to(device)

        shards.append(_map_tree(put, tree))
    return shards


def initialize_distributed(coordinator_address: str = None, num_processes: int = None,
                           process_id: int = None, backend: str = "gloo") -> None:
    """Join the processes of one multi-process run
    (``torch.distributed.init_process_group``).

    ``coordinator_address`` is ``host:port`` of process 0 (a
    ``tcp://`` prefix may be given); ``num_processes`` and ``process_id``
    are the world size and this process's rank. Arguments left None come
    from torch's environment variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).

    ``backend`` defaults to ``gloo`` on every host, with cards or without:
    the group carries the set-up and one host-side collective of results
    (:func:`gather_points`), and the tracker's step has none, so nothing
    needs NCCL; and NCCL refuses two ranks on one card, which is how several
    processes share a card. Each process then tracks its
    :func:`local_points_slice` on a device of its choosing.
    """
    import torch.distributed as dist

    kwargs = {}
    if coordinator_address is not None:
        address = coordinator_address
        kwargs["init_method"] = address if "://" in address else f"tcp://{address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)


def _world() -> Tuple[int, int]:
    """(world size, rank) of the running group, (1, 0) without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def local_points_slice(n_points: int, mesh: Mesh = None) -> slice:
    """The slice of the global points axis owned by this process.

    One process owns every point; under :func:`initialize_distributed`
    each of the world's processes owns a contiguous ceil-divided share (the
    reference's cut; see the module's docstring).
    """
    n_procs, rank = _world()
    if n_procs == 1:
        return slice(0, n_points)
    per_host = -(-n_points // n_procs)
    start = rank * per_host
    return slice(start, min(start + per_host, n_points))


def gather_points(local: torch.Tensor, n_points: int, axis: int = 0) -> torch.Tensor:
    """Every process's :func:`local_points_slice` of a result, stitched in
    point order on every process: one ``all_gather`` over the group, on host
    copies (``gloo``, which takes every float dtype of the tracker, bfloat16
    included). ``local`` holds this process's slice along ``axis``;
    the result, on ``local``'s device, holds all ``n_points``. Without a
    group it returns ``local``.
    """
    import torch.distributed as dist

    n_procs, _ = _world()
    if n_procs == 1:
        return local
    per_host = -(-n_points // n_procs)
    host = local.detach().cpu()
    pad = list(host.shape)
    pad[axis] = per_host - host.shape[axis]
    host = torch.cat([host, host.new_zeros(pad)], dim=axis).contiguous()
    parts = [torch.empty_like(host) for _ in range(n_procs)]
    dist.all_gather(parts, host)
    return torch.cat(parts, dim=axis).narrow(axis, 0, n_points).to(local.device)
