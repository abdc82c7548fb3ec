"""The batched tracker with its points cut over a mesh.

:class:`MeshTracker` is what ``BatchTracker(..., mesh=mesh)`` and
``BatchTracker.from_observers(..., mesh=mesh)`` build. It holds one plain
:class:`~glimpse_tpu_torch.track.batch.BatchTracker` per mesh entry, over that
entry's contiguous slice of the points (:func:`.mesh.points_sharding`) on
that entry's device: the slice's motion, state, generator and templates live
there, and each frame is copied there as a step needs it.

Its state is a :class:`MeshState`: one ``BatchState`` a slice, each on its
slice's device with a generator of its own, drawn from the caller's
generator and the slice's index (:func:`slice_generators`). Slices never
exchange data, so a step joins nothing: it launches each slice's step in
turn from one thread, and no slice's step waits for the device, so the
slices of a mesh over several cards run at once. In :meth:`track` and
:meth:`track_stream` each slice's step after the first is one replay of
that slice's own captured CUDA graph
(:class:`~glimpse_tpu_torch.track.batch.StepProgram`, the counterpart of
the reference's program placed by ``_shard``), so the thread issues a
handful of calls a slice a step; :meth:`step` issues every slice's kernels
eagerly (about a thousand a step each). One process a card
(:func:`.mesh.initialize_distributed`, :func:`.mesh.local_points_slice`,
:func:`.mesh.gather_points`) issues each slice from its own interpreter.
Outputs are gathered on the tracker's ``device`` once per :meth:`track` call, or once per chunk of
:meth:`track_stream` (once a step through :meth:`step`).
``track/checkpoint.py`` saves a ``MeshState`` slice by slice and resumes it
on a mesh of the same devices.

Under injected draws (``noise=``) the mesh does not change results: on the
CPU a sliced run equals the unsliced one bit for bit.
"""
import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import torch

from .. import profiling
from ..track.batch import BatchState, BatchTracker
from .mesh import Mesh, points_sharding

#: The points axis of each per-point field of a BatchState.
POINTS_AXIS = {"particles": 0, "weights": 0, "valid": 0, "templates": 1, "template_table": 1, "template_duv": 1}


@dataclasses.dataclass
class MeshState:
    """The state of a :class:`MeshTracker` between steps: one
    :class:`BatchState` a mesh slice, in point order, each on its slice's
    device and with its own generator there."""

    parts: List[BatchState]

    @property
    def step(self) -> int:
        return self.parts[0].step

    def joined(self, name: str, device) -> torch.Tensor:
        """Field ``name`` of every slice in point order, on ``device``."""
        return torch.cat([getattr(part, name).to(device) for part in self.parts], dim=POINTS_AXIS[name])


def slice_generators(generator: torch.Generator, devices: Sequence) -> List[torch.Generator]:
    """One generator a slice, on the slice's device, seeded from a digest of
    ``generator``'s state and the slice's index. ``generator`` is read, not
    advanced, and reading a card's generator state does not wait for the
    card."""
    state = generator.get_state().numpy().tobytes()
    generators = []
    for index, device in enumerate(devices):
        digest = hashlib.blake2b(state + index.to_bytes(8, "little"), digest_size=8).digest()
        generators.append(torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1))
    return generators


def _noise_slice(noise, points: slice) -> dict:
    """Injected draws of a slice of the points (every key's leading axis is N)."""
    return {k: v if v is None else v[points] for k, v in (noise or {}).items()}


def _to(x, device):
    return x.to(device, non_blocking=True) if isinstance(x, torch.Tensor) else x


class MeshTracker(BatchTracker):
    """A :class:`BatchTracker` over ``mesh``: the arguments are
    BatchTracker's; ``device`` is where images are uploaded and where outputs
    are gathered."""

    def __init__(self, camera_vectors, corrections, sigmas, motion, config=None, device="cuda", viewshed=None,
                 mesh: Mesh = None) -> None:
        super().__init__(camera_vectors, corrections, sigmas, motion, config=config, device=device, viewshed=viewshed)
        self.mesh = mesh
        self.slices: List[slice] = points_sharding(mesh).slices(self.motion.n_points)
        self.parts = [
            BatchTracker(camera_vectors, corrections, sigmas, self.motion.take(points), config=self.config,
                         device=part_device, viewshed=self.viewshed)
            for part_device, points in zip(mesh.devices, self.slices)
        ]

    def initialize(self, generator: torch.Generator, images0, noise=None, camera_vectors=None,
                   obs_mask0=None) -> MeshState:
        """:meth:`BatchTracker.initialize` of every slice, each with its
        generator from :func:`slice_generators`."""
        generators = slice_generators(generator, self.mesh.devices)
        return MeshState([
            part.initialize(g, _to(images0, part.device), noise=_noise_slice(noise, points),
                            camera_vectors=camera_vectors, obs_mask0=obs_mask0)
            for part, points, g in zip(self.parts, self.slices, generators)
        ])

    def _slices(self, how: str, state: MeshState, images, dt, noise=None, **kwargs) -> Tuple[MeshState, list]:
        """Each slice's ``how`` (``"step"`` or ``"_advance"``), launched in
        turn; the outputs stay on the slices' devices."""
        steps = [
            getattr(part, how)(part_state, _to(images, part.device), _to(dt, part.device),
                               noise=_noise_slice(noise, points), **kwargs)
            for part, points, part_state in zip(self.parts, self.slices, state.parts)
        ]
        return MeshState([s for s, _ in steps]), [out for _, out in steps]

    def _advance(self, state: MeshState, images, dt, noise=None, **kwargs) -> Tuple[MeshState, list]:
        """Each slice's :meth:`BatchTracker._advance`: on a card, after the
        first step, one replay of the slice's own captured graph, with its
        own generator and memory pool."""
        return self._slices("_advance", state, images, dt, noise=noise, **kwargs)

    def _release(self) -> None:
        for part in self.parts:
            part._release()

    def _join(self, out: list) -> dict:
        return {k: torch.cat([o[k].to(self.device) for o in out], dim=0) for k in out[0]}

    def _collect(self, outs: list) -> dict:
        with profiling.span("entry.collect"):
            per_part = [{k: torch.stack([step[p][k] for step in outs]) for k in outs[0][p]}
                        for p in range(len(self.parts))]
            return {k: torch.cat([o[k].to(self.device) for o in per_part], dim=1) for k in per_part[0]}

    def step(self, state: MeshState, images, dt, noise=None, camera_vectors=None, obs_mask=None,
             init_template_for=()) -> Tuple[MeshState, dict]:
        """:meth:`BatchTracker.step` of every slice, eagerly; the outputs
        are joined on ``device``."""
        state, out = self._slices("step", state, images, dt, noise=noise, camera_vectors=camera_vectors,
                                  obs_mask=obs_mask, init_template_for=init_template_for)
        return state, self._join(out)
