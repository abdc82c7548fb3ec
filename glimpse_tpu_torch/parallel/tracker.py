"""The batched tracker with its points cut over a mesh.

:class:`MeshTracker` is what ``BatchTracker(..., mesh=mesh)`` and
``BatchTracker.from_observers(..., mesh=mesh)`` build. It holds one plain
:class:`~glimpse_tpu_torch.track.batch.BatchTracker` per mesh entry, over that
entry's contiguous slice of the points (:func:`.mesh.points_sharding`) on
that entry's device.

Its state is an ordinary :class:`~glimpse_tpu_torch.track.batch.BatchState`
on the tracker's ``device``. A step hands each slice its rows of the state
(views, where the entry's device is the tracker's), runs the slices one after
the other, and joins their new states and outputs in point order. So a state
checkpoints and resumes as it does without a mesh, and ``track`` and
``track_stream`` are the plain tracker's.
"""
import dataclasses
from typing import List, Tuple

import torch

from ..track.batch import BatchState, BatchTracker
from .mesh import Mesh, points_sharding

#: The points axis of each per-point field of a BatchState.
POINTS_AXIS = {"particles": 0, "weights": 0, "valid": 0, "templates": 1, "template_table": 1, "template_duv": 1}


def _noise_slice(noise, points: slice) -> dict:
    """Injected draws of a slice of the points (every key's leading axis is N)."""
    return {k: v if v is None else v[points] for k, v in (noise or {}).items()}


class MeshTracker(BatchTracker):
    """A :class:`BatchTracker` over ``mesh``: the arguments are
    BatchTracker's; ``device`` is where images are uploaded and where
    states and outputs are joined."""

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

    def _part_state(self, state: BatchState, points: slice, device) -> BatchState:
        """The rows of ``state`` that one slice holds, on its device."""
        rows = {
            name: getattr(state, name).narrow(axis, points.start, points.stop - points.start).to(device)
            for name, axis in POINTS_AXIS.items()
        }
        return dataclasses.replace(state, **rows)

    def _joined(self, states: List[BatchState], generator, step: int) -> BatchState:
        """The slices' states as one, in point order, on ``device``."""
        fields = {
            name: torch.cat([getattr(s, name).to(self.device) for s in states], dim=axis)
            for name, axis in POINTS_AXIS.items()
        }
        return BatchState(generator=generator, step=step, **fields)

    def initialize(self, generator: torch.Generator, images0, noise=None, camera_vectors=None,
                   obs_mask0=None) -> BatchState:
        """:meth:`BatchTracker.initialize` of every slice in turn."""
        states = [
            part.initialize(generator, images0, noise=_noise_slice(noise, points), camera_vectors=camera_vectors,
                            obs_mask0=obs_mask0)
            for part, points in zip(self.parts, self.slices)
        ]
        return self._joined(states, generator, 0)

    def step(self, state: BatchState, images, dt, noise=None, camera_vectors=None, obs_mask=None,
             init_template_for=()) -> Tuple[BatchState, dict]:
        """:meth:`BatchTracker.step` of every slice in turn."""
        states, outs = [], []
        for part, points in zip(self.parts, self.slices):
            new_state, out = part.step(
                self._part_state(state, points, part.device), images, dt, noise=_noise_slice(noise, points),
                camera_vectors=camera_vectors, obs_mask=obs_mask, init_template_for=init_template_for,
            )
            states.append(new_state)
            outs.append(out)
        outputs = {k: torch.cat([out[k].to(self.device) for out in outs], dim=0) for k in outs[0]}
        return self._joined(states, state.generator, state.step + 1), outputs
