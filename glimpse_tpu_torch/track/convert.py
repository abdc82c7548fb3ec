"""Build the port's motion and state from the reference's leaves as numpy arrays.

``glimpse_tpu.track.batch.BatchMotion`` and ``BatchState`` are dataclasses
of arrays; handed over as numpy (for example ``dataclasses.asdict`` of a
motion, arrays through ``numpy.asarray``), they become the port's objects
here, so both packages can compute from the same state. Camera vectors pass
through as (O, 20) float32 tensors. A raster (DEM, DEM sigma or viewshed)
is a mapping of its fields.
"""
from typing import Mapping

import torch

from .batch import BatchMotion, BatchState, DeviceRaster
from .batch import _as_tensor as _tensor


def raster_from_numpy(leaves: Mapping, device) -> DeviceRaster:
    """A :class:`DeviceRaster` from ``array``, ``x0``, ``y0``, ``dx``, ``dy``."""
    return DeviceRaster(*(_tensor(leaves[k], device) for k in ("array", "x0", "y0", "dx", "dy")))


def motion_from_numpy(leaves: Mapping, device) -> BatchMotion:
    """A :class:`BatchMotion` of any of the four kinds from the reference
    motion's fields.

    ``dem`` and ``dem_sigma`` are mappings of raster fields (see
    :func:`raster_from_numpy`).
    """
    arrays = ("xy", "xy_sigma", "v_mean", "v_sigma", "a_mean", "a_sigma", "slope_sigma")
    return BatchMotion(
        kind=str(leaves["kind"]),
        dem=raster_from_numpy(leaves["dem"], device),
        dem_sigma=raster_from_numpy(leaves["dem_sigma"], device),
        use_dem_sigma=bool(leaves["use_dem_sigma"]),
        **{k: _tensor(leaves[k], device) for k in arrays},
    )


def state_from_numpy(particles, weights, templates, template_table, template_duv, step,
                     valid, device, seed: int = 0) -> BatchState:
    """A :class:`BatchState` from the reference state's arrays.

    ``valid`` None (a state from before the reference carried validity)
    means every point valid, as the reference's step reads it. The
    reference's PRNG key does not carry over: draws after this state come
    from a new ``torch.Generator`` seeded with ``seed``, unless injected.
    """
    device = torch.device(device)
    particles = _tensor(particles, device)
    return BatchState(
        particles=particles,
        weights=_tensor(weights, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        templates=_tensor(templates, device),
        template_table=_tensor(template_table, device),
        template_duv=_tensor(template_duv, device),
        step=int(step),
        valid=(
            torch.ones(particles.shape[0], dtype=torch.float32, device=device)
            if valid is None else _tensor(valid, device)
        ),
    )
