"""Build the port's motion and state from the reference's leaves as numpy arrays.

``glimpse_tpu.track.batch.BatchMotion`` and ``BatchState`` are dataclasses
of arrays; handed over as numpy (for example ``dataclasses.asdict`` of a
motion, arrays through ``numpy.asarray``), they become the port's objects
here, so both packages can compute from the same state. Camera vectors pass
through as (O, 20) float32 tensors. A raster (DEM, DEM sigma or viewshed)
is a mapping of its fields.

The reference's host objects come across as plain data too: a ``Camera`` as
its 20-float vector (:func:`camera_from_numpy`), a ``Raster`` as its array
and outer limits (:func:`host_raster_from_numpy`), a host motion model as
its attributes (:func:`host_motion_from_numpy`), so tests build both sides
from one set of NumPy arrays.
"""
import inspect
from typing import Mapping

import numpy as np
import torch

from ..camera import Camera
from ..ops import projection
from ..raster import Raster
from . import motion as host_motion
from .batch import BatchMotion, BatchState, DeviceRaster
from .batch import _as_tensor as _tensor

HOST_MOTIONS = {
    "cartesian": host_motion.CartesianMotion,
    "cylindrical": host_motion.CylindricalMotion,
    "tangent": host_motion.TangentCartesianMotion,
    "tangent_cylindrical": host_motion.TangentCylindricalMotion,
}


def camera_from_numpy(vector, correction=False, sensorsz=None) -> Camera:
    """A host :class:`Camera` from a 20-float camera vector (``to_array()``
    of the reference's), bit for bit, with its ``correction`` setting."""
    vector = np.asarray(vector, dtype=float)
    parts = {
        name: vector[getattr(projection, name.upper())]
        for name in ("xyz", "viewdir", "imgsz", "f", "c", "k", "p")
    }
    return Camera(sensorsz=sensorsz, correction=correction, **parts)


def host_raster_from_numpy(array, xlim, ylim, datetime=None) -> Raster:
    """A host :class:`Raster` from its array and outer limits."""
    return Raster(np.array(array), x=np.asarray(xlim, dtype=float), y=np.asarray(ylim, dtype=float),
                  datetime=datetime)


def host_motion_from_numpy(kind: str, fields: Mapping):
    """A host motion model of ``kind`` (see ``HOST_MOTIONS``) from the
    reference model's attributes (``vars(model)``).

    ``dem`` and ``dem_sigma`` are port :class:`Raster` objects (passed
    through, so models can share one), mappings with ``array``, ``xlim``
    and ``ylim``, numbers, or None. ``rng`` may be a
    ``numpy.random.Generator``: its state is copied, so both models draw the
    same numbers from then on.
    """
    def raster(value):
        if isinstance(value, Mapping):
            return host_raster_from_numpy(value["array"], value["xlim"], value["ylim"])
        return value

    cls = HOST_MOTIONS[kind]
    # Attributes a subclass inherits but its constructor does not take (the
    # cylindrical models carry the cartesian defaults) stay behind.
    taken = set(inspect.signature(cls.__init__).parameters) - {"self", "seed", "dem", "dem_sigma"}
    args = {k: v for k, v in fields.items() if k in taken}
    model = cls(dem=raster(fields["dem"]), dem_sigma=raster(fields.get("dem_sigma")), **args)
    if fields.get("rng") is not None:
        model.rng.bit_generator.state = fields["rng"].bit_generator.state
    return model


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


#: Tensor dtypes of the NumPy dtypes a reference state arrives in, by name
#: (``bfloat16`` is ``ml_dtypes``', which NumPy itself does not have).
STATE_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16, "bfloat16": torch.bfloat16,
}


def tensor_from_numpy(array, device) -> torch.Tensor:
    """An array of the reference's state as a tensor of the same dtype on
    ``device``, exactly: float16, float32 and float64 as they are, a
    bfloat16 array (``ml_dtypes``) through its ``uint16`` bits."""
    array = np.asarray(array)
    dtype = STATE_DTYPES.get(array.dtype.name)
    if dtype is None:
        raise ValueError(f"a state array of {array.dtype} has no tensor dtype here")
    if dtype == torch.bfloat16:
        return torch.from_numpy(array.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(array.copy()).to(device)


def state_from_numpy(particles, weights, templates, template_table, template_duv, step,
                     valid, device, seed: int = 0) -> BatchState:
    """A :class:`BatchState` from the reference state's arrays.

    Each array keeps its dtype (see :func:`tensor_from_numpy`): a state the
    reference carried in bfloat16, float16 or float64 arrives in it, bit for
    bit. ``valid`` None (a state from before the reference carried
    validity) means every point valid, as the reference's step reads it. The
    reference's PRNG key does not carry over: draws after this state come
    from a new ``torch.Generator`` seeded with ``seed``, unless injected.
    """
    device = torch.device(device)
    particles = tensor_from_numpy(particles, device)
    return BatchState(
        particles=particles,
        weights=tensor_from_numpy(weights, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        templates=tensor_from_numpy(templates, device),
        template_table=tensor_from_numpy(template_table, device),
        template_duv=tensor_from_numpy(template_duv, device),
        step=int(step),
        valid=(
            torch.ones(particles.shape[0], dtype=particles.dtype, device=device)
            if valid is None else tensor_from_numpy(valid, device)
        ),
    )
