"""The DEM prior kernel (``csrc/prior.cu``) and its wrapper.

Replaces no TPU kernel: the reference computes the prior by XLA ops
(``glimpse_tpu/track/batch.py:BatchMotion.log_likelihoods``). The tracker
calls :func:`dem_prior` once a step where its motion is informative
(``track/batch.py:BatchMotion.log_likelihoods``, cartesian or cylindrical
motion with a DEM sigma): each particle's (DEM - z)^2 / (2 sigma^2), both
rasters read bilinearly at its (x, y), 0 where sigma <= 0. The wrapper picks
by device alone: a CPU tensor runs :func:`dem_prior_plain`, two
``DeviceRaster.sample`` calls and the prior's ops; a CUDA tensor launches
the kernel, or raises.

Particles (N, P, >= 3) are float32, float64, float16 or bfloat16; each
raster is a ``DeviceRaster`` (or any object with its ``array``, ``x0``,
``y0``, ``dx``, ``dy`` and ``sample``): float32 values (H, W) and float32
0-d grid scalars, on the particles' device, which the kernel reads there, so
a call never waits for the card and can be captured in a CUDA graph. The
prior is float64 for float64 particles, else float32, as the plain
version's promotions make it, and the kernel's is bit-equal to the plain
version's on the card. ``dem_prior.launches`` and ``.captured`` count the
kernel's launches as :mod:`._build` says.
"""
import ctypes

import torch

from . import _build
from ._build import DTYPE_CODES

#: The fields of a raster the kernel reads: its values and grid scalars.
RASTER_FIELDS = ("array", "x0", "y0", "dx", "dy")


def dem_prior_plain(particles, dem, dem_sigma):
    """The DEM prior (N, P) of particles (N, P, >= 3) by plain ops: the DEM
    and its sigma sampled bilinearly at each particle's (x, y), then
    (z_dem - z)^2 / (2 sigma^2), 0 where sigma <= 0."""
    xy = particles[..., 0:2]
    z = dem.sample(xy)
    z_sigma = dem_sigma.sample(xy)
    safe = torch.where(z_sigma > 0, z_sigma, 1.0)
    ll = (z - particles[..., 2]) ** 2 / (2 * safe * safe)
    return torch.where(z_sigma > 0, ll, 0.0)


def compute_dtype(particles_dtype: torch.dtype) -> torch.dtype:
    """The prior's type: the particles' and the float32 rasters' promoted."""
    return torch.promote_types(particles_dtype, torch.float32)


def _raster_tensors(raster, name: str, device) -> tuple:
    """A raster's values and grid scalars, checked: ValueError unless the
    values are (H, W) float32 of at least one cell and the scalars 0-d
    float32, all on ``device``."""
    tensors = tuple(getattr(raster, field) for field in RASTER_FIELDS)
    values, scalars = tensors[0], tensors[1:]
    if (values.ndim != 2 or values.numel() == 0 or any(t.shape != () for t in scalars)
            or any(t.dtype != torch.float32 for t in tensors)):
        raise ValueError(
            f"dem_prior takes a {name} of float32 values (H, W) and float32 0-d grid scalars, got values"
            f" {values.dtype} {tuple(values.shape)} and scalars {[(t.dtype, tuple(t.shape)) for t in scalars]}"
        )
    if any(t.device != device for t in tensors):
        raise ValueError(f"dem_prior takes its {name} on the particles' device, {device}")
    return (values.contiguous(), *scalars)


@_build.kernel(
    "prior", "glimpse_dem_prior",
    [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
def dem_prior(particles: torch.Tensor, dem, dem_sigma) -> torch.Tensor:
    """The DEM prior (N, P) of particles (N, P, >= 3) against the rasters
    ``dem`` and ``dem_sigma``, equal to :func:`dem_prior_plain` as the
    module's docstring says; the types and devices it gives, else
    ValueError."""
    if particles.ndim != 3 or particles.shape[2] < 3:
        raise ValueError(f"dem_prior takes particles (N, P, >= 3), got {tuple(particles.shape)}")
    if particles.dtype not in DTYPE_CODES:
        raise ValueError(f"dem_prior takes particles of a type of {tuple(DTYPE_CODES)}, got {particles.dtype}")
    device = particles.device
    _raster_tensors(dem, "DEM", device)
    _raster_tensors(dem_sigma, "DEM sigma", device)
    if not _build.runs_kernel("prior", device):
        return dem_prior_plain(particles, dem, dem_sigma)
    out = torch.empty(particles.shape[:2], dtype=compute_dtype(particles.dtype), device=device)
    if out.numel() == 0:
        return out
    _build.launch("prior", device, *launch_args(out, particles, dem, dem_sigma))
    return out


def launch_args(out, particles, dem, dem_sigma) -> tuple:
    """The kernel's arguments, the stream aside, as :func:`_build.launch`
    takes them (a tensor for each pointer), for a call of :func:`dem_prior`
    that writes ``out``."""
    particles = particles.contiguous()
    dem_tensors = _raster_tensors(dem, "DEM", particles.device)
    sigma_tensors = _raster_tensors(dem_sigma, "DEM sigma", particles.device)
    N, P, stride = particles.shape
    return (particles, out, *dem_tensors, *sigma_tensors, N * P, stride, *dem_tensors[0].shape,
            *sigma_tensors[0].shape, DTYPE_CODES[particles.dtype])
