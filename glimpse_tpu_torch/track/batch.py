"""Batched particle-filter tracker on tensors: N points x P particles per step.

The counterpart of :mod:`glimpse_tpu.track.batch` on one device. One step:

1. evolve the particles (cartesian, cylindrical, tangent or
   tangent-cylindrical motion) and latch each point's validity (all finite,
   and on visible viewshed cells when there is a viewshed); where the
   motion carries a DEM sigma, its DEM prior (kernel ``dem_prior``, one
   launch: both bilinear raster reads a particle and the prior);
2. for every observer, project the particles through its camera and cut a
   search tile at each point's weighted-mean projection (kernel
   ``project_extract``, one launch for all observers);
3. on the (O*N) tiles stacked observer-major: normalize, match each tile's
   histogram to its template's quantile table and take the median high-pass
   (kernel ``median_highpass``, one launch for all observers, for the
   windows the kernel covers: odd taps, at most 49; any other window takes
   the plain version, chosen by ``kernels.highpass.covers`` before a launch);
4. SSE map against the template, then the cubic B-spline of the SSE
   surface (exact at each particle, or on an upsampled grid read at the
   nearest cell or bilinearly; or bilinear interpolation of the surface) at
   every particle gives its negative log likelihood; an observation mask
   zeroes the observers without an image this step;
5. weights (fresh each step, or accumulated under an effective-sample-size
   threshold), moments, then resampling: systematic through the kernel
   ``systematic_resample``, the other methods by a row gather.

``step`` is the eager function, the public per-step API. ``track`` and
``track_stream`` loop over :class:`StepProgram`: on a card each step after
the first is one replay of a CUDA graph captured from ``step``, the
counterpart of the reference's compiled programs (``_track_program``,
``_chunk_program``, the jitted stream step). Randomness comes from an
explicit ``torch.Generator``; ``noise=`` takes injected draws with the
reference's keys and shapes, so both packages can run in lockstep. Nothing
in a step waits for the device, so a host that streams frames runs ahead of
it.

With a ``mesh`` (:func:`glimpse_tpu_torch.parallel.get_mesh`) the
constructor builds a :class:`glimpse_tpu_torch.parallel.tracker.MeshTracker`,
which runs one tracker per contiguous slice of the points, each on its
mesh entry's device.
"""
import contextlib
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import graphs, profiling
from ..kernels import prior as prior_kernel
from ..kernels import project as project_kernel
from ..kernels import spline as spline_kernel
from ..kernels.highpass import highpass as routed_highpass
from ..kernels.resample import systematic_resample
from ..ops import imageproc, ncc, projection, resampling, sampling

MOTION_KINDS = ("cartesian", "cylindrical", "tangent", "tangent_cylindrical")
RESAMPLE_METHODS = ("systematic",) + tuple(resampling.METHODS)
SSE_SAMPLE_MODES = ("einsum", "nearest", "bilinear")
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _as_tensor(x, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device``; arrays are copied (JAX hands over
    read-only ones). Camera, motion and DEM parameters take the default,
    float32, as the reference keeps them; state, frames, time steps and
    masks take the configuration's dtype. A host array crosses as float32
    (float64 for a float64 tensor) and is cast on the device, so nothing is
    rounded on the host; a bfloat16 array of the reference (``ml_dtypes``)
    widens exactly."""
    if x is None:
        raise TypeError("expected an array, got None")
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    host = np.float64 if dtype == torch.float64 else np.float32
    return torch.as_tensor(np.array(x, dtype=host), device=device).to(dtype)


def _widened(xy, scalar: torch.Tensor):
    """``xy`` in the type it and the 0-d ``scalar`` promote to under the
    reference's rules: a bfloat16 or float16 tensor meeting a float32
    scalar becomes float32, as a JAX array does, where torch would keep the
    16-bit type for a 0-d operand."""
    return xy.to(torch.promote_types(xy.dtype, scalar.dtype))


def _host_flags(mask) -> Tuple[bool, ...]:
    """A mask (O,) read on the host as a tuple of bools (nonzero is True)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return tuple(bool(v) for v in np.asarray(mask) > 0)


# ---- Device raster (DEM, viewshed) ---- #


@dataclasses.dataclass
class DeviceRaster:
    """A raster on the device: values (H, W) and an affine grid (0-d tensors)."""

    array: torch.Tensor
    x0: torch.Tensor  # world x of the left outer edge
    y0: torch.Tensor  # world y of the top outer edge
    dx: torch.Tensor  # signed cell size in x
    dy: torch.Tensor  # signed cell size in y

    def sample(self, xy):
        """Bilinear sample at world points (..., 2), in the type ``xy`` and
        the grid's float32 scalars promote to."""
        xy = _widened(xy, self.x0)
        cols = (xy[..., 0] - self.x0) / self.dx - 0.5
        rows = (xy[..., 1] - self.y0) / self.dy - 0.5
        if self.array.shape == (1, 1):
            return self.array[0, 0].expand(rows.shape)
        return sampling.bilinear_sample(self.array, rows, cols)

    def sample_nearest(self, xy):
        """Nearest-cell sample at world points (..., 2); outside cells clamp to the edge."""
        xy = _widened(xy, self.x0)
        H, W = self.array.shape
        cols = torch.floor((xy[..., 0] - self.x0) / self.dx).long().clamp(0, W - 1)
        rows = torch.floor((xy[..., 1] - self.y0) / self.dy).long().clamp(0, H - 1)
        if self.array.shape == (1, 1):
            return self.array[0, 0].expand(rows.shape)
        return self.array[rows, cols]

    @classmethod
    def constant(cls, value: float, device="cuda") -> "DeviceRaster":
        """An infinite-extent constant raster."""
        return cls(
            array=torch.full((1, 1), float(value), device=device),
            x0=torch.tensor(0.0, device=device), y0=torch.tensor(0.0, device=device),
            dx=torch.tensor(1e30, device=device), dy=torch.tensor(1e30, device=device),
        )

    @classmethod
    def from_raster(cls, raster, device="cuda") -> "DeviceRaster":
        """Upload a host :class:`glimpse_tpu_torch.Raster`: its array, and
        its origin and cell size rounded to float32 as the reference rounds
        them."""
        scalars = (raster.xlim[0], raster.ylim[0], raster.d[0], raster.d[1])
        return cls(
            _as_tensor(raster.array, device),
            *(torch.tensor(float(v), dtype=torch.float32, device=device) for v in scalars),
        )

    def to(self, device) -> "DeviceRaster":
        return DeviceRaster(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _check_start_visible(viewshed, xy) -> None:
    """Refuse points (N, 2) outside the viewshed's extent or on a cell that
    is not visible (value <= 0). Runs on the host, once: through
    ``Raster.sample(order=0)`` for a host raster, as the reference's check
    does, and by the same nearest-cell rule for a :class:`DeviceRaster`."""
    if not isinstance(viewshed, DeviceRaster):
        visible = np.asarray(viewshed.sample(xy.cpu().numpy().astype(np.float64), order=0)) > 0
        if not visible.all():
            raise ValueError(f"Points on non-visible viewshed cells: {np.flatnonzero(~visible).tolist()}")
        return
    array = viewshed.array.cpu().numpy()
    x0, y0, dx, dy = (float(getattr(viewshed, k)) for k in ("x0", "y0", "dx", "dy"))
    xy = xy.cpu().numpy().astype(np.float64)
    H, W = array.shape
    if (H, W) == (1, 1):
        visible = np.full(len(xy), array[0, 0] > 0)
    else:
        xs, ys = sorted((x0, x0 + W * dx)), sorted((y0, y0 + H * dy))
        inside = (xy[:, 0] >= xs[0]) & (xy[:, 0] <= xs[1]) & (xy[:, 1] >= ys[0]) & (xy[:, 1] <= ys[1])
        if not inside.all():
            raise ValueError(f"Points outside the viewshed raster: {np.flatnonzero(~inside).tolist()}")
        cols = np.clip(np.floor((xy[:, 0] - x0) / dx).astype(np.int64), 0, W - 1)
        rows = np.clip(np.floor((xy[:, 1] - y0) / dy).astype(np.int64), 0, H - 1)
        visible = array[rows, cols] > 0
    if not visible.all():
        raise ValueError(f"Points on non-visible viewshed cells: {np.flatnonzero(~visible).tolist()}")


# ---- Motion model ---- #


def _zero_z(v):
    """(..., 3) with the last component set to 0."""
    return torch.cat([v[..., 0:2], torch.zeros_like(v[..., 2:3])], dim=-1)


def _normal(noise, key, shape, generator, device):
    """The injected draws ``noise[key]``, or standard normals from the generator."""
    if noise.get(key) is not None:
        return _as_tensor(noise[key], device)
    return torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass
class BatchMotion:
    """Per-point motion parameters for N points, of one kind.

    ``cartesian`` draws velocities and accelerations in (x, y, z);
    ``cylindrical`` in (speed, heading, z); the tangent kinds keep z on the
    DEM plus an offset that takes a slope-scaled random walk, and have no
    z velocity.
    """

    kind: str
    xy: torch.Tensor  # (N, 2) initial position means
    xy_sigma: torch.Tensor  # (N, 2)
    v_mean: torch.Tensor  # (N, 3) cartesian: vxyz; cylindrical: (vr, theta, vz)
    v_sigma: torch.Tensor  # (N, 3)
    a_mean: torch.Tensor  # (N, 3) accelerations, in the same convention
    a_sigma: torch.Tensor  # (N, 3)
    slope_sigma: torch.Tensor  # (N,) used by the tangent kinds only
    dem: DeviceRaster
    dem_sigma: DeviceRaster
    use_dem_sigma: bool = True

    def __post_init__(self) -> None:
        if self.kind not in MOTION_KINDS:
            raise ValueError(f"motion kind must be one of {MOTION_KINDS}, got {self.kind!r}")

    @property
    def n_points(self) -> int:
        return self.xy.shape[0]

    @property
    def polar(self) -> bool:
        return self.kind in ("cylindrical", "tangent_cylindrical")

    @property
    def tangent(self) -> bool:
        return self.kind in ("tangent", "tangent_cylindrical")

    @property
    def informative(self) -> bool:
        """Whether :meth:`log_likelihoods` can be nonzero."""
        return self.kind in ("cartesian", "cylindrical") and self.use_dem_sigma

    @classmethod
    def from_motions(cls, motions: Sequence, device="cuda") -> "BatchMotion":
        """Stack host per-point motion models into one batched model.

        Takes a sequence of host :mod:`glimpse_tpu_torch.track.motion`
        models (one model per point), all of the same class and sharing
        their DEM rasters; the bridge from ``[motions...]`` to the device
        tracker.
        """
        from . import motion as host_motion

        first = motions[0]
        kinds = {
            host_motion.CartesianMotion: ("cartesian", "vxyz", "axyz"),
            host_motion.CylindricalMotion: ("cylindrical", "vrthz", "arthz"),
            host_motion.TangentCartesianMotion: ("tangent", "vxy", "axy"),
            host_motion.TangentCylindricalMotion: ("tangent_cylindrical", "vrth", "arth"),
        }
        if type(first) not in kinds:
            raise TypeError(f"Unsupported motion model {type(first).__name__}")
        kind, v, a = kinds[type(first)]
        if any(type(m) is not type(first) for m in motions):
            raise ValueError("All motion models must be of the same class")
        if any(m.dem is not first.dem for m in motions):
            raise ValueError("All motion models must share the same dem")

        def stack(attr, width):
            """(N, width) float32, each model's attribute zero-padded or cut."""
            rows = np.zeros((len(motions), width), dtype=np.float32)
            for row, m in zip(rows, motions):
                value = np.atleast_1d(np.asarray(getattr(m, attr), dtype=np.float32))[:width]
                row[: value.size] = value
            return torch.as_tensor(rows, device=device)

        slope = (
            stack("slope_sigma", 1)[:, 0]
            if hasattr(first, "slope_sigma")
            else torch.zeros(len(motions), dtype=torch.float32, device=device)
        )
        dem_sigma = getattr(first, "dem_sigma", None)
        return cls(
            kind=kind,
            xy=stack("xy", 2),
            xy_sigma=stack("xy_sigma", 2),
            v_mean=stack(v, 3),
            v_sigma=stack(v + "_sigma", 3),
            a_mean=stack(a, 3),
            a_sigma=stack(a + "_sigma", 3),
            slope_sigma=slope,
            dem=DeviceRaster.from_raster(first.dem, device=device),
            dem_sigma=(
                DeviceRaster.constant(0.0, device=device)
                if dem_sigma is None
                else DeviceRaster.from_raster(dem_sigma, device=device)
            ),
            use_dem_sigma=dem_sigma is not None,
        )

    def take(self, points: slice) -> "BatchMotion":
        """The motion of a slice of the points (the DEMs are shared)."""
        per_point = ("xy", "xy_sigma", "v_mean", "v_sigma", "a_mean", "a_sigma", "slope_sigma")
        return dataclasses.replace(self, **{name: getattr(self, name)[points] for name in per_point})

    def to(self, device) -> "BatchMotion":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.name not in ("kind", "use_dem_sigma")
        }
        return BatchMotion(kind=self.kind, use_dem_sigma=self.use_dem_sigma, **moved)

    def initialize(self, generator, n_particles: int, noise=None):
        """Initial particles (N, P, 6); ``noise`` may inject "xy" (N, P, 2),
        "z" (N, P) and "v" (N, P, 3) standard-normal draws."""
        N, P = self.n_points, n_particles
        noise = noise or {}
        device = self.xy.device
        xy = self.xy[:, None, :] + self.xy_sigma[:, None, :] * _normal(noise, "xy", (N, P, 2), generator, device)
        z = self.dem.sample(xy)
        if self.use_dem_sigma:
            z = z + self.dem_sigma.sample(xy) * _normal(noise, "z", (N, P), generator, device)
        v = self.v_mean[:, None, :] + self.v_sigma[:, None, :] * _normal(noise, "v", (N, P, 3), generator, device)
        if self.polar:
            vx = v[..., 0] * torch.cos(v[..., 1])
            vy = v[..., 0] * torch.sin(v[..., 1])
            vz = v[..., 2] if self.kind == "cylindrical" else torch.zeros_like(vx)
            v = torch.stack([vx, vy, vz], dim=-1)
        if self.kind == "tangent":
            v = _zero_z(v)
        return torch.cat([xy, z[..., None], v], dim=-1)

    def evolve(self, generator, particles, dt, noise=None):
        """One motion step (N, P, 6) -> (N, P, 6); ``noise`` may inject "a"
        (N, P, 3) and, for the tangent kinds, "zwalk" (N, P).

        The draws are float32, injected or not, and so are the parameters:
        float16 or bfloat16 particles come back float32, as the reference's
        do, and the tracker casts them to its dtype; float64 particles come
        back float64."""
        noise = noise or {}
        N, P = particles.shape[:2]
        a_noise = _normal(noise, "a", (N, P, 3), generator, particles.device)
        a = self.a_mean[:, None, :] + self.a_sigma[:, None, :] * a_noise
        # Each (N, P, 3) draw is freed once used: the step's peak memory is
        # the sum of the temporaries alive at once.
        del a_noise
        # As a JAX array meeting the float64 time step would: torch keeps a
        # tensor's type against a 0-d one.
        a = a.to(torch.promote_types(a.dtype, particles.dtype))
        if self.polar:
            # Radial and tangential acceleration about the current heading.
            vx, vy = particles[..., 3], particles[..., 4]
            vr = torch.sqrt(vx * vx + vy * vy)
            vr_safe = torch.where(vr > 0, vr, 1.0)
            ax = a[..., 0] * (vx / vr_safe) - vy * a[..., 1]
            ay = a[..., 0] * (vy / vr_safe) + vx * a[..., 1]
            az = a[..., 2] if self.kind == "cylindrical" else torch.zeros_like(ax)
            a = torch.stack([ax, ay, az], dim=-1)
        if self.tangent:
            a = _zero_z(a)
        dxyz = dt * particles[..., 3:6] + 0.5 * a * dt ** 2
        v = particles[..., 3:6] + dt * a
        del a
        if not self.tangent:
            return torch.cat([particles[..., 0:3] + dxyz, v], dim=-1)
        # The z offset from the DEM survives resampling: rebuild it from z.
        z_offsets = particles[..., 2] - self.dem.sample(particles[..., 0:2])
        step_len = torch.sqrt(torch.sum(dxyz[..., 0:2] ** 2, dim=-1))
        walk = _normal(noise, "zwalk", (N, P), generator, particles.device)
        z_offsets = z_offsets + self.slope_sigma[:, None] * walk * step_len
        xy = particles[..., 0:2] + dxyz[..., 0:2]
        z = self.dem.sample(xy) + z_offsets
        return torch.cat([xy, z[..., None], v], dim=-1)

    def log_likelihoods(self, particles):
        """DEM-distance prior (N, P) (kernel ``dem_prior``), or zeros where it
        does not apply."""
        if not self.informative:
            return torch.zeros(particles.shape[:2], dtype=particles.dtype, device=particles.device)
        return prior_kernel.dem_prior(particles, self.dem, self.dem_sigma)


# ---- Configuration and state ---- #


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """The settings of the batched tracker that change its results.

    ``resample_threshold`` None resamples every step and overwrites the
    weights with the step's likelihood; a fraction accumulates weights and
    resamples only the points whose effective sample size falls below
    ``resample_threshold * n_particles``.

    ``dtype`` is the type of the state, the frames and the outputs:
    ``torch.float32`` (the default), ``torch.bfloat16``, ``torch.float16`` or
    ``torch.float64``; every kernel takes each. Camera, motion and DEM
    parameters stay float32 and the systematic resampler's threshold table
    is float32 in every dtype, as the reference's Pallas route builds it.
    The projection, the motion step and the spline read of the SSE surface
    widen to float32 where the reference's arrays promote, so a 16-bit
    tracker rounds its tiles, SSE maps, particles and weights, not its
    pixel coordinates. A 16-bit matmul on the card (the spline prefilter
    and upsample) accumulates in float32, as cuBLAS does by default and as
    the reference's XLA keeps float32 inside its fusions.

    ``chip_smoke.py`` phase 23 measures each dtype's speed on the card and
    its distance from the float32 run. bfloat16 holds a coordinate near
    300 px to 2 px, so motion under that a step is lost, as in the Columbia
    recipe (0.06 px a frame). The reference's own note, measured on a TPU,
    is about 7x worse accuracy in bfloat16 with no speed gain there
    (``glimpse_tpu/track/batch.py:393-395``).

    ``sse_sample_mode`` chooses how the cubic spline of the SSE surface is
    read at the particles (``interpolation_order`` 3): ``'einsum'``, the
    default, evaluates the exact spline at each particle (16 taps; the name
    is the reference's, whose form is a dense-basis contraction);
    ``'nearest'`` and ``'bilinear'`` evaluate it once on an
    ``sse_upsample``-times finer grid (two matmuls) and read that grid at
    the nearest fine cell (one gather) or bilinearly (four). With
    ``sse_upsample`` <= 1 those two modes take the exact 16 taps from
    ghost-padded coefficients.
    """

    n_particles: int = 500
    template_size: Tuple[int, int] = (15, 15)  # (height, width)
    search_size: Tuple[int, int] = (31, 31)  # (height, width)
    highpass_size: Tuple[int, int] = (5, 5)
    n_quantiles: int = 256
    interpolation_order: int = 3
    sse_upsample: int = 8
    sse_sample_mode: str = "einsum"  # 'einsum' | 'nearest' | 'bilinear'
    resample_method: str = "systematic"
    resample_threshold: Optional[float] = None
    return_covariances: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {self.dtype!r}")
        if self.sse_sample_mode not in SSE_SAMPLE_MODES:
            raise ValueError(
                f"sse_sample_mode must be 'einsum', 'nearest', or 'bilinear', got {self.sse_sample_mode!r}"
            )
        if not isinstance(self.sse_upsample, (int, np.integer)) or isinstance(self.sse_upsample, bool):
            raise ValueError(f"sse_upsample must be an integer, got {self.sse_upsample!r}")
        if self.resample_method not in RESAMPLE_METHODS:
            raise ValueError(f"resample_method must be one of {RESAMPLE_METHODS}, got {self.resample_method!r}")
        if self.interpolation_order not in (1, 3):
            raise ValueError(f"interpolation_order must be 1 or 3, got {self.interpolation_order!r}")
        if any(s < t for s, t in zip(self.search_size, self.template_size)):
            raise ValueError("search_size must hold template_size")


@dataclasses.dataclass
class BatchState:
    """The filter's state between steps."""

    particles: torch.Tensor  # (N, P, 6)
    weights: torch.Tensor  # (N, P)
    generator: torch.Generator
    templates: torch.Tensor  # (O, N, th, tw) high-passed template tiles
    template_table: torch.Tensor  # (O, N, K) quantile table of pre-highpass values
    template_duv: torch.Tensor  # (O, N, 2) subpixel offsets
    step: int
    valid: torch.Tensor  # (N,) 1.0 while every particle of the point passes


# ---- Observation ---- #


def _particle_validity(particles, viewshed: Optional[DeviceRaster] = None):
    """(N,) True where all of a point's particles are finite and, with a
    viewshed, lie on visible cells (nearest-cell sample > 0)."""
    ok = torch.isfinite(particles).flatten(1).all(dim=1)
    if viewshed is not None:
        ok = ok & (viewshed.sample_nearest(particles[..., 0:2]) > 0).all(dim=-1)
    return ok


def _gather_rows(particles, weights, idx):
    """Particles (N, P, 6) and weights (N, P) at source indices idx (N, P),
    in one (N, P, 7) row gather."""
    pw = torch.cat([particles, weights[..., None]], dim=-1)
    pw = pw.gather(1, idx[..., None].expand(-1, -1, 7))
    return pw[..., :6].contiguous(), pw[..., 6].contiguous()


@functools.lru_cache(maxsize=8)
def _quantile_taps(n: int, K: int, device, dtype):
    """Two-tap linear interpolation of a K-entry quantile table of ``dtype``
    at quantiles (j + 1) / n: source index i0 (n,) and the weights of i0 and
    i0 + 1, computed in float64 and rounded to float32 as the reference
    builds its interpolation matrix, then to ``dtype`` as it casts the
    matrix to the table's type, and held in the type the sum accumulates in
    (float32, float64 for a float64 table). Cached on the device, so steps
    copy nothing from the host."""
    pos = np.clip((np.arange(n) + 1.0) / n * K - 0.5, 0.0, K - 1.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), K - 2)
    fr = pos - i0
    accumulate = torch.promote_types(dtype, torch.float32)
    return (torch.as_tensor(i0).to(device),) + tuple(
        torch.as_tensor(w.astype(np.float32)).to(device, dtype).to(accumulate) for w in (1.0 - fr, fr)
    )


@functools.lru_cache(maxsize=8)
def _template_quantile_index(n: int, K: int, device) -> torch.Tensor:
    """Sorted-value index of quantile (k + 0.5) / K, computed in float32 as
    the reference does; cached on the device."""
    q = (np.arange(K, dtype=np.float32) + np.float32(0.5)) * np.float32(n) / np.float32(K)
    return torch.as_tensor(np.clip(np.floor(q).astype(np.int64), 0, n - 1)).to(device)


@functools.lru_cache(maxsize=8)
def _inverse_two_sigma_squared(sigmas: Tuple[float, ...], device, dtype) -> torch.Tensor:
    """(O,) 1 / (2 sigma^2) of ``dtype``, each computed in float64 and
    rounded once, as the reference does; cached on the device."""
    return torch.tensor([1.0 / (2.0 * s ** 2) for s in sigmas], dtype=torch.float64).to(device, dtype)


def _prepare_search_tiles(tiles, table, highpass_size):
    """Normalize, match each tile's histogram to its quantile table (N, K),
    then median high-pass. Tiles (N, h, w).

    The value at sort position j becomes the table interpolated at quantile
    (j + 1) / n; a stable sort keeps ties in pixel order. The two taps of a
    16-bit table are summed in float32 and rounded once, as the reference's
    matmul by its interpolation matrix accumulates.
    """
    N, h, w = tiles.shape
    n = h * w
    K = table.shape[-1]
    with profiling.span("ops.histogram_match", tiles.device):
        t = imageproc.normalize(tiles, dim=(-2, -1), eps=1e-12)
        order = torch.sort(t.reshape(N, n), dim=-1, stable=True).indices
        i0, w0, w1 = _quantile_taps(n, K, table.device, table.dtype)
        matched_sorted = (table[:, i0].to(w0.dtype) * w0 + table[:, i0 + 1].to(w0.dtype) * w1).to(table.dtype)
        matched = torch.empty_like(matched_sorted).scatter_(1, order, matched_sorted)
    with profiling.span("ops.highpass", tiles.device):
        return routed_highpass(matched.reshape(N, h, w), highpass_size)


def _prepare_template_tiles(tiles, highpass_size, n_quantiles: int):
    """Normalize, record the quantile table (N, K), median high-pass.

    Returns (high-passed tiles, table) where table[k] is the normalized
    value at quantile (k + 0.5) / K.
    """
    N, h, w = tiles.shape
    t = imageproc.normalize(tiles, dim=(-2, -1), eps=1e-12)
    values = torch.sort(t.reshape(N, h * w), dim=-1).values
    return routed_highpass(t, highpass_size), values[:, _template_quantile_index(h * w, n_quantiles, tiles.device)]


def _sample_sse_surface(sse, rows_c, cols_c, cfg: BatchConfig):
    """SSE surfaces (B, oh, ow) at clamped indices (B, P): the cubic
    B-spline read as ``cfg.sse_sample_mode`` says (order 3), or bilinear
    interpolation of the surface (order 1)."""
    if cfg.interpolation_order == 1:
        with profiling.span("ops.spline_read", sse.device):
            return torch.vmap(sampling.bilinear_sample)(sse, rows_c, cols_c)
    with profiling.span("ops.prefilter", sse.device):
        coeffs = sampling.bspline_prefilter_2d(sse)
    with profiling.span("ops.spline_read", sse.device):
        return _read_spline(coeffs, rows_c, cols_c, cfg)


def _read_spline(coeffs, rows_c, cols_c, cfg: BatchConfig):
    """The cubic B-spline of coefficients (B, oh, ow) at clamped indices
    (B, P), read as ``cfg.sse_sample_mode`` says."""
    if cfg.sse_sample_mode == "einsum":
        return spline_kernel.bspline_sample(coeffs, rows_c, cols_c)
    if cfg.sse_upsample > 1:
        factor = cfg.sse_upsample
        fine = sampling.bspline_upsample(coeffs, factor)
        fr = (rows_c + 0.5) * factor - 0.5
        fc = (cols_c + 0.5) * factor - 0.5
        if cfg.sse_sample_mode == "bilinear":
            return torch.vmap(sampling.bilinear_sample)(fine, fr, fc)
        fh, fw = fine.shape[-2:]
        # torch.round rounds half to even, as the reference's jnp.round.
        ri = torch.round(fr).long().clamp(0, fh - 1)
        ci = torch.round(fc).long().clamp(0, fw - 1)
        return fine.reshape(fine.shape[0], fh * fw).gather(1, ri * fw + ci)
    return sampling.bspline_sample_padded(sampling.bspline_pad_coeffs(coeffs), rows_c, cols_c)


def observer_log_likelihoods(image, camera_vector, correction, sigma, particles, templates, template_table,
                             template_duv, weights, cfg: BatchConfig):
    """Per-particle negative log likelihood (N, P) from one observer's image
    (H, W): :func:`observer_log_likelihoods_multi` of one observer, with
    templates (N, th, tw), template_table (N, K) and template_duv (N, 2)."""
    return observer_log_likelihoods_multi(
        image[None], camera_vector[None], [correction], [sigma], particles, templates[None], template_table[None],
        template_duv[None], weights, cfg,
    )


def observer_log_likelihoods_multi(images, camera_vectors, corrections, sigmas, particles, templates,
                                   template_table, template_duv, weights, cfg: BatchConfig,
                                   obs_mask=None):
    """Sum over observers of the per-particle negative log likelihood (N, P).

    The front end (projection, search corners, tile extraction) is one call
    of ``kernels.project.project_extract`` for all observers, one launch on a
    card; the tile pipeline (histogram match, high-pass, SSE, spline) runs
    once on the (O*N) tiles it stacks observer-major. Particles whose
    SSE index falls outside the surface are clamped to it and pay a
    quadratic distance penalty. ``obs_mask`` (O,) multiplies each observer's
    term: 0 for an observer without an image this step.

    Shapes: images (O, H, W), camera_vectors (O, 20), corrections and
    sigmas of length O, templates (O, N, th, tw), template_table (O, N, K),
    template_duv (O, N, 2).
    """
    O = images.shape[0]
    N, P = particles.shape[0], particles.shape[1]
    th, tw = cfg.template_size
    sh, sw = cfg.search_size
    oh, ow = sh - th + 1, sw - tw + 1
    with profiling.span("ops.project_extract", particles.device):
        search, cols, rows = project_kernel.project_extract(
            images, camera_vectors, corrections, particles, weights, template_duv, cfg.template_size,
            cfg.search_size,
        )
    # The (O * N, P) planes are the step's largest temporaries: each is
    # dropped once used, so that few stand at once.
    search = _prepare_search_tiles(search, template_table.reshape(O * N, -1), cfg.highpass_size)
    with profiling.span("ops.sse", particles.device):
        sse = ncc.sse_map_batched(search, templates.reshape(O * N, th, tw)) * (1.0 / (th * tw))
    cols_c = torch.clamp(cols, 0.0, ow - 1.0)
    rows_c = torch.clamp(rows, 0.0, oh - 1.0)
    oob_d2 = (cols - cols_c) ** 2 + (rows - rows_c) ** 2
    del cols, rows
    sampled = _sample_sse_surface(sse, rows_c, cols_c, cfg)
    del rows_c, cols_c
    inv_2s2 = _inverse_two_sigma_squared(tuple(float(s) for s in sigmas), particles.device, cfg.dtype)
    ll = sampled.reshape(O, N, P) * inv_2s2[:, None, None] + oob_d2.reshape(O, N, P)
    if obs_mask is not None:
        ll = ll * obs_mask[:, None, None]
    return torch.sum(ll, dim=0)


def particle_moments(particles, weights):
    """Weighted mean and standard deviation over the particle axis: ((N, 6), (N, 6))."""
    w = weights / torch.sum(weights, dim=-1, keepdim=True)
    mean = torch.sum(particles * w[..., None], dim=-2)
    # (centered * centered) * w in place: the same products, one (N, P, 6)
    # temporary where three would stand at once beside the particles.
    squares = particles - mean[..., None, :]
    squares.mul_(squares).mul_(w[..., None])
    return mean, torch.sqrt(torch.sum(squares, dim=-2))


def particle_covariances(particles, weights):
    """Weighted (biased) covariance over the particle axis: (N, 6, 6)."""
    w = weights / torch.sum(weights, dim=-1, keepdim=True)
    mean = torch.sum(particles * w[..., None], dim=-2)
    centered = particles - mean[..., None, :]
    return torch.einsum("npi,npj,np->nij", centered, centered, w)


def to_tracks(datetimes, time_unit, outputs, covariances: bool = False):
    """Wrap :meth:`BatchTracker.track` outputs in the host :class:`Tracks` container.

    ``outputs`` are time-major tensors or arrays; the first datetime is the
    template frame, whose state is not emitted, so its row is NaN.

    A point whose ``outputs["valid"]`` flag drops to 0 (particles on
    non-visible viewshed cells, or non-finite) is contained the way the host
    tracker contains a failed particle test: its means and sigmas are NaN
    from the failing step on and ``Tracks.errors`` records a ``ValueError``
    for it; valid points get ``errors[n] = None``.
    """
    from .tracks import Tracks

    def padded(key):
        """(N, T, ...) float64 from time-major (T-1, N, ...), row 0 NaN. A
        16-bit tensor is widened exactly to float32 on its way to NumPy,
        which has no bfloat16."""
        x = outputs[key]
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            x = (x.float() if x.dtype in (torch.float16, torch.bfloat16) else x).numpy()
        else:
            x = np.asarray(x)
        x = np.moveaxis(x, 0, 1)
        return np.concatenate([np.full_like(x[:, :1], np.nan, dtype=float), x], axis=1)

    full_means = padded("mean")
    N = full_means.shape[0]
    if covariances and "covariance" in outputs:
        kwargs = {"covariances": padded("covariance")}
    else:
        kwargs = {"sigmas": padded("sigma")}
    if outputs.get("valid") is not None:
        valid = padded("valid")[:, 1:] > 0  # (N, T-1)
        errors = np.full(N, None, dtype=object)
        for n in np.flatnonzero(~valid.all(axis=1)):
            t_fail = int(np.argmin(valid[n]))  # first failing step
            errors[n] = ValueError(
                "Particle validity test failed at step"
                f" {t_fail + 1}: particles on non-visible viewshed cells"
                " or with missing (NaN) values"
            )
            # The failing step and everything after stay NaN.
            full_means[n, t_fail + 1:] = np.nan
            for value in kwargs.values():
                value[n, t_fail + 1:] = np.nan
        kwargs["errors"] = errors
    return Tracks(datetimes=np.asarray(datetimes), time_unit=time_unit, means=full_means, **kwargs)


def masks_from_frame_table(frame_table) -> np.ndarray:
    """Observation masks (T, O) float32 from a frame-index table (T, O) of
    image-index-or-None: 1 where the observer has an image. Row 0 is the
    template frame (``obs_mask0``); rows 1: are ``obs_masks``."""
    return np.not_equal(np.asarray(frame_table, dtype=object), None).astype(np.float32)


# ---- Captured steps ---- #

#: The fields of a :class:`BatchState` that a step reads and writes on the device.
STATE_FIELDS = ("particles", "weights", "valid", "templates", "template_table", "template_duv")
#: The draws a step may take injected.
STEP_NOISE_KEYS = ("a", "zwalk", "resample_u")


def _step_inputs(cfg: BatchConfig, images, dt, noise, camera_vectors, obs_mask) -> dict:
    """A step's inputs by name, each with the type :meth:`BatchTracker.step`
    casts it to: the frame, ``dt`` and the mask to the configuration's
    dtype, the cameras and the draws to float32. Absent inputs are left out."""
    given = {
        "images": (images, cfg.dtype), "dt": (dt, cfg.dtype),
        "camera_vectors": (camera_vectors, torch.float32), "obs_mask": (obs_mask, cfg.dtype),
        **{k: (noise.get(k), torch.float32) for k in STEP_NOISE_KEYS},
    }
    return {name: pair for name, pair in given.items() if pair[0] is not None}


class StepProgram:
    """One :meth:`BatchTracker.step` as a program over static buffers: the
    port's counterpart of the reference's compiled tracking programs
    (``_track_program``, ``_chunk_program``, the jitted stream step).

    It owns a buffer for each of the step's inputs (the frame (O, H, W),
    ``dt``, the cameras (O, 20) and the mask (O,) where given, each injected
    draw) and for the state the step reads and writes (particles, weights,
    ``valid``, templates, template table, ``template_duv``), and holds the
    state's generator. On a card it captures the eager ``step`` on those
    buffers into one ``torch.cuda.CUDAGraph``, on the thread's side stream
    and in its memory pool (:func:`graphs.capture_context`), with the generator
    registered so that a replay draws what an eager step would and leaves
    the generator where it would; the new state is copied back into the
    state's buffers at the end of the captured region (at 10,240 x 2,048
    the particles' copy moves about 1 GB; ping-ponging between two captures
    would need ``step`` to write into given tensors). A call copies the inputs into the buffers, replays,
    copies the outputs out of the graph's pool (the next replay overwrites
    it) and returns the state, whose tensors are the buffers. On the CPU,
    where there is no graph, the same object copies into its buffers and
    runs the eager step.

    Capture needs a step that reads nothing on the host: a step that does
    raises here with the reason, and nothing falls back to the eager loop.
    The graph takes the launches each kernel captured from the registry
    (``kernels._build.KERNELS``), and each replay adds them to the kernel
    wrappers' ``launches``. A call is the span ``entry.replay``
    and counts in ``entry.replays`` (:mod:`..profiling`; on the CPU the
    call runs the step's body).
    """

    def __init__(self, tracker: "BatchTracker", state: BatchState, inputs: dict) -> None:
        self.tracker = tracker
        self.device = tracker.device
        self.generator = state.generator
        self.state = dataclasses.replace(
            state, **{name: getattr(state, name).clone(memory_format=torch.contiguous_format) for name in STATE_FIELDS}
        )
        self.buffers = {
            name: _as_tensor(x, self.device, dtype).clone(memory_format=torch.contiguous_format)
            for name, (x, dtype) in inputs.items()
        }
        self.graph = None
        if self.device.type == "cuda":
            self.graph = graphs.Graph(self._body, self.device, "the tracking step", generators=(self.generator,))

    def _body(self) -> dict:
        """The eager step on the buffers, its new state copied back into them."""
        b = self.buffers
        kwargs = {name: b[name] for name in ("camera_vectors", "obs_mask") if name in b}
        noise = {k: b[k] for k in STEP_NOISE_KEYS if k in b}
        if noise:
            kwargs["noise"] = noise
        new_state, outputs = self.tracker.step(self.state, b["images"], b["dt"], **kwargs)
        for name in STATE_FIELDS:
            field, buffer = getattr(new_state, name), getattr(self.state, name)
            if field is not buffer:
                buffer.copy_(field)
        return outputs

    def __call__(self, state: BatchState, inputs: dict) -> Tuple[BatchState, dict]:
        """One step from ``state`` on ``inputs`` (as :func:`_step_inputs`
        gives them): (new state, the step's outputs)."""
        if state.generator is not self.generator:
            raise ValueError("this step program was captured with another generator")
        profiling.count("entry.replays")
        with profiling.span("entry.replay"), (
                torch.cuda.device(self.device) if self.graph is not None else contextlib.nullcontext()):
            for name in STATE_FIELDS:
                field, buffer = getattr(state, name), getattr(self.state, name)
                if field is not buffer:
                    buffer.copy_(field)
            for name, (x, dtype) in inputs.items():
                self.buffers[name].copy_(_as_tensor(x, self.device, dtype))
            outputs = self._body() if self.graph is None else self.graph.replay()
            outputs = {k: v.clone() for k, v in outputs.items()}
        return dataclasses.replace(self.state, step=state.step + 1), outputs


# ---- The tracker ---- #


def _entry_call(method):
    """A tracking call (:meth:`BatchTracker.track`, ``track_stream``): the
    span ``entry.call``, counted in ``entry.calls``, and in
    ``motion.informative_calls`` where the motion's DEM prior weighs the
    steps (:attr:`BatchMotion.informative`)."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        profiling.count("entry.calls")
        if self.motion.informative:
            profiling.count("motion.informative_calls")
        with profiling.span("entry.call"):
            return method(self, *args, **kwargs)

    return call


class BatchTracker:
    """Track N points x P particles through an image sequence on one device.

    Arguments:
        camera_vectors: (O, 20) camera vectors, one per observer.
        corrections: per observer, None or (radius, refraction).
        sigmas: per observer, the expected pixel noise.
        motion: :class:`BatchMotion`.
        config: :class:`BatchConfig`.
        device: where state, images and every step live.
        viewshed: optional host :class:`glimpse_tpu_torch.Raster` or
            :class:`DeviceRaster`; a point whose particles leave its
            visible cells (value > 0) is marked invalid from that step on.
            Every point must start inside it on a visible cell.
        mesh: optional :class:`glimpse_tpu_torch.parallel.mesh.Mesh`; with
            one, the tracker is a
            :class:`glimpse_tpu_torch.parallel.tracker.MeshTracker`.
    """

    def __new__(cls, *args, mesh=None, **kwargs):
        if mesh is not None and cls is BatchTracker:
            from ..parallel.tracker import MeshTracker

            cls = MeshTracker
        return super().__new__(cls)

    def __init__(self, camera_vectors, corrections, sigmas, motion: BatchMotion,
                 config: BatchConfig = None, device="cuda", viewshed=None, mesh=None) -> None:
        self.device = torch.device(device)
        self.camera_vectors = _as_tensor(camera_vectors, self.device)
        self.n_observers = self.camera_vectors.shape[0]
        self.corrections = list(corrections)
        self.sigmas = tuple(float(s) for s in sigmas)
        if not len(self.corrections) == len(self.sigmas) == self.n_observers:
            raise ValueError(
                f"{self.n_observers} camera vectors need as many corrections and sigmas,"
                f" got {len(self.corrections)} and {len(self.sigmas)}"
            )
        self.motion = motion.to(self.device)
        self.config = config or BatchConfig()
        self.viewshed = None
        if viewshed is not None:
            _check_start_visible(viewshed, motion.xy)
            if not isinstance(viewshed, DeviceRaster):
                viewshed = DeviceRaster.from_raster(viewshed, device=self.device)
            self.viewshed = viewshed.to(self.device)
        if mesh is not None:
            raise TypeError(f"{type(self).__name__} takes no mesh; build BatchTracker(..., mesh=mesh)")
        self.mesh = None
        # The step programs of the running track or track_stream call, by
        # static key (see _advance); None marks a key whose first step ran eagerly.
        self._programs: dict = {}

    @classmethod
    def from_observers(cls, observers, motion: BatchMotion, config: BatchConfig = None,
                       device="cuda", viewshed=None, mesh=None) -> "BatchTracker":
        """Build a device tracker from host :class:`Observer` sequences.

        Camera vectors, elevation corrections and pixel-noise sigmas come
        from each observer's first image; ``device``, ``viewshed`` and
        ``mesh`` go to the constructor. Frames are supplied separately (for example by
        :func:`glimpse_tpu_torch.track.feeder.stream_track`).
        """
        cams = [obs.images[0].cam for obs in observers]
        return cls(
            camera_vectors=np.stack([cam.to_array() for cam in cams]),
            corrections=[cam._correction_tuple for cam in cams],
            sigmas=[obs.sigma for obs in observers],
            motion=motion, config=config, device=device, viewshed=viewshed, mesh=mesh,
        )

    def _cameras(self, camera_vectors):
        return self.camera_vectors if camera_vectors is None else _as_tensor(camera_vectors, self.device)

    def _make_template(self, image, cam_vec, correction, xyz_mean):
        """Template tiles at each point's projected mean: (tiles (N, th, tw),
        quantile table (N, K), subpixel offsets (N, 2))."""
        cfg = self.config
        th, tw = cfg.template_size
        H, W = image.shape
        uv = projection.project(cam_vec, xyz_mean, correction=correction)
        corner_col = torch.round(uv[:, 0] - tw * 0.5).long().clamp(0, W - tw)
        corner_row = torch.round(uv[:, 1] - th * 0.5).long().clamp(0, H - th)
        corners = torch.stack([corner_row, corner_col], dim=-1)
        tiles = imageproc.extract_tiles(image, corners, (th, tw))
        hp, table = _prepare_template_tiles(tiles, cfg.highpass_size, cfg.n_quantiles)
        offset = torch.tensor([tw * 0.5, th * 0.5], dtype=cfg.dtype, device=image.device)
        # uv is float32 (the cameras' type) or wider, so the offsets are too,
        # as the reference's promote; the corner is rounded to the dtype first.
        duv = uv - (corners.flip(-1).to(cfg.dtype) + offset)
        return hp, table, duv

    def initialize(self, generator: torch.Generator, images0, noise=None, camera_vectors=None,
                   obs_mask0=None) -> BatchState:
        """Particles, uniform weights and templates from the first frame (O, H, W).

        The particles are drawn in float32, as the reference's, and their
        validity and mean are taken there; the state holds them in the
        configuration's dtype, and the frame is cast to it. The template
        offsets are in the type the cameras and that dtype promote to.
        ``camera_vectors`` (O, 20) overrides the constructor's cameras for
        this frame. ``obs_mask0`` (O,) marks the observers with an image
        here; the others start late, with zero templates, tables and
        offsets until ``step(init_template_for=...)`` makes theirs.
        """
        with profiling.span("entry.initialize"):
            cfg = self.config
            th, tw = cfg.template_size
            cams = self._cameras(camera_vectors)
            if isinstance(images0, torch.Tensor):
                images0 = images0.to(self.device, cfg.dtype)
            present = (True,) * self.n_observers if obs_mask0 is None else _host_flags(obs_mask0)
            particles = self.motion.initialize(generator, cfg.n_particles, noise=noise)
            N = particles.shape[0]
            xyz_mean = torch.mean(particles[..., 0:3], dim=1)
            templates, tables, duvs = [], [], []
            for o in range(self.n_observers):
                if present[o]:
                    hp, table, duv = self._make_template(images0[o], cams[o], self.corrections[o], xyz_mean)
                else:
                    hp = torch.zeros((N, th, tw), dtype=cfg.dtype, device=self.device)
                    table = torch.zeros((N, cfg.n_quantiles), dtype=cfg.dtype, device=self.device)
                    duv = torch.zeros((N, 2), dtype=cfg.dtype, device=self.device)
                templates.append(hp)
                tables.append(table)
                duvs.append(duv)
            return BatchState(
                particles=particles.to(cfg.dtype),
                weights=torch.ones((N, cfg.n_particles), dtype=cfg.dtype, device=self.device),
                generator=generator,
                templates=torch.stack(templates),
                template_table=torch.stack(tables),
                template_duv=torch.stack(duvs),
                step=0,
                valid=_particle_validity(particles, self.viewshed).to(cfg.dtype),
            )

    def step(self, state: BatchState, images, dt, noise=None, camera_vectors=None, obs_mask=None,
             init_template_for: Sequence[int] = ()) -> Tuple[BatchState, dict]:
        """One update: evolve, weight by the observers, record moments, resample.

        Arguments:
            images: (O, H, W), one frame per observer (masked ones may hold
                anything finite).
            dt: the time step in motion time units.
            noise: may inject "a" (N, P, 3), "zwalk" (N, P) and
                "resample_u": (N,) comb offsets for the systematic method,
                (N, P) uniforms for the others.
            camera_vectors: (O, 20) cameras for this frame.
            obs_mask: (O,) 1 for an observer with an image this step, 0
                without; with no informative term, the weights carry over.
            init_template_for: observers whose template is cut from this
                frame, at the weighted mean of the evolved particles, before
                they weigh this step.

        Images and ``dt`` tensors are cast to the configuration's dtype; the
        injected draws stay float32. Returns (new state, {"mean", "sigma",
        "valid"} and, with ``return_covariances``, "covariance"), in the
        configuration's dtype.

        The step is the span ``step``, and its stages the spans
        ``step.evolve``, ``step.validity``, ``step.template``,
        ``step.prior`` (the motion's DEM prior, only where
        :attr:`BatchMotion.informative`), ``step.weights``,
        ``step.resample`` and the ops' (``ops.*``), each timed on the card
        (:mod:`..profiling`).
        """
        with profiling.span("step", self.device):
            return self._step(state, images, dt, noise, camera_vectors, obs_mask, init_template_for)

    def _step(self, state, images, dt, noise, camera_vectors, obs_mask, init_template_for):
        """:meth:`step`'s work, inside its span."""
        cfg = self.config
        noise = noise or {}
        generator = state.generator
        cams = self._cameras(camera_vectors)
        if isinstance(images, torch.Tensor):
            images = images.to(self.device, cfg.dtype)
        if isinstance(dt, torch.Tensor):
            dt = dt.to(self.device, cfg.dtype)
        # The motion's parameters and draws are float32: cast back to the
        # state's dtype, as the reference does.
        with profiling.span("step.evolve", self.device):
            particles = self.motion.evolve(generator, state.particles, dt, noise=noise).to(cfg.dtype)
        with profiling.span("step.validity", self.device):
            valid = state.valid * _particle_validity(particles, self.viewshed).to(cfg.dtype)
        templates, template_table, template_duv = state.templates, state.template_table, state.template_duv
        if init_template_for:
            with profiling.span("step.template", self.device):
                w_norm = state.weights / torch.sum(state.weights, dim=-1, keepdim=True)
                xyz_mean = torch.sum(particles[..., 0:3] * w_norm[..., None], dim=1)
                templates, template_table, template_duv = (
                    x.clone() for x in (templates, template_table, template_duv)
                )
                for o in init_template_for:
                    templates[o], template_table[o], template_duv[o] = self._make_template(
                        images[o], cams[o], self.corrections[o], xyz_mean
                    )
        if obs_mask is not None:
            obs_mask = _as_tensor(obs_mask, self.device, cfg.dtype)
        # Only a prior that can be nonzero is a span: without one the step's graph keeps its nodes.
        with profiling.span("step.prior", self.device) if self.motion.informative else contextlib.nullcontext():
            ll = self.motion.log_likelihoods(particles).to(cfg.dtype)
        # Rebinding ll frees the prior's (N, P) plane once it is added.
        ll = ll + observer_log_likelihoods_multi(
            images, cams, self.corrections, self.sigmas, particles, templates, template_table,
            template_duv, state.weights, cfg, obs_mask=obs_mask,
        )
        with profiling.span("step.weights", self.device):
            # A per-point shift keeps exp() in range whatever the absolute scale.
            ll = ll - torch.min(ll, dim=-1, keepdim=True).values
            # ll is float32 or wider (the spline read widens); the weights take
            # the state's dtype. In float16 the 1e-30 floor underflows to 0, as
            # the reference's does.
            if cfg.resample_threshold is None:
                weights = (torch.exp(-ll) + 1e-30).to(cfg.dtype)
            else:
                weights = state.weights * torch.exp(-ll).to(cfg.dtype) + 1e-30
                weights = weights / torch.mean(weights, dim=-1, keepdim=True)
            if obs_mask is not None and not self.motion.informative:
                # No observer and no motion prior informed this step: carry the
                # weights (a select, so the host does not wait for the mask).
                weights = torch.where(torch.sum(obs_mask) > 0, weights, state.weights)
            # Moments come from the fresh weights, before resampling.
            mean, sigma = particle_moments(particles, weights)
            outputs = {"mean": mean, "sigma": sigma, "valid": valid}
            if cfg.return_covariances:
                outputs["covariance"] = particle_covariances(particles, weights)
        with profiling.span("step.resample", self.device):
            new_particles, new_weights = self._resample(generator, particles, weights, noise.get("resample_u"))
            if cfg.resample_threshold is None:
                # The resampled weights are the gathered likelihood weights:
                # they center the next step's search boxes.
                particles, weights = new_particles, new_weights
            else:
                # Only points whose effective sample size degraded take the
                # resampled rows, with uniform weights.
                ess = torch.sum(weights, dim=-1) ** 2 / torch.sum(weights * weights, dim=-1)
                degraded = ess < cfg.resample_threshold * particles.shape[1]
                particles = torch.where(degraded[:, None, None], new_particles, particles)
                weights = torch.where(degraded[:, None], torch.ones_like(weights), weights)
        new_state = dataclasses.replace(
            state, particles=particles, weights=weights, templates=templates,
            template_table=template_table, template_duv=template_duv, step=state.step + 1, valid=valid,
        )
        return new_state, outputs

    def _resample(self, generator, particles, weights, u=None):
        """Resampled (particles, weights) of every point by the configured method."""
        method = self.config.resample_method
        if method == "systematic":
            if u is None:
                u = torch.rand(particles.shape[0], generator=generator, device=particles.device)
            t = resampling.systematic_thresholds(weights, _as_tensor(u, particles.device))
            return systematic_resample(t, particles, weights)
        if u is not None:
            u = _as_tensor(u, particles.device)
        idx = resampling.METHODS[method](weights, u=u, generator=generator)
        return _gather_rows(particles, weights, idx)

    def _template_plan(self, obs_masks, obs_mask0):
        """The late-template plan, from the host's masks.

        Returns (mask0, {step: observers}): ``mask0`` the O flags of the
        template frame, or None; each late observer's template is cut at
        its first unmasked step (1-based, aligned with ``images[1:]``). An
        observer that never fires keeps its zero template.
        """
        if obs_mask0 is None:
            return None, {}
        mask0 = _host_flags(obs_mask0)
        if all(mask0):
            return mask0, {}
        if obs_masks is None:
            raise ValueError("obs_mask0 marks late-starting observers but obs_masks was not provided")
        if isinstance(obs_masks, torch.Tensor):
            obs_masks = obs_masks.cpu().numpy()
        masks = np.asarray(obs_masks) > 0
        plan: dict = {}
        for o, present in enumerate(mask0):
            fires = np.flatnonzero(masks[:, o])
            if not present and fires.size:
                plan.setdefault(int(fires[0]) + 1, []).append(o)
        return mask0, {b: tuple(obs) for b, obs in plan.items()}

    def _advance(self, state, images, dt, **kwargs):
        """One step of :meth:`track` and :meth:`track_stream`: (new state,
        the step's outputs as the tracker holds them until :meth:`_join` or
        :meth:`_collect` gathers them). ``images`` and ``dt`` are tensors;
        ``kwargs`` are :meth:`step`'s.

        The step runs through the :class:`StepProgram` of its static key, as
        the reference's ``cache_key`` picks a compiled program: which draws
        are injected, whether ``obs_mask`` and per-frame ``camera_vectors``
        are given, the state's generator and the frame's shape. A key's
        first step runs eagerly and warms up (the kernels' build, library
        handles, allocator pools); its second builds the program, which runs
        every later step. A step with ``init_template_for`` runs eagerly, as
        the reference runs it between scan segments.
        """
        if kwargs.get("init_template_for"):
            return self._eager_step(state, images, dt, **kwargs)
        inputs = _step_inputs(self.config, images, dt, kwargs.get("noise") or {}, kwargs.get("camera_vectors"),
                              kwargs.get("obs_mask"))
        key = (
            tuple(k for k in STEP_NOISE_KEYS if k in inputs), "obs_mask" in inputs, "camera_vectors" in inputs,
            id(state.generator), tuple(images.shape),
        )
        if key not in self._programs:
            self._programs[key] = None
            return self._eager_step(state, images, dt, **kwargs)
        if self._programs[key] is None:
            self._programs[key] = StepProgram(self, state, inputs)
        return self._programs[key](state, inputs)

    def _eager_step(self, state, images, dt, **kwargs):
        """:meth:`step` run eagerly by :meth:`_advance`: the span
        ``entry.eager_step``, counted in ``entry.eager_steps``."""
        profiling.count("entry.eager_steps")
        with profiling.span("entry.eager_step"):
            return self.step(state, images, dt, **kwargs)

    def _release(self) -> None:
        """Drop the step programs at the end of a :meth:`track` or
        :meth:`track_stream` call: a new call comes with its own generator,
        and so with programs of its own. The state the call returned keeps
        the programs' buffers as its tensors; their graphs' memory goes back
        to the thread's capture pool (:func:`graphs.capture_context`).
        While :func:`profiling.enabled`, each graph's device spans go to
        the registry first, as one sample of its last replay, without
        waiting for the card."""
        with profiling.span("entry.release"):
            if profiling.enabled():
                profiling.read_device_spans(
                    (p.graph for p in self._programs.values() if p is not None and p.graph is not None), wait=False
                )
            self._programs = {}

    def _join(self, out) -> dict:
        """One step's outputs from :meth:`_advance` as a dict on ``device``."""
        return out

    def _collect(self, outs: list) -> dict:
        """Steps' outputs from :meth:`_advance`, stacked on a leading time axis."""
        with profiling.span("entry.collect"):
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _empty_outputs(self, n_points: int) -> dict:
        """Outputs with a leading time axis of 0."""
        shapes = {"mean": (0, n_points, 6), "sigma": (0, n_points, 6), "valid": (0, n_points)}
        if self.config.return_covariances:
            shapes["covariance"] = (0, n_points, 6, 6)
        return {k: torch.zeros(s, dtype=self.config.dtype, device=self.device) for k, s in shapes.items()}

    @_entry_call
    def track(self, generator: torch.Generator, images, dts, noise=None, obs_masks=None,
              obs_mask0=None) -> Tuple[BatchState, dict]:
        """Track through a sequence held in device memory.

        Arguments:
            generator: source of every random draw not injected.
            images: (T, O, H, W); frame 0 makes the templates.
            dts: (T-1,) time steps in motion time units.
            noise: injected draws {"init": {"xy", "z", "v"}, "a": (T-1, N, P, 3),
                "zwalk": (T-1, N, P), "resample_u": (T-1, N) or (T-1, N, P)},
                each optional.
            obs_masks: (T-1, O) flags, 0 for an observer without an image at
                that step (see :func:`masks_from_frame_table`).
            obs_mask0: (O,) flags of the template frame; an observer without
                an image there starts late, its template cut at its first
                unmasked step.

        Returns (final state, outputs) with outputs "mean" and "sigma"
        (T-1, N, 6), "valid" (T-1, N) and, with ``return_covariances``,
        "covariance" (T-1, N, 6, 6).

        On a card the first step runs eagerly, each later one as a replay of
        one CUDA graph captured from :meth:`step` (:meth:`_advance`); steps
        that cut a late observer's template run eagerly. Results equal a loop
        of :meth:`step` from the same generator bit for bit.
        """
        mask0, plan = self._template_plan(obs_masks, obs_mask0)
        dtype = self.config.dtype
        images = _as_tensor(images, self.device, dtype)
        dts = _as_tensor(dts, self.device, dtype)
        masks = None if obs_masks is None else _as_tensor(obs_masks, self.device, dtype)
        noise = noise or {}
        step_noise = {
            k: _as_tensor(noise[k], self.device) for k in ("a", "zwalk", "resample_u") if k in noise
        }
        state = self.initialize(generator, images[0], noise=noise.get("init"), obs_mask0=mask0)
        outs = []
        try:
            for i in range(dts.shape[0]):
                state, out = self._advance(
                    state, images[1 + i], dts[i], noise={k: x[i] for k, x in step_noise.items()},
                    obs_mask=None if masks is None else masks[i], init_template_for=plan.get(i + 1, ()),
                )
                outs.append(out)
        finally:
            self._release()
        if not outs:
            return state, self._empty_outputs(self.motion.n_points)
        return state, self._collect(outs)

    def _upload(self, frames) -> torch.Tensor:
        """Host frames, stacked, in one copy to the device (pinned and
        asynchronous on a card), cast there to the configuration's dtype:
        they cross as float32 (float64 for a float64 tracker), so nothing is
        rounded on the host."""
        dtype = self.config.dtype
        host_type = np.float64 if dtype == torch.float64 else np.float32
        with profiling.span("feeder.upload"):
            host = torch.from_numpy(np.stack([np.asarray(f, dtype=host_type) for f in frames]))
            profiling.count("feeder.uploads")
            profiling.count("feeder.bytes", host.nbytes)
            if self.device.type == "cuda":
                host = host.pin_memory()
            return host.to(self.device, non_blocking=True).to(dtype)

    @_entry_call
    def track_stream(self, generator: torch.Generator, first_frame, frame_iter, dts,
                     camera_vectors_seq=None, obs_masks=None, obs_mask0=None,
                     chunk: int = 1) -> Tuple[BatchState, list]:
        """Track a sequence streamed from the host, frame by frame or chunk by chunk.

        ``first_frame`` (O, H, W) makes the templates; ``frame_iter`` yields
        the next frames (O, H, W) as host arrays, read as the steps need
        them, so a sequence need not fit the device. ``camera_vectors_seq``
        (T, O, 20) gives per-frame cameras (index 0 the template frame);
        ``obs_masks`` (T-1, O) and ``obs_mask0`` (O,) are as in
        :meth:`track`.

        Each step runs as in :meth:`track`: on a card, after the first, as
        one replay of a captured CUDA graph, whatever ``chunk`` is. With
        ``chunk`` 1 the returned list holds one output dict per step. With
        ``chunk`` > 1 the frames go to the device ``chunk`` at a time, each
        chunk in one pinned, asynchronous copy, each of its frames copied
        from there into the graph's frame buffer, and each entry covers a
        chunk with a leading time axis, gathered once a chunk: ``chunk``
        buys fewer host-to-device copies and output entries, no longer fewer
        launches. A chunk that holds a late observer's template step gives
        one entry a step, each with a leading axis of 1.
        """
        mask0, plan = self._template_plan(obs_masks, obs_mask0)
        dtype = self.config.dtype
        dts = _as_tensor(dts, self.device, dtype)
        n_steps = dts.shape[0]
        cams = None if camera_vectors_seq is None else _as_tensor(camera_vectors_seq, self.device)
        masks = None if obs_masks is None else _as_tensor(obs_masks, self.device, dtype)
        state = self.initialize(
            generator, self._upload([first_frame])[0],
            camera_vectors=None if cams is None else cams[0], obs_mask0=mask0,
        )

        def one(state, t, frame):
            return self._advance(
                state, frame, dts[t - 1], camera_vectors=None if cams is None else cams[t],
                obs_mask=None if masks is None else masks[t - 1], init_template_for=plan.get(t, ()),
            )

        outputs = []
        it = iter(frame_iter)
        try:
            if chunk <= 1:
                for t, frame in enumerate(it, start=1):
                    if t > n_steps:
                        break
                    state, out = one(state, t, self._upload([frame])[0])
                    outputs.append(self._join(out))
                return state, outputs
            t = 1
            while t <= n_steps:
                t_end = min(t + chunk - 1, n_steps)
                frames = self._upload([next(it) for _ in range(t_end - t + 1)])
                outs = []
                for k in range(len(frames)):
                    state, out = one(state, t + k, frames[k])
                    outs.append(out)
                if any(b in plan for b in range(t, t_end + 1)):
                    outputs.extend(self._collect([out]) for out in outs)
                else:
                    outputs.append(self._collect(outs))
                t = t_end + 1
        finally:
            self._release()
        return state, outputs
