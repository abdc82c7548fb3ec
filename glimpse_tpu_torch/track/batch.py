"""Batched particle-filter tracker on tensors: N points x P particles per step.

The counterpart of :mod:`glimpse_tpu.track.batch` for one observer,
cartesian motion and systematic resampling every step. One step:

1. evolve the particles and latch each point's validity (all finite);
2. project the particles through the camera and cut a search tile at each
   point's weighted-mean projection;
3. normalize the tile, match its histogram to the template's quantile table
   and take the median high-pass (kernel ``median_highpass``);
4. SSE map against the template, then the cubic B-spline of the SSE
   surface at every particle gives its negative log likelihood;
5. weights, moments, then systematic resampling (kernel
   ``systematic_resample``).

The time loop is a Python loop. Randomness comes from an explicit
``torch.Generator``; ``noise=`` takes injected draws with the reference's
keys and shapes, so both packages can run in lockstep.
"""
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.highpass import median_highpass
from ..kernels.resample import systematic_resample
from ..ops import imageproc, ncc, projection, resampling, sampling


def _as_tensor(x, device) -> torch.Tensor:
    """A float32 tensor on ``device``; arrays are copied (JAX hands over
    read-only ones)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


# ---- Device raster (DEM) ---- #


@dataclasses.dataclass
class DeviceRaster:
    """A raster on the device: values (H, W) and an affine grid (0-d tensors)."""

    array: torch.Tensor
    x0: torch.Tensor  # world x of the left outer edge
    y0: torch.Tensor  # world y of the top outer edge
    dx: torch.Tensor  # signed cell size in x
    dy: torch.Tensor  # signed cell size in y

    def sample(self, xy):
        """Bilinear sample at world points (..., 2)."""
        cols = (xy[..., 0] - self.x0) / self.dx - 0.5
        rows = (xy[..., 1] - self.y0) / self.dy - 0.5
        if self.array.shape == (1, 1):
            return self.array[0, 0].expand(rows.shape)
        return sampling.bilinear_sample(self.array, rows, cols)

    def sample_nearest(self, xy):
        """Nearest-cell sample at world points (..., 2); outside cells clamp to the edge."""
        H, W = self.array.shape
        cols = torch.floor((xy[..., 0] - self.x0) / self.dx).long().clamp(0, W - 1)
        rows = torch.floor((xy[..., 1] - self.y0) / self.dy).long().clamp(0, H - 1)
        if self.array.shape == (1, 1):
            return self.array[0, 0].expand(rows.shape)
        return self.array[rows, cols]

    @classmethod
    def constant(cls, value: float, device="cpu") -> "DeviceRaster":
        """An infinite-extent constant raster."""
        return cls(
            array=torch.full((1, 1), float(value), device=device),
            x0=torch.tensor(0.0, device=device), y0=torch.tensor(0.0, device=device),
            dx=torch.tensor(1e30, device=device), dy=torch.tensor(1e30, device=device),
        )

    def to(self, device) -> "DeviceRaster":
        return DeviceRaster(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


# ---- Motion model ---- #


@dataclasses.dataclass
class BatchMotion:
    """Per-point cartesian motion parameters for N points.

    The reference's other kinds ('cylindrical', 'tangent',
    'tangent_cylindrical') are not ported yet (ROADMAP.md, queue A).
    """

    kind: str
    xy: torch.Tensor  # (N, 2) initial position means
    xy_sigma: torch.Tensor  # (N, 2)
    v_mean: torch.Tensor  # (N, 3)
    v_sigma: torch.Tensor  # (N, 3)
    a_mean: torch.Tensor  # (N, 3)
    a_sigma: torch.Tensor  # (N, 3)
    slope_sigma: torch.Tensor  # (N,) used by the tangent kinds only
    dem: DeviceRaster
    dem_sigma: DeviceRaster
    use_dem_sigma: bool = True

    def __post_init__(self) -> None:
        if self.kind != "cartesian":
            raise NotImplementedError(
                f"motion kind {self.kind!r} is not ported yet; glimpse_tpu_torch"
                " runs kind='cartesian' (see ROADMAP.md, queue A)"
            )

    @property
    def n_points(self) -> int:
        return self.xy.shape[0]

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

        def normal(key, shape):
            if noise.get(key) is not None:
                return _as_tensor(noise[key], device)
            return torch.randn(shape, generator=generator, device=device)

        xy = self.xy[:, None, :] + self.xy_sigma[:, None, :] * normal("xy", (N, P, 2))
        z = self.dem.sample(xy)
        if self.use_dem_sigma:
            z = z + self.dem_sigma.sample(xy) * normal("z", (N, P))
        v = self.v_mean[:, None, :] + self.v_sigma[:, None, :] * normal("v", (N, P, 3))
        return torch.cat([xy, z[..., None], v], dim=-1)

    def evolve(self, generator, particles, dt, noise=None):
        """One motion step (N, P, 6) -> (N, P, 6); ``noise`` may inject "a" (N, P, 3)."""
        noise = noise or {}
        a_noise = noise.get("a")
        if a_noise is None:
            a_noise = torch.randn(
                particles.shape[:2] + (3,), generator=generator, device=particles.device
            )
        a = self.a_mean[:, None, :] + self.a_sigma[:, None, :] * _as_tensor(a_noise, particles.device)
        dxyz = dt * particles[..., 3:6] + 0.5 * a * dt ** 2
        pos = particles[..., 0:3] + dxyz
        v = particles[..., 3:6] + dt * a
        return torch.cat([pos, v], dim=-1)

    def log_likelihoods(self, particles):
        """DEM-distance prior (N, P), or zeros without a DEM sigma."""
        if not self.use_dem_sigma:
            return torch.zeros(particles.shape[:2], dtype=particles.dtype, device=particles.device)
        xy = particles[..., 0:2]
        z = self.dem.sample(xy)
        z_sigma = self.dem_sigma.sample(xy)
        safe = torch.where(z_sigma > 0, z_sigma, 1.0)
        ll = (z - particles[..., 2]) ** 2 / (2 * safe * safe)
        return torch.where(z_sigma > 0, ll, 0.0)


# ---- Configuration and state ---- #


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """The settings of the batched tracker that change its results.

    ``interpolation_order``, ``resample_method`` and ``resample_threshold``
    take only the values of the ported path; ``dtype`` only float32, the
    kernels' type.
    """

    n_particles: int = 500
    template_size: Tuple[int, int] = (15, 15)  # (height, width)
    search_size: Tuple[int, int] = (31, 31)  # (height, width)
    highpass_size: Tuple[int, int] = (5, 5)
    n_quantiles: int = 256
    interpolation_order: int = 3
    resample_method: str = "systematic"
    resample_threshold: Optional[float] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        ported = {
            "interpolation_order": 3, "resample_method": "systematic",
            "resample_threshold": None, "dtype": torch.float32,
        }
        for name, value in ported.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet; only"
                    f" {value!r} (see ROADMAP.md, queue A)"
                )
        kh, kw = self.highpass_size
        if kh % 2 == 0 or kw % 2 == 0 or kh * kw > 49:
            raise ValueError(f"highpass_size takes odd taps, at most 49, got {self.highpass_size}")
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
    valid: torch.Tensor  # (N,) 1.0 while every particle of the point is finite


# ---- Observation ---- #


def _particle_validity(particles):
    """(N,) True where all of a point's particles are finite."""
    return torch.isfinite(particles).flatten(1).all(dim=1)


def _extract_tiles(image, corners, size: Tuple[int, int]):
    """Tiles (N, th, tw) of an image (H, W) at integer upper-left corners (N, 2)."""
    th, tw = size
    rows = corners[:, 0, None] + torch.arange(th, device=image.device)
    cols = corners[:, 1, None] + torch.arange(tw, device=image.device)
    return image[rows[:, :, None], cols[:, None, :]]


@functools.lru_cache(maxsize=8)
def _quantile_taps(n: int, K: int, device):
    """Two-tap linear interpolation of a K-entry quantile table at quantiles
    (j + 1) / n: source index i0 (n,) and the float32 weights of i0 and
    i0 + 1, computed in float64 as the reference builds its interpolation
    matrix. Cached on the device, so steps copy nothing from the host."""
    pos = np.clip((np.arange(n) + 1.0) / n * K - 0.5, 0.0, K - 1.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), K - 2)
    fr = pos - i0
    return tuple(
        torch.as_tensor(x).to(device) for x in (i0, (1.0 - fr).astype(np.float32), fr.astype(np.float32))
    )


def _template_quantile_index(n: int, K: int) -> np.ndarray:
    """Sorted-value index of quantile (k + 0.5) / K, computed in float32 as
    the reference does."""
    q = (np.arange(K, dtype=np.float32) + np.float32(0.5)) * np.float32(n) / np.float32(K)
    return np.clip(np.floor(q).astype(np.int64), 0, n - 1)


def _prepare_search_tiles(tiles, table, highpass_size):
    """Normalize, match each tile's histogram to its quantile table (N, K),
    then median high-pass. Tiles (N, h, w).

    The value at sort position j becomes the table interpolated at quantile
    (j + 1) / n; a stable sort keeps ties in pixel order.
    """
    N, h, w = tiles.shape
    n = h * w
    K = table.shape[-1]
    t = imageproc.normalize(tiles, dim=(-2, -1), eps=1e-12)
    order = torch.sort(t.reshape(N, n), dim=-1, stable=True).indices
    i0, w0, w1 = _quantile_taps(n, K, table.device)
    matched_sorted = table[:, i0] * w0 + table[:, i0 + 1] * w1
    matched = torch.empty_like(matched_sorted).scatter_(1, order, matched_sorted)
    return median_highpass(matched.reshape(N, h, w), highpass_size)


def _prepare_template_tiles(tiles, highpass_size, n_quantiles: int):
    """Normalize, record the quantile table (N, K), median high-pass.

    Returns (high-passed tiles, table) where table[k] is the normalized
    value at quantile (k + 0.5) / K.
    """
    N, h, w = tiles.shape
    n = h * w
    t = imageproc.normalize(tiles, dim=(-2, -1), eps=1e-12)
    values = torch.sort(t.reshape(N, n), dim=-1).values
    idx = torch.as_tensor(_template_quantile_index(n, n_quantiles), device=tiles.device)
    return median_highpass(t, highpass_size), values[:, idx]


def _project_and_extract(image, camera_vector, correction, particles, template_duv, w_norm,
                         cfg: BatchConfig):
    """Project the particles, cut each point's search tile around its
    weighted-mean projection.

    Returns (search tiles (N, sh, sw), fractional SSE-surface indices cols
    and rows (N, P)). A particle behind the camera projects far outside
    (-1e6) before the box corners are clamped into the image.
    """
    th, tw = cfg.template_size
    sh, sw = cfg.search_size
    H, W = image.shape
    u, v = projection.project_planes(
        camera_vector, particles[..., 0], particles[..., 1], particles[..., 2],
        correction=correction,
    )
    u = torch.nan_to_num(u, nan=-1e6)
    v = torch.nan_to_num(v, nan=-1e6)
    u_mean = torch.sum(u * w_norm, dim=1)
    v_mean = torch.sum(v * w_norm, dim=1)
    # torch.round rounds half to even, as the reference's jnp.round.
    corner_col = torch.round(u_mean - sw * 0.5).long().clamp(0, W - sw)
    corner_row = torch.round(v_mean - sh * 0.5).long().clamp(0, H - sh)
    search = _extract_tiles(image, torch.stack([corner_row, corner_col], dim=-1), (sh, sw))
    # SSE surface origin in image coordinates (cell centers at +0.5).
    sse_left = corner_col.to(cfg.dtype) + (tw * 0.5 - 0.5) + template_duv[:, 0]
    sse_top = corner_row.to(cfg.dtype) + (th * 0.5 - 0.5) + template_duv[:, 1]
    cols = u - sse_left[:, None] - 0.5
    rows = v - sse_top[:, None] - 0.5
    return search, cols, rows


def _sample_sse_surface(sse, rows_c, cols_c):
    """Exact cubic B-spline of the SSE surfaces (B, oh, ow) at clamped indices (B, P)."""
    return sampling.bspline_sample(sampling.bspline_prefilter_2d(sse), rows_c, cols_c)


def observer_log_likelihoods(image, camera_vector, correction, sigma, particles, templates,
                             template_table, template_duv, weights, cfg: BatchConfig):
    """Per-particle negative log likelihood (N, P) from one observer's image.

    Particles whose SSE index falls outside the surface are clamped to it
    and pay a quadratic distance penalty.
    """
    th, tw = cfg.template_size
    sh, sw = cfg.search_size
    oh, ow = sh - th + 1, sw - tw + 1
    w_norm = weights / torch.sum(weights, dim=-1, keepdim=True)
    search, cols, rows = _project_and_extract(
        image, camera_vector, correction, particles, template_duv, w_norm, cfg
    )
    search = _prepare_search_tiles(search, template_table, cfg.highpass_size)
    sse = ncc.sse_map_batched(search, templates) * (1.0 / (th * tw))
    cols_c = torch.clamp(cols, 0.0, ow - 1.0)
    rows_c = torch.clamp(rows, 0.0, oh - 1.0)
    oob_d2 = (cols - cols_c) ** 2 + (rows - rows_c) ** 2
    sampled = _sample_sse_surface(sse, rows_c, cols_c)
    return sampled * (1.0 / (2.0 * sigma ** 2)) + oob_d2


def particle_moments(particles, weights):
    """Weighted mean and standard deviation over the particle axis: ((N, 6), (N, 6))."""
    w = weights / torch.sum(weights, dim=-1, keepdim=True)
    mean = torch.sum(particles * w[..., None], dim=-2)
    centered = particles - mean[..., None, :]
    var = torch.sum(centered * centered * w[..., None], dim=-2)
    return mean, torch.sqrt(var)


# ---- The tracker ---- #


class BatchTracker:
    """Track N points x P particles through an image sequence on one device.

    Arguments:
        camera_vectors: (1, 20) camera vector of the one observer.
        corrections: [None] or [(radius, refraction)].
        sigmas: [expected pixel noise].
        motion: :class:`BatchMotion`.
        config: :class:`BatchConfig`.
        device: where state, images and every step live.
    """

    def __init__(self, camera_vectors, corrections, sigmas, motion: BatchMotion,
                 config: BatchConfig = None, device="cpu") -> None:
        self.device = torch.device(device)
        self.camera_vectors = _as_tensor(camera_vectors, self.device)
        if self.camera_vectors.shape[0] != 1:
            raise NotImplementedError(
                "glimpse_tpu_torch tracks with one observer; more are not"
                " ported yet (see ROADMAP.md, queue A)"
            )
        self.corrections = list(corrections)
        self.sigmas = tuple(float(s) for s in sigmas)
        self.motion = motion.to(self.device)
        self.config = config or BatchConfig()

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
        tiles = _extract_tiles(image, corners, (th, tw))
        hp, table = _prepare_template_tiles(tiles, cfg.highpass_size, cfg.n_quantiles)
        offset = torch.tensor([tw * 0.5, th * 0.5], dtype=cfg.dtype, device=image.device)
        duv = uv - (corners.flip(-1).to(cfg.dtype) + offset)
        return hp, table, duv

    def initialize(self, generator: torch.Generator, images0, noise=None) -> BatchState:
        """Particles, uniform weights and templates from the first frame (O, H, W)."""
        cfg = self.config
        particles = self.motion.initialize(generator, cfg.n_particles, noise=noise)
        N = particles.shape[0]
        hp, table, duv = self._make_template(
            images0[0], self.camera_vectors[0], self.corrections[0],
            torch.mean(particles[..., 0:3], dim=1),
        )
        return BatchState(
            particles=particles,
            weights=torch.ones((N, cfg.n_particles), dtype=cfg.dtype, device=self.device),
            generator=generator,
            templates=hp[None],
            template_table=table[None],
            template_duv=duv[None],
            step=0,
            valid=_particle_validity(particles).to(cfg.dtype),
        )

    def step(self, state: BatchState, images, dt, noise=None) -> Tuple[BatchState, dict]:
        """One update: evolve, weight by the observer, record moments, resample.

        ``images`` (O, H, W); ``dt`` the time step in motion time units;
        ``noise`` may inject "a" (N, P, 3) and "resample_u" (N,). Returns
        (new state, {"mean", "sigma", "valid"}).
        """
        cfg = self.config
        noise = noise or {}
        generator = state.generator
        particles = self.motion.evolve(generator, state.particles, dt, noise=noise)
        valid = state.valid * _particle_validity(particles).to(cfg.dtype)
        ll = self.motion.log_likelihoods(particles) + observer_log_likelihoods(
            images[0], self.camera_vectors[0], self.corrections[0], self.sigmas[0],
            particles, state.templates[0], state.template_table[0],
            state.template_duv[0], state.weights, cfg,
        )
        # A per-point shift keeps exp() in range whatever the absolute scale.
        ll = ll - torch.min(ll, dim=-1, keepdim=True).values
        weights = torch.exp(-ll) + 1e-30
        # Moments come from the fresh likelihood weights, before resampling.
        mean, sigma = particle_moments(particles, weights)
        u = noise.get("resample_u")
        if u is None:
            u = torch.rand(particles.shape[0], generator=generator, device=particles.device)
        t = resampling.systematic_thresholds(weights, _as_tensor(u, particles.device))
        # The resampled weights are the gathered likelihood weights: they
        # center the next step's search boxes.
        particles, weights = systematic_resample(t, particles, weights)
        new_state = dataclasses.replace(
            state, particles=particles, weights=weights, step=state.step + 1, valid=valid
        )
        return new_state, {"mean": mean, "sigma": sigma, "valid": valid}

    def track(self, generator: torch.Generator, images, dts, noise=None) -> Tuple[BatchState, dict]:
        """Track through a sequence.

        Arguments:
            generator: source of every random draw not injected.
            images: (T, O, H, W); frame 0 makes the templates.
            dts: (T-1,) time steps in motion time units.
            noise: injected draws {"init": {"xy", "z", "v"}, "a": (T-1, N, P, 3),
                "resample_u": (T-1, N)}, each optional.

        Returns (final state, outputs) with outputs "mean" and "sigma"
        (T-1, N, 6) and "valid" (T-1, N).
        """
        images = _as_tensor(images, self.device)
        dts = _as_tensor(dts, self.device)
        noise = noise or {}
        step_noise = {
            k: _as_tensor(noise[k], self.device) for k in ("a", "resample_u") if k in noise
        }
        state = self.initialize(generator, images[0], noise=noise.get("init"))
        outs = []
        for i in range(dts.shape[0]):
            state, out = self.step(
                state, images[1 + i], dts[i], noise={k: x[i] for k, x in step_noise.items()}
            )
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
