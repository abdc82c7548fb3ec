"""The plain particle-filter tracker that decides whether a run is correct.

A frozen, independent statement of what the tracker computes, written in
plain PyTorch from the configuration alone: it imports nothing of the
program and takes nothing the program made. It rebuilds templates, quantile
tables and prefilter matrices from the same frames and parameters the
benchmark hands the program, and draws its random numbers from its own
generator, seeded as the benchmark seeds the program's, in the order and
shapes the tracker documents (at the start ``xy`` (N, P, 2) and ``v``
(N, P, 3) standard normals; each step ``a`` (N, P, 3) standard normals,
then the systematic comb offsets (N,) uniform).

One step, for the points of a sample (every point's filter is independent
of the others'):

1. cartesian motion: ``xyz += dt v + a dt^2 / 2``, ``v += dt a``;
2. validity: every particle finite and on a visible viewshed cell;
3. per observer, project the particles through its camera (a pinhole with
   rational radial and tangential distortion), cut a search tile at the
   weighted-mean projection;
4. normalize each tile, match its histogram to the template's quantile
   table, median high-pass (symmetric padding);
5. SSE map against the template, cubic B-spline prefilter (natural
   boundary) and exact 16-tap read at each particle, plus a quadratic
   penalty outside the surface; observers masked out of a step weigh 0;
6. weights ``exp(-(ll - min ll)) + 1e-30``, weighted moments, systematic
   resampling (a threshold table, a left search, a row gather).

``precision`` computes it as the configuration states (``"float32"``, with
TF32 off for the SSE convolution and the prefilter's matrix products), or
with state, frames, tiles and surfaces in bfloat16 (``"bfloat16"``): the
control that a check has to fail.
"""
import contextlib
import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "bfloat16")


@dataclasses.dataclass
class Problem:
    """A tracking problem as the configuration and the traffic state it.

    ``cameras`` (O, 20) float32 camera vectors (xyz, viewdir in degrees,
    imgsz, f, c, k, p); ``points_xy`` (N, 2) start positions; ``masks``
    (T, O) observer flags a step and ``mask0`` (O,) the template frame's,
    or None; ``viewshed`` a mapping with ``array``, ``x0``, ``y0``, ``dx``,
    ``dy``, or None. The DEM is flat at z = 0 and carries no sigma.
    """

    cameras: np.ndarray
    sigmas: Sequence[float]
    points_xy: np.ndarray
    xy_sigma: Sequence[float]
    v_sigma: Sequence[float]
    a_sigma: Sequence[float]
    n_particles: int
    template_size: Tuple[int, int]
    search_size: Tuple[int, int]
    highpass_size: Tuple[int, int] = (5, 5)
    n_quantiles: int = 256
    masks: Optional[np.ndarray] = None
    mask0: Optional[np.ndarray] = None
    viewshed: Optional[dict] = None


@contextlib.contextmanager
def _full_float32():
    """Matrix products and cuDNN convolutions in full float32, not TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def rotation(viewdir: torch.Tensor) -> torch.Tensor:
    """World (east, north, up) to camera (right, down, forward) rotation from
    (yaw, pitch, roll) in degrees."""
    c0, c1, c2 = torch.cos(viewdir * (math.pi / 180))
    s0, s1, s2 = torch.sin(viewdir * (math.pi / 180))
    return torch.stack([
        torch.stack([c0 * c2 + s0 * s1 * s2, c0 * s1 * s2 - c2 * s0, -c1 * s2]),
        torch.stack([c2 * s0 * s1 - c0 * s2, s0 * s2 + c0 * c2 * s1, -c1 * c2]),
        torch.stack([c1 * s0, c0 * c1, s1]),
    ])


def _to_pixels(xn, yn, camera: torch.Tensor):
    """Normalized camera coordinates to pixels: rational radial (k1..k6) and
    tangential (p1, p2) distortion, focal length, principal point."""
    k, p = camera[12:18], camera[18:20]
    r2 = xn * xn + yn * yn
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k[0] * r2 + k[1] * r4 + k[2] * r6) / (1 + k[3] * r2 + k[4] * r4 + k[5] * r6)
    xy = xn * yn
    dx = 2 * xy * p[0] + p[1] * (r2 + 2 * xn * xn)
    dy = p[0] * (r2 + 2 * yn * yn) + 2 * xy * p[1]
    u = (xn * radial + dx) * camera[8] + (camera[6] * 0.5 + camera[10])
    v = (yn * radial + dy) * camera[9] + (camera[7] * 0.5 + camera[11])
    return u, v


def project(camera: torch.Tensor, x, y, z):
    """Pixel coordinates (u, v) of world points given as coordinate planes;
    NaN at or behind the camera."""
    R = rotation(camera[3:6])
    d = (x - camera[0], y - camera[1], z - camera[2])
    xc, yc, zc = (R[i, 0] * d[0] + R[i, 1] * d[1] + R[i, 2] * d[2] for i in range(3))
    behind = zc <= 0
    zc = torch.where(behind, torch.ones_like(zc), zc)
    return _to_pixels((xc / zc).masked_fill(behind, math.nan), (yc / zc).masked_fill(behind, math.nan), camera)


def project_points(camera: torch.Tensor, xyz: torch.Tensor):
    """Pixel coordinates (u, v) of world points (S, 3), rotated by one matrix
    product; NaN at or behind the camera."""
    c = (xyz - camera[0:3]) @ rotation(camera[3:6]).T
    behind = c[:, 2] <= 0
    depth = torch.where(behind, torch.ones_like(c[:, 2]), c[:, 2])
    xy = (c[:, 0:2] / depth[:, None]).masked_fill(behind[:, None], math.nan)
    return _to_pixels(xy[:, 0], xy[:, 1], camera)


def tiles_at(image: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, size: Tuple[int, int]):
    """Tiles (N, h, w) of an image (H, W) whose upper-left corners are (rows, cols)."""
    h, w = size
    r = rows[:, None, None] + torch.arange(h, device=image.device)[None, :, None]
    c = cols[:, None, None] + torch.arange(w, device=image.device)[None, None, :]
    return image[r, c]


def corners(u_mean, v_mean, size: Tuple[int, int], image_shape: Tuple[int, int]):
    """Integer upper-left corners of ``size`` boxes centred at (u, v), rounded
    half to even and clamped into the image."""
    h, w = size
    H, W = image_shape
    col = torch.round(u_mean - w * 0.5).long().clamp(0, W - w)
    row = torch.round(v_mean - h * 0.5).long().clamp(0, H - h)
    return row, col


def normalize(tiles: torch.Tensor) -> torch.Tensor:
    """Each tile to mean 0 and standard deviation 1 (plus 1e-12)."""
    centered = tiles - tiles.mean(dim=(-2, -1), keepdim=True)
    std = torch.sqrt((centered * centered).mean(dim=(-2, -1), keepdim=True))
    return centered / (std + 1e-12)


def _symmetric(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of an axis padded by reflection that repeats the edge pixel."""
    i = torch.remainder(torch.arange(-before, n + after, device=device), 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def median_highpass(tiles: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Tile minus its median filter over odd ``size`` windows, symmetric padding."""
    kh, kw = size
    H, W = tiles.shape[-2:]
    padded = tiles.index_select(-2, _symmetric(H, kh // 2, kh // 2, tiles.device))
    padded = padded.index_select(-1, _symmetric(W, kw // 2, kw // 2, tiles.device))
    windows = padded.unfold(-2, kh, 1).unfold(-2, kw, 1).reshape(*tiles.shape, kh * kw)
    return tiles - windows.median(dim=-1).values


def quantile_table(tiles: torch.Tensor, n_quantiles: int) -> torch.Tensor:
    """(N, K): each normalized tile's sorted values at quantiles (k + 0.5) / K
    (index floor((k + 0.5) n / K), computed in float32)."""
    n = tiles.shape[-1] * tiles.shape[-2]
    q = (np.arange(n_quantiles, dtype=np.float32) + np.float32(0.5)) * np.float32(n) / np.float32(n_quantiles)
    index = torch.as_tensor(np.clip(np.floor(q).astype(np.int64), 0, n - 1), device=tiles.device)
    return torch.sort(tiles.reshape(tiles.shape[0], n), dim=-1).values[:, index]


def match_histograms(tiles: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each tile's value of rank j becomes its table (N, K) read linearly at
    quantile (j + 1) / n (taps computed in float64, rounded to float32);
    ties keep pixel order."""
    N, h, w = tiles.shape
    n, K = h * w, table.shape[-1]
    pos = np.clip((np.arange(n) + 1.0) / n * K - 0.5, 0.0, K - 1.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), K - 2)
    frac = pos - i0
    i0 = torch.as_tensor(i0, device=tiles.device)
    w0 = torch.as_tensor((1.0 - frac).astype(np.float32), device=tiles.device)
    w1 = torch.as_tensor(frac.astype(np.float32), device=tiles.device)
    wide = table.float()
    values = (wide[:, i0] * w0 + wide[:, i0 + 1] * w1).to(tiles.dtype)
    order = torch.sort(tiles.reshape(N, n), dim=-1, stable=True).indices
    return torch.empty_like(values).scatter_(1, order, values).reshape(N, h, w)


def sse_maps(search: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences of each template over its search tile:
    (N, sh - th + 1, sw - tw + 1), as window sums of S^2, the correlation
    S * T and the sum of T^2."""
    N = search.shape[0]
    th, tw = templates.shape[-2:]
    ones = torch.ones((N, 1, th, tw), dtype=search.dtype, device=search.device)
    s2 = F.conv2d((search * search)[None], ones, groups=N)[0]
    corr = F.conv2d(search[None], templates[:, None], groups=N)[0]
    return s2 - 2 * corr + (templates * templates).sum(dim=(-2, -1))[:, None, None]


def _collocation_inverse(n: int) -> np.ndarray:
    """Inverse of the cubic B-spline collocation matrix of n nodes, with the
    natural ghosts c[-1] = 2 c[0] - c[1], c[n] = 2 c[n-1] - c[n-2] folded in."""
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 4 / 6
        if i > 0:
            A[i, i - 1] += 1 / 6
        if i < n - 1:
            A[i, i + 1] += 1 / 6
    A[0, 0] += 2 / 6
    A[0, 1] -= 1 / 6
    A[n - 1, n - 1] += 2 / 6
    A[n - 1, n - 2] -= 1 / 6
    return np.linalg.inv(A)


def spline_coefficients(surfaces: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficients of surfaces (B, H, W): Ar @ S @ Ac^T."""
    H, W = surfaces.shape[-2:]
    Ar = torch.as_tensor(_collocation_inverse(H), device=surfaces.device).to(surfaces.dtype)
    Ac = torch.as_tensor(_collocation_inverse(W), device=surfaces.device).to(surfaces.dtype)
    return Ar @ surfaces @ Ac.T


def spline_read(coeffs: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The cubic B-spline (B, H, W) at fractional indices (B, Q): 16 taps,
    natural ghosts beyond each edge."""
    B, H, W = coeffs.shape
    flat = coeffs.reshape(B, H * W)

    def basis(t):
        return ((1 - t) ** 3 / 6, (4 - 6 * t * t + 3 * t ** 3) / 6, (1 + 3 * t + 3 * t * t - 3 * t ** 3) / 6, t ** 3 / 6)

    def ghosted(i, n):
        """(index, weight) pairs that give coefficient i of an axis of n."""
        low, high = i < 0, i > n - 1
        first = torch.where(low, 0, torch.where(high, n - 1, i))
        second = torch.where(low, min(1, n - 1), torch.where(high, max(n - 2, 0), i))
        ghost = low | high
        return first, torch.where(ghost, 2.0, 1.0), second, torch.where(ghost, -1.0, 0.0)

    r0, c0 = torch.floor(rows), torch.floor(cols)
    wr, wc = basis(rows - r0), basis(cols - c0)
    r0, c0 = r0.long(), c0.long()
    out = torch.zeros_like(rows)
    for dr in range(4):
        ra, wra, rb, wrb = ghosted(r0 + dr - 1, H)
        for dc in range(4):
            ca, wca, cb, wcb = ghosted(c0 + dc - 1, W)
            value = sum(
                wi * wj * flat.gather(1, i * W + j)
                for i, wi in ((ra, wra), (rb, wrb)) for j, wj in ((ca, wca), (cb, wcb))
            )
            out = out + wr[dr] * wc[dc] * value
    return out


class Draws:
    """The tracker's random numbers from a generator seeded as the
    program's, drawn at the full width N and read at the sample's rows."""

    def __init__(self, seed: int, n_points: int, n_particles: int, device, rows: torch.Tensor) -> None:
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.shape = (n_points, n_particles)
        self.device = device
        self.rows = rows

    def normal(self, width: int) -> torch.Tensor:
        return torch.randn((*self.shape, width), generator=self.generator, device=self.device)[self.rows]

    def uniform(self) -> torch.Tensor:
        return torch.rand(self.shape[0], generator=self.generator, device=self.device)[self.rows]


class Tracker:
    """The plain filter on the sampled points ``rows`` of ``problem``."""

    def __init__(self, problem: Problem, rows, device, precision: str = "float32") -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.problem = problem
        self.device = torch.device(device)
        self.rows = torch.as_tensor(np.asarray(rows), device=self.device)
        self.dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        self.cameras = torch.as_tensor(np.asarray(problem.cameras, np.float32), device=self.device)
        self.inv_2s2 = torch.tensor([1.0 / (2.0 * s ** 2) for s in problem.sigmas], dtype=torch.float64)
        self.inv_2s2 = self.inv_2s2.to(self.device, self.dtype)
        as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)  # noqa: E731
        self.start = as32(problem.points_xy)[self.rows]
        self.xy_sigma, self.v_sigma, self.a_sigma = as32(problem.xy_sigma), as32(problem.v_sigma), as32(problem.a_sigma)
        self.viewshed = None
        if problem.viewshed is not None:
            self.viewshed = {k: as32(v) for k, v in problem.viewshed.items()}

    def visible(self, particles: torch.Tensor) -> torch.Tensor:
        """(S,) every particle of the point finite and on a visible cell."""
        ok = torch.isfinite(particles.float()).flatten(1).all(dim=1)
        if self.viewshed is None:
            return ok
        v = self.viewshed
        H, W = v["array"].shape
        xy = particles[..., 0:2].float()
        col = torch.floor((xy[..., 0] - v["x0"]) / v["dx"]).long().clamp(0, W - 1)
        row = torch.floor((xy[..., 1] - v["y0"]) / v["dy"]).long().clamp(0, H - 1)
        return ok & (v["array"][row, col] > 0).all(dim=-1)

    def template(self, image: torch.Tensor, camera: torch.Tensor, xyz: torch.Tensor):
        """High-passed template tiles, quantile tables and subpixel offsets
        cut at the projections of points xyz (S, 3)."""
        p = self.problem
        th, tw = p.template_size
        u, v = project_points(camera, xyz)
        row, col = corners(u, v, (th, tw), image.shape)
        tiles = normalize(tiles_at(image, row, col, (th, tw)))
        duv = torch.stack([u - (col.to(self.dtype) + tw * 0.5), v - (row.to(self.dtype) + th * 0.5)], dim=-1)
        return median_highpass(tiles, p.highpass_size), quantile_table(tiles, p.n_quantiles), duv

    def initialize(self, draws: Draws, image0: torch.Tensor) -> dict:
        p = self.problem
        xy = self.start[:, None, :] + self.xy_sigma * draws.normal(2)
        v = self.v_sigma * draws.normal(3)
        particles = torch.cat([xy, torch.zeros_like(xy[..., :1]), v], dim=-1)
        S, O = particles.shape[0], len(self.cameras)
        th, tw = p.template_size
        present = np.ones(O, bool) if p.mask0 is None else np.asarray(p.mask0) > 0
        xyz = particles[..., 0:3].mean(dim=1)
        templates = torch.zeros((O, S, th, tw), dtype=self.dtype, device=self.device)
        tables = torch.zeros((O, S, p.n_quantiles), dtype=self.dtype, device=self.device)
        duvs = torch.zeros((O, S, 2), dtype=torch.float32, device=self.device)
        image0 = image0.to(self.device, self.dtype)
        for o in np.flatnonzero(present):
            templates[o], tables[o], duvs[o] = self.template(image0[o], self.cameras[o], xyz)
        return {
            "particles": particles.to(self.dtype), "weights": torch.ones(particles.shape[:2], device=self.device,
                                                                         dtype=self.dtype),
            "templates": templates, "tables": tables, "duv": duvs,
            "valid": self.visible(particles).to(self.dtype),
        }

    def likelihoods(self, images, particles, state, mask) -> torch.Tensor:
        """Sum over observers of the negative log likelihood (S, P)."""
        p = self.problem
        th, tw = p.template_size
        sh, sw = p.search_size
        oh, ow = sh - th + 1, sw - tw + 1
        w = state["weights"] / state["weights"].sum(dim=-1, keepdim=True)
        total = torch.zeros(particles.shape[:2], dtype=torch.float32, device=self.device)
        for o, camera in enumerate(self.cameras):
            if mask is not None and not mask[o] > 0:
                continue
            u, v = project(camera, *(particles[..., i].float() for i in range(3)))
            u, v = torch.nan_to_num(u, nan=-1e6), torch.nan_to_num(v, nan=-1e6)
            row, col = corners((u * w).sum(dim=1), (v * w).sum(dim=1), (sh, sw), images[o].shape)
            search = tiles_at(images[o], row, col, (sh, sw))
            search = median_highpass(match_histograms(normalize(search), state["tables"][o]), p.highpass_size)
            with _full_float32():
                sse = sse_maps(search, state["templates"][o]) * (1.0 / (th * tw))
                coeffs = spline_coefficients(sse)
            duv = state["duv"][o]
            cols = u - (col.float() + (tw * 0.5 - 0.5) + duv[:, 0])[:, None] - 0.5
            rows = v - (row.float() + (th * 0.5 - 0.5) + duv[:, 1])[:, None] - 0.5
            cols_c, rows_c = cols.clamp(0.0, ow - 1.0), rows.clamp(0.0, oh - 1.0)
            outside = (cols - cols_c) ** 2 + (rows - rows_c) ** 2
            total = total + spline_read(coeffs, rows_c.to(self.dtype), cols_c.to(self.dtype)).float() * \
                self.inv_2s2[o].float() + outside
        return total

    def step(self, draws: Draws, state: dict, images: torch.Tensor, dt: float, mask, new_templates=()):
        """One update; returns (new state, {"mean", "sigma", "valid"})."""
        images = images.to(self.device, self.dtype)
        particles = state["particles"].float()
        a = self.a_sigma * draws.normal(3)
        moved = dt * particles[..., 3:6] + 0.5 * a * dt ** 2
        particles = torch.cat([particles[..., 0:3] + moved, particles[..., 3:6] + dt * a], dim=-1).to(self.dtype)
        valid = state["valid"] * self.visible(particles).to(self.dtype)
        if new_templates:
            state = dict(state, templates=state["templates"].clone(), tables=state["tables"].clone(),
                         duv=state["duv"].clone())
            w = (state["weights"] / state["weights"].sum(dim=-1, keepdim=True)).float()
            xyz_mean = (particles[..., 0:3].float() * w[..., None]).sum(dim=1)
            for o in new_templates:
                state["templates"][o], state["tables"][o], state["duv"][o] = self.template(
                    images[o], self.cameras[o], xyz_mean)
        ll = self.likelihoods(images, particles, state, mask)
        weights = (torch.exp(-(ll - ll.min(dim=-1, keepdim=True).values)) + 1e-30).to(self.dtype)
        if mask is not None and not (np.asarray(mask) > 0).any():
            weights = state["weights"]  # no observer and no motion prior informed the step
        wn = weights / weights.sum(dim=-1, keepdim=True)
        mean = (particles * wn[..., None]).sum(dim=1)
        sigma = torch.sqrt(((particles - mean[:, None, :]) ** 2 * wn[..., None]).sum(dim=1))
        P = weights.shape[1]
        cumulative = torch.cumsum(wn.float(), dim=-1, dtype=torch.float64).float()
        thresholds = P * cumulative - draws.uniform()[:, None]
        slots = torch.arange(P, dtype=torch.float32, device=self.device).expand_as(thresholds).contiguous()
        source = torch.searchsorted(thresholds, slots, side="left").clamp(max=P - 1)
        new_state = dict(
            state, particles=particles.gather(1, source[..., None].expand(-1, -1, 6)),
            weights=weights.gather(1, source), valid=valid,
        )
        return new_state, {"mean": mean, "sigma": sigma, "valid": valid}


def late_templates(problem: Problem, n_steps: int) -> dict:
    """{step (1-based): observers whose template is cut there}: each observer
    absent from the template frame starts at its first unmasked step."""
    if problem.mask0 is None:
        return {}
    plan: dict = {}
    for o, present in enumerate(np.asarray(problem.mask0) > 0):
        fires = np.flatnonzero(np.asarray(problem.masks)[:n_steps, o] > 0)
        if not present and fires.size:
            plan.setdefault(int(fires[0]) + 1, []).append(o)
    return plan


def track(problem: Problem, frame: Callable[[int], torch.Tensor], n_steps: int, seed: int, rows,
          device, precision: str = "float32", dt: float = 1.0) -> dict:
    """The plain filter's outputs at the sampled points ``rows`` over
    ``n_steps`` steps: "mean" and "sigma" (T, S, 6) and "valid" (T, S),
    float32. ``frame(t)`` gives frame t (O, H, W); the draws come from a
    generator on ``device`` seeded with ``seed``."""
    tracker = Tracker(problem, rows, device, precision)
    draws = Draws(seed, len(problem.points_xy), problem.n_particles, device, tracker.rows)
    state = tracker.initialize(draws, frame(0))
    plan = late_templates(problem, n_steps)
    outputs = []
    for t in range(1, n_steps + 1):
        mask = None if problem.masks is None else np.asarray(problem.masks)[t - 1]
        state, out = tracker.step(draws, state, frame(t), dt, mask, plan.get(t, ()))
        outputs.append({k: v.float() for k, v in out.items()})
    return {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}
