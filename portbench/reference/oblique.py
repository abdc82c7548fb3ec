"""The plain 3-D particle filter with DEM uncertainty (Welty 2018) that decides
whether an ``oblique`` run is correct.

:mod:`.filter`'s tracker with the two things the 3-D model adds, written from
the configuration alone in plain PyTorch (it imports nothing of the program):

- the start: ``xy`` drawn about each point, then ``z = dem(xy) + sigma(xy)
  N(0, 1)``, then ``v``; the draws in that order, ``xy`` (N, P, 2), ``z``
  (N, P) and ``v`` (N, P, 3) standard normals, then each step ``a`` and the
  systematic comb offsets as :mod:`.filter` draws them;
- the DEM prior in every step's weights: ``(dem(xy) - z)^2 / (2 sigma(xy)^2)``
  added to the observers' negative log likelihood where ``sigma(xy) > 0``.

Both rasters are read bilinearly at the particle's xy between cell centres,
and extrapolated linearly from the edge cells outside them. Projection uses
each particle's own z. Departures from the host model
(``CartesianMotion.compute_log_likelihoods``): the prior is computed in
float32 (the host's in float64), and applies where sigma is positive (the
host's where it is nonzero; a sigma raster holds no negative cell).

:func:`numbers` compares the three coordinates in metres.
"""
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import compare, filter


@dataclasses.dataclass
class Problem(filter.Problem):
    """:class:`.filter.Problem` with the DEM and its sigma: raster fields
    (``array``, ``x0``, ``y0``, ``dx``, ``dy``) on one grid."""

    dem: Optional[dict] = None
    dem_sigma: Optional[dict] = None


def bilinear(raster: dict, xy: torch.Tensor) -> torch.Tensor:
    """A raster (fields as float32 tensors) at world points (..., 2): bilinear
    between cell centres, extrapolated linearly from the edge cells."""
    values = raster["array"]
    H, W = values.shape
    cols = (xy[..., 0] - raster["x0"]) / raster["dx"] - 0.5
    rows = (xy[..., 1] - raster["y0"]) / raster["dy"] - 0.5
    r0 = torch.floor(rows).clamp(0, H - 2)
    c0 = torch.floor(cols).clamp(0, W - 2)
    fr, fc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()
    top = values[r0, c0] + (values[r0, c0 + 1] - values[r0, c0]) * fc
    bottom = values[r0 + 1, c0] + (values[r0 + 1, c0 + 1] - values[r0 + 1, c0]) * fc
    return top + (bottom - top) * fr


def standard_normal(draws: filter.Draws) -> torch.Tensor:
    """(S, P) standard normals, drawn (N, P) at the full width."""
    return torch.randn(draws.shape, generator=draws.generator, device=draws.device)[draws.rows]


class Tracker(filter.Tracker):
    """The plain filter with a DEM-drawn z and the DEM prior."""

    def __init__(self, problem: Problem, rows, device, precision: str = "float32") -> None:
        super().__init__(problem, rows, device, precision)
        as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)  # noqa: E731
        self.dem = {k: as32(v) for k, v in problem.dem.items()}
        self.dem_sigma = {k: as32(v) for k, v in problem.dem_sigma.items()}

    def prior(self, particles: torch.Tensor) -> torch.Tensor:
        """The DEM prior's negative log likelihood (S, P), float32."""
        xyz = particles[..., 0:3].float()
        sigma = bilinear(self.dem_sigma, xyz[..., 0:2])
        gap = bilinear(self.dem, xyz[..., 0:2]) - xyz[..., 2]
        safe = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
        return torch.where(sigma > 0, gap * gap / (2 * safe * safe), torch.zeros_like(sigma))

    def initialize(self, draws: filter.Draws, image0: torch.Tensor) -> dict:
        p = self.problem
        xy = self.start[:, None, :] + self.xy_sigma * draws.normal(2)
        z = bilinear(self.dem, xy) + bilinear(self.dem_sigma, xy) * standard_normal(draws)
        v = self.v_sigma * draws.normal(3)
        particles = torch.cat([xy, z[..., None], v], dim=-1)
        S, O = particles.shape[0], len(self.cameras)
        th, tw = p.template_size
        xyz = particles[..., 0:3].mean(dim=1)
        templates = torch.zeros((O, S, th, tw), dtype=self.dtype, device=self.device)
        tables = torch.zeros((O, S, p.n_quantiles), dtype=self.dtype, device=self.device)
        duvs = torch.zeros((O, S, 2), dtype=torch.float32, device=self.device)
        image0 = image0.to(self.device, self.dtype)
        for o in range(O):
            templates[o], tables[o], duvs[o] = self.template(image0[o], self.cameras[o], xyz)
        return {
            "particles": particles.to(self.dtype),
            "weights": torch.ones(particles.shape[:2], device=self.device, dtype=self.dtype),
            "templates": templates, "tables": tables, "duv": duvs, "valid": self.visible(particles).to(self.dtype),
        }

    def likelihoods(self, images, particles, state, mask) -> torch.Tensor:
        return super().likelihoods(images, particles, state, mask) + self.prior(particles)


def track(problem: Problem, frame, n_steps: int, seed: int, rows, device, precision: str = "float32",
          dt: float = 1.0) -> dict:
    """:func:`.filter.track` with this module's tracker: "mean" and "sigma"
    (T, S, 6) and "valid" (T, S) at the sampled points ``rows``."""
    tracker = Tracker(problem, rows, device, precision)
    draws = filter.Draws(seed, len(problem.points_xy), problem.n_particles, device, tracker.rows)
    state = tracker.initialize(draws, frame(0))
    outputs = []
    for t in range(1, n_steps + 1):
        state, out = tracker.step(draws, state, frame(t), dt, None)
        outputs.append({k: v.float() for k, v in out.items()})
    return {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}


def numbers(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], truth: np.ndarray,
            early_steps: int, quantile: float) -> Dict[str, float]:
    """The compared numbers of one tracking run at the sampled points, in
    metres: ``program`` and ``reference`` hold "mean" (T, S, 6), ``truth``
    (T, S, 3) the true positions after each step, z the DEM's there.

    - ``start_gap_m``: the largest |program - reference| of a mean (x, y, z)
      at step 1, before any resampling;
    - ``early_gap_m``: over steps 1 to ``early_steps``, the largest
      ``quantile`` over the points of that gap;
    - ``error_ratio``: the RMS distance of the last means' (x, y) from the
      truth, the program's over the reference's;
    - ``z_error_ratio``: the RMS of z's departure from the DEM at the true
      xy over every step and point, the program's over the reference's.
    """
    got = program["mean"][..., 0:3].double().cpu()
    want = reference["mean"][..., 0:3].double().cpu()
    gap = (got - want).abs().amax(dim=-1)  # (T, S)
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    early = torch.quantile(gap[:early_steps], quantile, dim=1, interpolation="higher")
    truth = torch.as_tensor(truth, dtype=torch.float64)
    xy = compare.numbers(program, reference, truth[..., 0:2].numpy(), early_steps, quantile)

    def z_rms(means):
        return float(torch.sqrt(((means[..., 2] - truth[..., 2]) ** 2).mean()))

    return {
        "start_gap_m": float(gap[0].max()),
        "early_gap_m": float(early.max()),
        "error_ratio": xy["error_ratio"],
        "z_error_ratio": z_rms(got) / z_rms(want),
    }
