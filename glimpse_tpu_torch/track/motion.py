"""Particle motion models.

The counterpart of :mod:`glimpse_tpu.track.motion`, host NumPy models:
particle state is (x, y, z, vx, vy, vz); each model provides
``initialize_particles`` / ``evolve_particles`` / ``compute_log_likelihoods``.
The host classes here carry an explicit ``numpy.random.Generator`` (``rng``
attribute) rather than mutating global RNG state, and expose their
parameters as flat arrays so the batched tracker
(:func:`glimpse_tpu_torch.track.batch.BatchMotion.from_motions`) can stack
thousands of models into one set of tensors.
"""
import datetime
from typing import Iterable, Optional, Union

import numpy as np

from ..raster import Raster

Number = Union[int, float]


def _as_raster(obj) -> Raster:
    if isinstance(obj, Raster):
        return obj
    return Raster(obj, x=[-np.inf, np.inf], y=[-np.inf, np.inf])


def _noisy(rng: np.random.Generator, mean, sigma, n: int, k: int) -> np.ndarray:
    """(n, k) Gaussian draws ``mean + sigma * N(0, 1)``, broadcast over rows."""
    return np.asarray(mean) + np.asarray(sigma) * rng.standard_normal((n, k))


def _polar_xy(r: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """(n, 2) cartesian components of polar vectors (r, theta CCW from +x)."""
    return np.column_stack((r * np.cos(theta), r * np.sin(theta)))


def _surface_z(dem: Raster, dem_sigma: Optional[Raster], xy: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    """Heights drawn from a mean surface and (optionally) its uncertainty."""
    z = dem.sample(xy)
    if dem_sigma is not None:
        z = z + dem_sigma.sample(xy) * rng.standard_normal(len(xy))
    return z


def _rotate_polar_accel(v_xy: np.ndarray, radial: np.ndarray,
                        angular: np.ndarray) -> np.ndarray:
    """Rotate per-particle polar acceleration onto the velocity frame.

    The radial component acts along the unit velocity; the angular
    component is a rate of turn, contributing speed x angular along the
    left normal (-vy, vx)/speed. Returns (n, 2) cartesian accelerations.
    (No zero-speed guard, as in upstream's polar models: they are
    meant for flows with nonzero drift.)
    """
    speed = np.hypot(v_xy[:, 0], v_xy[:, 1])
    unit = v_xy / speed[:, None]
    left_normal = np.empty_like(unit)
    left_normal[:, 0] = -unit[:, 1]
    left_normal[:, 1] = unit[:, 0]
    scale = (speed * angular)[:, None]
    return radial[:, None] * unit + scale * left_normal


class Motion:
    """Minimal motion model: fixed initial position, drifting velocity.

    Illustrates the interface required by :class:`Tracker`; particles start
    at (x, y, 0) with normally distributed velocities and evolve ballistically.
    """

    def __init__(
        self,
        xy: Iterable[Number],
        time_unit: datetime.timedelta,
        n: int = 1000,
        vxyz_sigma: Iterable[Number] = (0, 0, 0),
        seed: Optional[int] = None,
    ) -> None:
        self.xy = xy
        self.time_unit = time_unit
        self.n = n
        self.vxyz_sigma = vxyz_sigma
        self.rng = np.random.default_rng(seed)

    def initialize_particles(self) -> np.ndarray:
        """Particle positions and velocities (n, 6)."""
        anchor = np.append(np.asarray(self.xy, dtype=float), 0.0)
        return np.column_stack((
            np.tile(anchor, (self.n, 1)),
            _noisy(self.rng, 0.0, self.vxyz_sigma, self.n, 3),
        ))

    def evolve_particles(self, particles: np.ndarray, dt: datetime.timedelta) -> None:
        """Advance particles in place by ``dt``."""
        units = dt.total_seconds() / self.time_unit.total_seconds()
        particles[:, 0:3] += units * particles[:, 3:6]

    def compute_log_likelihoods(self, particles: np.ndarray) -> Optional[np.ndarray]:
        """Optional per-particle negative log likelihood (added to observers')."""
        return None


class CartesianMotion(Motion):
    """Ballistic motion with normally distributed accelerations in x, y, z.

    Heights initialize from a mean surface (``dem``) and its uncertainty
    (``dem_sigma``); particles are weighted by their distance from that
    surface. The Welty (2018) 3-D model.
    """

    def __init__(
        self,
        xy: Iterable[Number],
        time_unit: datetime.timedelta,
        dem: Union[Number, Raster],
        dem_sigma: Union[Number, Raster] = None,
        n: int = 1000,
        xy_sigma: Iterable[Number] = (0, 0),
        vxyz: Iterable[Number] = (0, 0, 0),
        vxyz_sigma: Iterable[Number] = (0, 0, 0),
        axyz: Iterable[Number] = (0, 0, 0),
        axyz_sigma: Iterable[Number] = (0, 0, 0),
        seed: Optional[int] = None,
    ) -> None:
        self.xy = xy
        self.time_unit = time_unit
        self.dem = _as_raster(dem)
        self.dem_sigma = None if dem_sigma is None else _as_raster(dem_sigma)
        self.n = n
        self.xy_sigma = xy_sigma
        self.vxyz = vxyz
        self.vxyz_sigma = vxyz_sigma
        self.axyz = axyz
        self.axyz_sigma = axyz_sigma
        self.rng = np.random.default_rng(seed)

    def initialize_particles(self) -> np.ndarray:
        xy = _noisy(self.rng, self.xy, self.xy_sigma, self.n, 2)
        z = _surface_z(self.dem, self.dem_sigma, xy, self.rng)
        v = _noisy(self.rng, self.vxyz, self.vxyz_sigma, self.n, 3)
        return np.column_stack((xy, z, v))

    def evolve_particles(self, particles: np.ndarray, dt: datetime.timedelta) -> None:
        units = dt.total_seconds() / self.time_unit.total_seconds()
        axyz = _noisy(self.rng, self.axyz, self.axyz_sigma, len(particles), 3)
        particles[:, 0:3] += units * particles[:, 3:6] + 0.5 * axyz * units ** 2
        particles[:, 3:6] += units * axyz

    def compute_log_likelihoods(self, particles: np.ndarray) -> Optional[np.ndarray]:
        if self.dem_sigma is None:
            return None
        xy = particles[:, 0:2]
        gap = self.dem.sample(xy) - particles[:, 2]
        sig = self.dem_sigma.sample(xy)
        with np.errstate(divide="ignore", invalid="ignore"):
            ll = gap * gap / (2.0 * sig * sig)
        return np.where(sig != 0, ll, 0.0)


class CylindricalMotion(CartesianMotion):
    """Like :class:`CartesianMotion` but with motion specified in polar
    (speed, angle, vz) components (angles in radians CCW from +x)."""

    def __init__(
        self,
        xy: Iterable[Number],
        time_unit: datetime.timedelta,
        dem: Union[Number, Raster],
        dem_sigma: Union[Number, Raster] = None,
        n: int = 1000,
        xy_sigma: Iterable[Number] = (0, 0),
        vrthz: Iterable[Number] = (0, 0, 0),
        vrthz_sigma: Iterable[Number] = (0, 0, 0),
        arthz: Iterable[Number] = (0, 0, 0),
        arthz_sigma: Iterable[Number] = (0, 0, 0),
        seed: Optional[int] = None,
    ) -> None:
        super().__init__(
            xy=xy, time_unit=time_unit, dem=dem, dem_sigma=dem_sigma, n=n,
            xy_sigma=xy_sigma, seed=seed,
        )
        self.vrthz = vrthz
        self.vrthz_sigma = vrthz_sigma
        self.arthz = arthz
        self.arthz_sigma = arthz_sigma

    def initialize_particles(self) -> np.ndarray:
        xy = _noisy(self.rng, self.xy, self.xy_sigma, self.n, 2)
        z = _surface_z(self.dem, self.dem_sigma, xy, self.rng)
        v = _noisy(self.rng, self.vrthz, self.vrthz_sigma, self.n, 3)
        return np.column_stack((xy, z, _polar_xy(v[:, 0], v[:, 1]), v[:, 2]))

    def evolve_particles(self, particles: np.ndarray, dt: datetime.timedelta) -> None:
        units = dt.total_seconds() / self.time_unit.total_seconds()
        polar = _noisy(self.rng, self.arthz, self.arthz_sigma, len(particles), 3)
        accel = np.column_stack((
            _rotate_polar_accel(particles[:, 3:5], polar[:, 0], polar[:, 1]),
            polar[:, 2],
        ))
        particles[:, 0:3] += units * particles[:, 3:6] + (
            0.5 * units * units
        ) * accel
        particles[:, 3:6] += units * accel


class TangentCartesianMotion(Motion):
    """2-D motion glued to a surface (Brinkerhoff 2017, chapter 4).

    Particle z follows the DEM plus a random-walk offset proportional to the
    horizontal step length and a characteristic small-scale slope.
    """

    def __init__(
        self,
        xy: Iterable[Number],
        time_unit: datetime.timedelta,
        dem: Union[Number, Raster],
        dem_sigma: Union[Number, Raster] = 0,
        n: int = 1000,
        xy_sigma: Iterable[Number] = (0, 0),
        vxy: Iterable[Number] = (0, 0),
        vxy_sigma: Iterable[Number] = (0, 0),
        axy: Iterable[Number] = (0, 0),
        axy_sigma: Iterable[Number] = (0, 0),
        slope_sigma: Number = 0,
        seed: Optional[int] = None,
    ) -> None:
        self.xy = xy
        self.time_unit = time_unit
        self.dem = _as_raster(dem)
        self.dem_sigma = _as_raster(dem_sigma)
        self.n = n
        self.xy_sigma = xy_sigma
        self.vxy = vxy
        self.vxy_sigma = vxy_sigma
        self.axy = axy
        self.axy_sigma = axy_sigma
        self.slope_sigma = slope_sigma
        self.rng = np.random.default_rng(seed)

    def initialize_particles(self) -> np.ndarray:
        xy = _noisy(self.rng, self.xy, self.xy_sigma, self.n, 2)
        z = _surface_z(self.dem, self.dem_sigma, xy, self.rng)
        v = _noisy(self.rng, self.vxy, self.vxy_sigma, self.n, 2)
        return np.column_stack((xy, z, v, np.zeros(self.n)))

    def _glide(self, particles: np.ndarray, dxy: np.ndarray) -> None:
        """Move horizontally by ``dxy``, keeping z glued to the DEM.

        The height offset from the DEM only survives resampling through z
        itself, so it is recovered before the move and random-walked in proportion to the
        horizontal step length and the small-scale slope.
        """
        offset = particles[:, 2] - self.dem.sample(particles[:, 0:2])
        step = np.hypot(dxy[:, 0], dxy[:, 1])
        offset += self.slope_sigma * self.rng.standard_normal(
            len(particles)
        ) * step
        particles[:, 0:2] += dxy
        particles[:, 2] = offset + self.dem.sample(particles[:, 0:2])

    def evolve_particles(self, particles: np.ndarray, dt: datetime.timedelta) -> None:
        units = dt.total_seconds() / self.time_unit.total_seconds()
        draws = self.rng.standard_normal((len(particles), 2))
        axy = self.axy + self.axy_sigma * draws
        dxy = units * particles[:, 3:5] + (0.5 * units * units) * axy
        self._glide(particles, dxy)
        particles[:, 3:5] += units * axy


class TangentCylindricalMotion(TangentCartesianMotion):
    """Like :class:`TangentCartesianMotion` with polar (speed, angle) motion."""

    def __init__(
        self,
        xy: Iterable[Number],
        time_unit: datetime.timedelta,
        dem: Union[Number, Raster],
        dem_sigma: Union[Number, Raster] = None,
        n: int = 1000,
        xy_sigma: Iterable[Number] = (0, 0),
        vrth: Iterable[Number] = (0, 0),
        vrth_sigma: Iterable[Number] = (0, 0),
        arth: Iterable[Number] = (0, 0),
        arth_sigma: Iterable[Number] = (0, 0),
        slope_sigma: Number = 0,
        seed: Optional[int] = None,
    ) -> None:
        super().__init__(
            xy=xy, time_unit=time_unit, dem=dem,
            dem_sigma=0 if dem_sigma is None else dem_sigma, n=n,
            xy_sigma=xy_sigma, slope_sigma=slope_sigma, seed=seed,
        )
        self.vrth = vrth
        self.vrth_sigma = vrth_sigma
        self.arth = arth
        self.arth_sigma = arth_sigma

    def initialize_particles(self) -> np.ndarray:
        xy = _noisy(self.rng, self.xy, self.xy_sigma, self.n, 2)
        z = _surface_z(self.dem, self.dem_sigma, xy, self.rng)
        v = _noisy(self.rng, self.vrth, self.vrth_sigma, self.n, 2)
        return np.column_stack((xy, z, _polar_xy(v[:, 0], v[:, 1]),
                                np.zeros(self.n)))

    def evolve_particles(self, particles: np.ndarray, dt: datetime.timedelta) -> None:
        units = dt.total_seconds() / self.time_unit.total_seconds()
        polar = _noisy(self.rng, self.arth, self.arth_sigma, len(particles), 2)
        axy = _rotate_polar_accel(particles[:, 3:5], polar[:, 0], polar[:, 1])
        self._glide(
            particles, units * particles[:, 3:5] + (0.5 * units * units) * axy
        )
        particles[:, 3:5] += units * axy
