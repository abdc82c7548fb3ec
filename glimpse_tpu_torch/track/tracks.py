"""Container for tracked particle trajectories.

The counterpart of :class:`glimpse_tpu.track.Tracks`: per-track means,
sigmas/covariances, optional raw particles/weights, per-track errors and
warnings (fault containment), temporal reversal for backward tracking, and
inverse-variance fusion of multiple runs.
"""
import datetime
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np

from .. import helpers

Index = Union[slice, Iterable[int]]
Number = Union[int, float]


def _precision_weighted_fuse(means, sigmas, axis, correlation, ignore_nan):
    """Inverse-variance-weighted combination of normal estimates."""
    precision = sigmas ** -2
    return helpers.sum_normals(
        means=means,
        sigmas=sigmas,
        weights=precision,
        normalize=True,
        correlation=correlation,
        axis=axis,
        ignore_nan=ignore_nan,
    )


class Tracks:
    """Estimated trajectories of world points.

    Dimensions: n tracks, m datetimes, p particles.
    """

    def __init__(
        self,
        datetimes: Iterable[datetime.datetime],
        time_unit: datetime.timedelta,
        means,
        sigmas=None,
        covariances=None,
        particles=None,
        weights=None,
        tracker=None,
        images=None,
        params: dict = None,
        errors: Iterable = None,
        warnings: Iterable = None,
    ) -> None:
        self.datetimes = np.asarray(datetimes)
        self.time_unit = time_unit
        self.means = self._stack(means)
        self.sigmas = self._stack(sigmas)
        self.covariances = self._stack(covariances)
        self.particles = self._stack(particles)
        self.weights = self._stack(weights)
        self.tracker = tracker
        self.images = images if images is None else np.asarray(images)
        self.params = params
        self.errors = errors if errors is None else np.asarray(errors, dtype=object)
        self.warnings = (
            warnings if warnings is None else np.asarray(warnings, dtype=object)
        )
        self.reduced: Optional[list] = None

    @staticmethod
    def _stack(value):
        if value is None or isinstance(value, np.ndarray):
            return value
        if np.iterable(value):
            return np.stack(value, axis=0)
        return value

    # ---- Accessors ---- #

    @property
    def xyz(self) -> np.ndarray:
        """Mean positions (n, m, 3)."""
        return self.means[:, :, 0:3]

    @property
    def vxyz(self) -> np.ndarray:
        """Mean velocities (n, m, 3)."""
        return self.means[:, :, 3:6]

    @property
    def xyz_sigma(self) -> Optional[np.ndarray]:
        """Position standard deviations (n, m, 3)."""
        if self.sigmas is not None:
            return self.sigmas[:, :, 0:3]
        if self.covariances is not None:
            variances = np.diagonal(
                self.covariances[:, :, :3, :3], axis1=-2, axis2=-1
            )
            return np.sqrt(variances)
        return None

    @property
    def vxyz_sigma(self) -> Optional[np.ndarray]:
        """Velocity standard deviations (n, m, 3)."""
        if self.sigmas is not None:
            return self.sigmas[:, :, 3:6]
        if self.covariances is not None:
            variances = np.diagonal(
                self.covariances[:, :, 3:, 3:], axis1=-2, axis2=-1
            )
            return np.sqrt(variances)
        return None

    @property
    def endpoints(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(valid-track mask, first valid index, last valid index)."""
        valid = np.isfinite(self.means[:, :, 0])
        m = valid.shape[1]
        steps = np.arange(m)
        has_any = valid.any(axis=1)
        first = np.min(np.where(valid, steps, m), axis=1)
        last = np.max(np.where(valid, steps, -1), axis=1)
        return has_any, first[has_any], last[has_any]

    @property
    def success(self) -> Optional[np.ndarray]:
        """Whether each track completed without errors (n,)."""
        if self.errors is not None:
            return np.array([error is None for error in self.errors])
        return None

    # ---- Transformations ---- #

    def reverse(self) -> None:
        """Reverse the temporal order (for backward tracking)."""
        def flip_time(value: Optional[np.ndarray]) -> Optional[np.ndarray]:
            if value is None:
                return None
            # Time is axis 0 for per-sequence arrays, axis 1 per track.
            return value[::-1] if value.ndim == 1 else value[:, ::-1, ...]

        for key in (
            "datetimes", "means", "sigmas", "covariances", "particles",
            "weights", "images",
        ):
            setattr(self, key, flip_time(getattr(self, key)))

    @classmethod
    def from_multiple(cls, runs: Iterable["Tracks"], ignore_nan: bool = False) -> "Tracks":
        """Fuse runs with identical timesteps by inverse-variance weighting.

        Runs are assumed uncorrelated (e.g. forward and backward passes over
        the same sequence).
        """
        runs = list(runs)
        lead = runs[0]
        for run in runs[1:]:
            if tuple(run.datetimes) != tuple(lead.datetimes):
                raise ValueError("Datetimes are not equal for all runs")
            if run.time_unit != lead.time_unit:
                raise ValueError(
                    "Time units are not equal for all runs: "
                    f"{ {r.time_unit for r in runs} }"
                )
        fused_means, fused_sigmas = _precision_weighted_fuse(
            np.stack([run.means for run in runs], axis=-1),
            np.stack([run.sigmas for run in runs], axis=-1),
            axis=-1,
            correlation=0,
            ignore_nan=ignore_nan,
        )
        return cls(
            datetimes=lead.datetimes.copy(),
            time_unit=lead.time_unit,
            means=fused_means,
            sigmas=fused_sigmas,
        )

    def average(self, ignore_nan: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Time-averaged distribution per track (assumes full correlation)."""
        return _precision_weighted_fuse(
            self.means, self.sigmas, axis=1, correlation=1, ignore_nan=ignore_nan
        )

    # ---- Plotting ---- #

    def plot_xy(
        self,
        tracks: Index = slice(None),
        start: Union[bool, dict] = True,
        mean: Union[bool, dict] = True,
        sigma: Union[bool, dict] = False,
    ) -> Dict[str, Any]:
        """Plot tracks on the x-y plane (start markers, mean paths, error bars)."""
        import matplotlib.pyplot as plt

        def style(spec, **defaults):
            overrides = {} if spec is True else dict(spec)
            return {**defaults, **overrides}

        out: Dict[str, Any] = {}
        base_color = "black"
        if mean:
            mean_style = style(mean, color=base_color)
            base_color = mean_style.get("color", base_color)
            out["mean"] = plt.plot(
                self.xyz[tracks, :, 0].T, self.xyz[tracks, :, 1].T, **mean_style
            )
        if start:
            out["start"] = plt.plot(
                self.xyz[tracks, 0, 0],
                self.xyz[tracks, 0, 1],
                **style(start, color=base_color, marker=".", linestyle="none"),
            )
        if sigma:
            bar_style = style(sigma, color=base_color, alpha=0.25)
            out["sigma"] = [
                plt.errorbar(
                    self.xyz[i, :, 0],
                    self.xyz[i, :, 1],
                    xerr=self.xyz_sigma[i, :, 0],
                    yerr=self.xyz_sigma[i, :, 1],
                    **bar_style,
                )
                for i in np.atleast_1d(np.arange(len(self.xyz))[tracks])
            ]
        return out

    def plot_vxy(self, tracks: Index = slice(None), **kwargs: Any) -> list:
        """Plot velocities as quiver fields on the x-y plane."""
        import matplotlib.pyplot as plt

        kwargs = {"angles": "xy", **kwargs}
        results = []
        for i in np.atleast_1d(np.arange(len(self.xyz))[tracks]):
            results.append(
                plt.quiver(
                    self.xyz[i, :, 0], self.xyz[i, :, 1],
                    self.vxyz[i, :, 0], self.vxyz[i, :, 1], **kwargs,
                )
            )
        return results

    def plot_v1d(
        self,
        dim: int,
        tracks: Index = slice(None),
        mean: Union[bool, dict] = True,
        sigma: Union[bool, dict] = False,
    ) -> Dict[str, Any]:
        """Plot one velocity component over time, with optional sigma band."""
        import matplotlib.pyplot as plt

        def style(spec, **defaults):
            overrides = {} if spec is True else dict(spec)
            return {**defaults, **overrides}

        out: Dict[str, Any] = {}
        base_color = "black"
        if mean:
            mean_style = style(mean, color=base_color)
            base_color = mean_style.get("color", base_color)
            out["mean"] = plt.plot(
                self.datetimes, self.vxyz[tracks, :, dim].T, **mean_style
            )
        if sigma:
            band_style = style(
                sigma, facecolor=base_color, edgecolor="none", alpha=0.25
            )
            bands = []
            for i in np.atleast_1d(np.arange(len(self.xyz))[tracks]):
                v = self.vxyz[i, :, dim]
                s = self.vxyz_sigma[i, :, dim]
                bands.append(
                    plt.fill_between(self.datetimes, y1=v + s, y2=v - s, **band_style)
                )
            out["sigma"] = bands
        return out

    def animate(
        self,
        track: int,
        obs: int = 0,
        frames: Iterable[int] = None,
        images: bool = None,
        particles: bool = None,
        map_size: Tuple[Number, Number] = (20, 20),
        img_size: Tuple[int, int] = (100, 100),
        subplots: dict = {},
        animation: dict = {},
    ):
        """Animate one track on a map panel and (optionally) an image panel."""
        import matplotlib.animation
        import matplotlib.pyplot as plt

        if images is None:
            images = self.tracker is not None
        if particles is None:
            particles = self.particles is not None and self.weights is not None
        ncols = 2 if images else 1
        fig, axes = plt.subplots(ncols=ncols, **subplots)
        if ncols == 1:
            axes = [axes]
        if frames is None:
            frames = np.arange(len(self.datetimes))
        has_frame = np.where(
            ~np.isnan(self.xyz[track, :, 0])
            & (np.not_equal(self.images[:, obs], None) if self.images is not None
               else True)
        )[0]
        frames = np.intersect1d(frames, has_frame)
        i = frames[0]
        track_xyz = self.xyz[track, : (i + 1)]
        map_track = axes[0].plot(
            track_xyz[:, 0], track_xyz[:, 1], color="black", marker="."
        )[0]
        artists = {"map_track": map_track}
        if images:
            img = self.images[i, obs]
            observer = self.tracker.observers[obs]
            track_uv = observer.xyz_to_uv(track_xyz, img=img)
            artists["image_track"] = axes[1].plot(
                track_uv[:, 0], track_uv[:, 1], color="black", marker="."
            )[0]
            box = observer.tile_box(track_uv[-1], size=img_size, img=img)
            tile = observer.extract_tile(img=img, box=box)
            artists["image_tile"] = observer.plot_tile(tile=tile, box=box, axes=axes[1])

        def update(i: int) -> tuple:
            track_xyz = self.xyz[track, : (i + 1)]
            artists["map_track"].set_data(track_xyz[:, 0], track_xyz[:, 1])
            axes[0].set_xlim(
                track_xyz[-1, 0] - map_size[0] / 2, track_xyz[-1, 0] + map_size[0] / 2
            )
            axes[0].set_ylim(
                track_xyz[-1, 1] - map_size[1] / 2, track_xyz[-1, 1] + map_size[1] / 2
            )
            if images:
                img = self.images[i, obs]
                observer = self.tracker.observers[obs]
                track_uv = observer.xyz_to_uv(track_xyz, img=img)
                artists["image_track"].set_data(track_uv[:, 0], track_uv[:, 1])
                box = observer.tile_box(track_uv[-1], size=img_size, img=img)
                tile = observer.extract_tile(img=img, box=box)
                artists["image_tile"].set_data(tile)
                artists["image_tile"].set_extent((box[0], box[2], box[3], box[1]))
            return tuple(artists.values())

        return matplotlib.animation.FuncAnimation(
            fig, update, frames=frames[:-1], blit=True, **animation
        )
