"""Bayesian particle filter tracking world points through image sequences.

The counterpart of :class:`glimpse_tpu.track.Tracker`: one particle filter
per motion model, driven by SSE observation likelihoods with histogram
matching and median high-pass preprocessing, viewshed validity testing, four
resampling schemes, and per-track fault containment. It is the per-track
filter the batched tracker (:mod:`glimpse_tpu_torch.track.batch`) is
validated against.

Particles, weights, motion models, the ``numpy`` generator and resampling
stay on the host in float64. The likelihood pipeline (grayscale, normalize,
histogram match, high-pass, SSE map, spline sampling of the SSE surface at
the particles) runs on ``device``: in float64 on the CPU; in float32 on a
card, where the high-pass goes through the ``median_highpass`` kernel on a
(1, h, w) stack for every window the kernel covers, so once a template and
once a (track, step, observer). Templates are host arrays, so filter state
moves between trackers as NumPy.
"""
import copy
import datetime
import sys
import traceback
import warnings
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from .. import config, helpers
from ..kernels import highpass as highpass_kernel
from ..ops import imageproc, ncc, resampling
from ..ops import sampling as sampling_ops
from ..raster import Raster
from .motion import Motion
from .observer import Observer, _interp_order
from .tracks import Tracks

Number = Union[int, float]


class _TrackRecord:
    """Per-timestep storage for one track's filter outputs."""

    def __init__(
        self, n_times: int, n_particles: int, covariances: bool, particles: bool
    ) -> None:
        self.full_covariances = covariances
        self.keep_particles = particles
        self.means = np.full((n_times, 6), np.nan)
        spread_shape = (n_times, 6, 6) if covariances else (n_times, 6)
        self.spread = np.full(spread_shape, np.nan)
        if particles:
            self.particles = np.full((n_times, n_particles, 6), np.nan)
            self.weights = np.full((n_times, n_particles), np.nan)

    def __call__(self, i: int, filt: "Tracker") -> None:
        self.means[i] = filt.particle_mean
        if self.full_covariances:
            self.spread[i] = filt.particle_covariance
        else:
            self.spread[i] = filt.compute_particle_sigma(mean=self.means[i])
        if self.keep_particles:
            self.particles[i] = filt.particles
            self.weights[i] = filt.weights

    def results(self, error, noted_warnings, reduce_particles) -> list:
        out = [self.means, self.spread, error, noted_warnings]
        if reduce_particles:
            out.append(reduce_particles(self.particles, self.weights))
        elif self.keep_particles:
            out += [self.particles, self.weights]
        return out


class Tracker:
    """Estimate trajectories of world points through time.

    Attributes:
        observers: Image sequences (one per camera position).
        viewshed: Binary visibility raster; particles must fall on visible
            cells.
        resample_method: 'systematic' | 'stratified' | 'residual' | 'choice'.
        highpass: Median high-pass filter arguments ({'size': (ny, nx)}).
        interpolation: Spline order arguments ({'kx': k, 'ky': k}).
        device: Where the likelihood pipeline runs ('cuda' unless the caller
            asks for 'cpu').
        particles, weights, templates: Current filter state.
    """

    def __init__(
        self,
        observers: Iterable[Observer],
        viewshed: Raster = None,
        resample_method: str = "systematic",
        highpass: dict = {"size": (5, 5)},
        interpolation: dict = {"kx": 3, "ky": 3},
        seed: Optional[int] = None,
        record: str = "resampled",
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        # The likelihood's working type: the kernels' float32 on a card,
        # the host objects' float64 on the CPU.
        self.dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        torch.empty(0, device=self.device)  # raises on a host without the device
        self.observers = list(observers)
        self.viewshed = viewshed
        self.resample_method = resample_method
        self.highpass = highpass
        self.interpolation = interpolation
        self.rng = np.random.default_rng(seed)
        # 'resampled' records moments after resampling; 'posterior' records
        # them from the fresh likelihood weights, a lower-variance estimator.
        if record not in ("resampled", "posterior"):
            raise ValueError(f"record must be 'resampled' or 'posterior': {record}")
        self.record = record
        self.particles: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.templates: Optional[list] = None

    # ---- Particle statistics ---- #

    @property
    def particle_mean(self) -> np.ndarray:
        """Weighted particle mean (6,)."""
        return np.average(self.particles, weights=self.weights, axis=0)

    @property
    def particle_covariance(self) -> np.ndarray:
        """Weighted (biased) particle covariance (6, 6)."""
        return np.cov(self.particles.T, aweights=self.weights, ddof=0)

    def compute_particle_sigma(self, mean: Iterable[Number] = None) -> np.ndarray:
        """Weighted particle standard deviation (6,)."""
        if mean is None:
            mean = self.particle_mean
        variance = np.average(
            (self.particles - mean) ** 2, weights=self.weights, axis=0
        )
        return np.sqrt(variance)

    @property
    def datetimes(self) -> np.ndarray:
        """Sorted unique observation datetimes over all observers."""
        return np.unique(np.concatenate([obs.datetimes for obs in self.observers]))

    # ---- Filter steps ---- #

    def test_particles(self) -> None:
        """Raise if particles fall on non-visible viewshed cells or are NaN."""
        if np.isnan(self.particles).any():
            raise ValueError("Some particles have missing (NaN) values")
        if self.viewshed is None:
            return
        visibility = self.viewshed.sample(self.particles[:, 0:2], order=0)
        if (visibility <= 0).any():
            raise ValueError("Some particles are on non-visible viewshed cells")

    def initialize_weights(self) -> None:
        """Uniform initial weights."""
        self.weights = np.ones(len(self.particles))

    def update_weights(self, imgs: Iterable[Optional[int]], motion_model: Motion = None) -> None:
        """Multiply in observation likelihoods (all observers + motion prior)."""
        total = None

        def accumulate(term):
            nonlocal total
            if term is not None:
                total = term if total is None else total + term

        for obs, img in enumerate(imgs):
            accumulate(self.compute_observer_log_likelihoods(obs, img))
        if motion_model:
            accumulate(motion_model.compute_log_likelihoods(self.particles))
        if total is not None:
            self.weights = np.exp(-total) + 1e-300

    def resample_particles(self, method: str = None) -> None:
        """Prune unlikely particles, reproduce likely ones."""
        if method is None:
            method = self.resample_method
        indexes = resampling.resample_np(self.weights, method=method, rng=self.rng)
        self.particles = self.particles[indexes]
        self.weights = self.weights[indexes]

    # ---- Templates and likelihoods ---- #

    def _to_device(self, array) -> torch.Tensor:
        host_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        return torch.from_numpy(np.ascontiguousarray(array, dtype=host_dtype)).to(self.device)

    def _highpass(self, tile: torch.Tensor, size=(5, 5)) -> torch.Tensor:
        """Median high-pass of one tile: the kernel on a card for the windows
        it covers, the plain version otherwise (every window on the CPU in
        float64, and the even or over-49-tap windows on a card)."""
        if tile.is_cuda:
            return highpass_kernel.highpass(tile[None].contiguous(), size)[0]
        return imageproc.highpass(tile, size=size)

    def _prepare_tile(self, obs: int, img: int, box: Iterable[Number], histogram=None):
        """The tile pipeline on ``device``: (high-passed tile, CDF of the
        tile before the high-pass), both tensors."""
        tile = self._to_device(self.observers[obs].extract_tile(box=box, img=img))
        if histogram is not None:
            histogram = tuple(self._to_device(h) for h in histogram)
        return imageproc.prepare_tile(
            tile,
            cdf=histogram,
            highpass_size=tuple(self.highpass.get("size", (5, 5))),
            highpass=self._highpass,
        )

    def extract_tile(
        self,
        obs: int,
        img: int,
        box: Iterable[Number],
        histogram=None,
        return_histogram: bool = False,
    ):
        """Extract and preprocess an image tile.

        Grayscale -> mean-0/var-1 normalize -> optional histogram match ->
        median high-pass, computed on ``device`` and returned as host arrays.
        """
        tile, own = self._prepare_tile(obs, img, box, histogram)
        tile = tile.cpu().numpy()
        if return_histogram:
            return tile, tuple(h.cpu().numpy() for h in own)
        return tile

    def initialize_template(self, obs: int, img: int, tile_size: Iterable[int]) -> None:
        """Build an observer's template around the current particle mean."""
        if self.templates is None:
            self.templates = [None] * len(self.observers)
        observer = self.observers[obs]
        center_uv = observer.xyz_to_uv(self.particle_mean[None, 0:3], img=img).ravel()
        box = observer.tile_box(center_uv, size=tile_size, img=img)
        tile, histogram = self.extract_tile(
            obs=obs, img=img, box=box, return_histogram=True
        )
        box_center = box.reshape(2, 2).mean(axis=0)
        self.templates[obs] = {
            "obs": obs,
            "img": img,
            "box": box,
            "duv": center_uv - box_center,  # subpixel offset of the target
            "tile": tile,
            "histogram": histogram,
        }

    def compute_observer_log_likelihoods(self, obs: int, img: Optional[int]) -> Optional[np.ndarray]:
        """Per-particle negative log likelihood from one observer's image.

        Projects particles, extracts a histogram-matched search tile spanning
        them, computes the area-normalized SSE surface against the template,
        and spline-samples it at the projected particle positions.
        """
        if img is None:
            return None
        observer = self.observers[obs]
        template = self.templates[obs]
        size = np.asarray(template["tile"].shape[0:2][::-1])
        uv = observer.xyz_to_uv(self.particles[:, 0:3], img=img)
        box = self._search_box(uv, size)
        if not all(observer.images[img].inbounds(box.reshape(2, 2))):
            warnings.warn(
                "Particles too close to or beyond image bounds, skipping image"
            )
            return None
        search_tile, _ = self._prepare_tile(
            obs=obs, img=img, box=box, histogram=template["histogram"]
        )
        # The SSE map is taken in float32 whatever the working type: the
        # reference casts both tiles so, and that cast is part of its result.
        sse = ncc.sse_map(
            search_tile.to(torch.float32),
            self._to_device(template["tile"]).to(torch.float32),
        ).to(self.dtype)
        sse = sse / int(size.prod())
        # SSE surface extent: shrunk by template half-size minus half a pixel,
        # shifted by the template's subpixel offset.
        margin = size * 0.5 - 0.5
        sse_box = box + np.concatenate((margin, -margin)) + np.tile(template["duv"], 2)
        sampled = self._sample_tile(uv, sse, sse_box)
        return sampled / (2 * observer.sigma ** 2)

    def _sample_tile(self, uv: np.ndarray, tile: torch.Tensor, box: np.ndarray) -> np.ndarray:
        """:meth:`Observer.sample_tile` at points, for a tile on ``device``:
        the same box-to-index mapping, then :mod:`ops.sampling`."""
        if not np.all(helpers.in_box(uv, box)):
            raise ValueError("Some sampling points are outside box")
        order = _interp_order(self.interpolation)
        du = (box[2] - box[0]) / tile.shape[1]
        dv = (box[3] - box[1]) / tile.shape[0]
        cols = self._to_device((uv[:, 0] - box[0]) / du - 0.5)
        rows = self._to_device((uv[:, 1] - box[1]) / dv - 0.5)
        sampled = sampling_ops.sample_grid(tile, rows, cols, order=order)
        return sampled.double().cpu().numpy()

    def _search_box(self, uv: np.ndarray, template_size: np.ndarray) -> np.ndarray:
        """Integer search box spanning the particle cloud plus the template.

        The box is grown (when possible) so the SSE surface is at least as
        large as the spline-interpolation support.
        """
        half = template_size * 0.5
        lo = uv.min(axis=0) - half
        hi = uv.max(axis=0) + half
        support = np.array(
            [self.interpolation.get("ky", 3), self.interpolation.get("kx", 3)]
        )
        deficit = support - ((hi - lo) - template_size)
        grow = np.where(deficit > 0, deficit * 0.5, 0.0)
        lo, hi = lo - grow, hi + grow
        return np.concatenate((np.floor(lo), np.ceil(hi))).astype(int)

    # ---- Datetime matching ---- #

    def parse_datetimes(
        self,
        datetimes: Iterable[datetime.datetime],
        maxdt: datetime.timedelta = datetime.timedelta(0),
    ) -> np.ndarray:
        """Validate tracking datetimes (monotonic, unique, observer-matched)."""
        datetimes = np.asarray(datetimes)
        zero = datetime.timedelta(0)
        steps = np.diff(datetimes)
        ascending = not (steps < zero).any()
        descending = not (steps > zero).any()
        if not (ascending or descending):
            raise ValueError("Datetimes must be monotonic")
        unique = np.concatenate(([True], steps != zero))
        if not unique.all():
            warnings.warn("Dropping duplicate datetimes")
            datetimes = datetimes[unique]
        tolerance = abs(maxdt.total_seconds())
        gap_to_observers = helpers.pairwise_distance_datetimes(
            datetimes, self.datetimes
        ).min(axis=1)
        matched = gap_to_observers <= tolerance
        if not matched.all():
            warnings.warn("Dropping datetimes not matching any Observers")
            datetimes = datetimes[matched]
        if datetimes.size < 2:
            raise ValueError("Fewer than two valid datetimes")
        return datetimes

    def match_datetimes(
        self,
        datetimes: Iterable[datetime.datetime],
        maxdt: datetime.timedelta = datetime.timedelta(0),
    ) -> np.ndarray:
        """Image index (or None) for each (datetime, observer) pair.

        An entry is filled only when the observer's nearest image falls
        within ``maxdt`` of the requested datetime.
        """
        tolerance = abs(maxdt.total_seconds())
        table = np.full((len(datetimes), len(self.observers)), None)
        for j, observer in enumerate(self.observers):
            gaps = helpers.pairwise_distance_datetimes(
                datetimes, observer.datetimes
            )
            best = gaps.argmin(axis=1)
            within = gaps[np.arange(best.size), best] <= tolerance
            table[within, j] = best[within]
        return table

    # ---- Main loop ---- #

    def reset(self) -> None:
        """Clear the filter state."""
        self.particles = None
        self.weights = None
        self.templates = None

    def track(
        self,
        motion_models: Iterable[Motion],
        datetimes: Iterable[datetime.datetime] = None,
        maxdt: datetime.timedelta = datetime.timedelta(0),
        tile_size: Iterable[int] = (15, 15),
        observer_mask: np.ndarray = None,
        return_covariances: bool = False,
        return_particles: bool = False,
        reduce_particles: Callable[[np.ndarray, np.ndarray], Any] = None,
        parallel: Union[bool, int] = False,
    ) -> Tracks:
        """Track one particle filter per motion model.

        With multiple models, per-track errors and warnings are caught and
        stored in the result (fault containment) rather than aborting.
        """
        if reduce_particles:
            return_particles = True
        call_params = {
            "datetimes": datetimes, "maxdt": maxdt, "tile_size": tile_size,
            "observer_mask": observer_mask,
            "return_covariances": return_covariances,
            "return_particles": return_particles, "parallel": parallel,
        }
        motion_models = list(motion_models)
        time_units = {model.time_unit for model in motion_models}
        if len(time_units) > 1:
            raise ValueError("Motion models must have equal time units")
        self.reset()
        n_tracks = len(motion_models)
        n_workers = helpers._parse_parallel(parallel)
        if datetimes is None:
            datetimes = self.datetimes
        else:
            datetimes = self.parse_datetimes(datetimes=datetimes, maxdt=maxdt)
        if observer_mask is None:
            observer_mask = np.ones((n_tracks, len(self.observers)), dtype=bool)
        frame_table = self.match_datetimes(datetimes=datetimes, maxdt=maxdt)
        # First timestep at which each observer has a matching image: where
        # templates get (re)built.
        template_rows = np.not_equal(frame_table, None).argmax(axis=0)
        if n_tracks > 1:
            self._warm_image_caches(frame_table)
        steps = np.diff(datetimes)
        contain_faults = n_tracks > 1

        def job(motion_model: Motion, obs_mask: np.ndarray, clone: "Tracker") -> list:
            # Each job runs on a private Tracker clone (the reference relied
            # on fork isolation for its mutable filter state).
            record = _TrackRecord(
                n_times=len(datetimes),
                n_particles=motion_model.n,
                covariances=return_covariances,
                particles=return_particles,
            )
            error = None
            noted_warnings = None
            try:
                with warnings.catch_warnings(record=True) as noted:
                    clone._run_filter(
                        motion_model, obs_mask, frame_table, template_rows,
                        steps, tile_size, record,
                    )
                if noted:
                    noted_warnings = tuple(noted)
            except Exception as exc:
                if not contain_faults:
                    raise
                # Tracebacks don't pickle; store the formatted text.
                error = exc.__class__(
                    "".join(traceback.format_exception(*sys.exc_info()))
                )
            return record.results(error, noted_warnings, reduce_particles)

        clones = []
        for seed in self.rng.spawn(n_tracks):
            clone = copy.copy(self)
            clone.rng = seed
            clone.reset()
            clones.append(clone)
        with config.backend(np=n_workers) as pool:
            per_track = pool.map(
                func=job,
                star=True,
                sequence=tuple(zip(motion_models, observer_mask, clones)),
            )
        return self._assemble_tracks(
            per_track,
            datetimes=datetimes,
            time_unit=time_units.pop(),
            frame_table=frame_table,
            call_params=call_params,
            return_covariances=return_covariances,
            return_particles=return_particles,
            reduce_particles=reduce_particles,
        )

    def _warm_image_caches(self, frame_table: np.ndarray) -> None:
        """Pre-decode matched images so parallel jobs share warm caches."""
        for i, observer in enumerate(self.observers):
            if observer.cache:
                used = [img for img in frame_table[:, i] if img is not None]
                observer.cache_images(index=used)

    def _run_filter(
        self, motion_model, obs_mask, frame_table, template_rows, steps,
        tile_size, record,
    ) -> None:
        """Run the PF recurrence over the observed time span, recording each
        step into ``record``."""
        observed = np.not_equal(frame_table[:, obs_mask], None).any(axis=1)
        active = np.flatnonzero(observed)
        first, last = int(active[0]), int(active[-1])
        for i in range(first, last + 1):
            if i == first:
                self.particles = motion_model.initialize_particles()
            else:
                motion_model.evolve_particles(self.particles, dt=steps[i - 1])
            self.test_particles()
            if i == first:
                self.initialize_weights()
            for obs in np.flatnonzero(obs_mask & (template_rows == i)):
                self.initialize_template(
                    obs=obs, img=frame_table[i][obs], tile_size=tile_size
                )
            if i > first:
                imgs = [
                    img if keep else None
                    for img, keep in zip(frame_table[i], obs_mask)
                ]
                self.update_weights(imgs=imgs, motion_model=motion_model)
                if self.record == "posterior":
                    # Low-variance estimator: moments from the fresh
                    # likelihood weights, before resampling injects noise.
                    record(i, self)
                self.resample_particles()
            if self.record != "posterior" or i == first:
                record(i, self)

    def _assemble_tracks(
        self, per_track, datetimes, time_unit, frame_table, call_params,
        return_covariances, return_particles, reduce_particles,
    ) -> Tracks:
        columns = list(zip(*per_track))
        means, sigmas, errors, noted_warnings = columns[:4]
        kwargs = dict(
            time_unit=time_unit,
            datetimes=datetimes,
            means=means,
            tracker=self,
            images=frame_table,
            params=call_params,
            errors=errors,
            warnings=noted_warnings,
        )
        kwargs["covariances" if return_covariances else "sigmas"] = sigmas
        if return_particles and not reduce_particles:
            kwargs["particles"], kwargs["weights"] = columns[4:6]
        tracks = Tracks(**kwargs)
        if reduce_particles:
            tracks.reduced = list(columns[4])
        return tracks
