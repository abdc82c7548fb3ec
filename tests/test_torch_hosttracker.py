"""The port's host ``Tracker`` (``device="cpu"``, float64) against the JAX
package's, on the same frames, observers, motions and seeds.

The reference's host SSE map goes through OpenCV's ``matchTemplate`` in
float32 whenever ``cv2`` imports; the port always takes the direct sliding
sum on the same float32 tiles. The tight comparisons therefore hide ``cv2``
from the reference (``monkeypatch.setitem(sys.modules, "cv2", None)``), which
then takes its exact ``sse_map_numpy`` path; one test leaves ``cv2`` in and
states the looser bound.

Tolerances, with ``cv2`` hidden: the template and the search pipeline are
float64 on both sides (1e-12); the SSE map is a float32 sum whose order
differs between numpy's einsum and torch's (a few 1e-7 of its values), which
reaches the per-particle log likelihoods at about 1e-5 absolute (they are
SSE / (2 sigma^2), of the order of 10) and the weighted moments at 1e-6
relative. Each step is held so from the reference's carried state (particles,
weights, templates and generators copied across); whole runs to 2e-5, and
only on seeds that meet no near-tie in resampling.
"""
import copy
import datetime
import sys

import numpy as np
import pytest
import scipy.ndimage
import torch

import glimpse_tpu
import glimpse_tpu_torch

T0 = datetime.datetime(2020, 1, 1)
DAY = datetime.timedelta(days=1)
SIZE = 120
PACKAGES = {"jax": (glimpse_tpu, {}), "torch": (glimpse_tpu_torch, {"device": "cpu"})}


@pytest.fixture
def exact_sse(monkeypatch):
    """Hide OpenCV, so the reference's host SSE map is its NumPy sum."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def frames(n: int, shift=(2.0, 1.0), seed: int = 0, channels: int = 0):
    rng = np.random.default_rng(seed)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(SIZE, SIZE)), 0.8) * 100 + 100
    out = [scipy.ndimage.shift(base, (i * shift[1], i * shift[0]), order=1, mode="nearest") for i in range(n)]
    if channels:
        tint = np.linspace(0.8, 1.2, channels)
        out = [f[..., None] * tint for f in out]
    return out


def observer(pkg, n: int = 5, first: int = 0, sigma: float = 0.15, **kwargs):
    """Frames ``first``..``n - 1`` of a texture moving (2, 1) px a day."""
    images = [
        pkg.Raster(f, x=(0, SIZE), y=(SIZE, 0), datetime=T0 + i * DAY)
        for i, f in enumerate(frames(n, **kwargs)) if i >= first
    ]
    return pkg.Observer(images, sigma=sigma)


def motion(pkg, xy=(60.0, 60.0), n: int = 300, seed: int = 0, **kwargs):
    settings = dict(
        xy=xy, time_unit=DAY, dem=0.0, dem_sigma=None, n=n, xy_sigma=(2, 2), vxyz=(0, 0, 0), vxyz_sigma=(3, 3, 0),
        axyz_sigma=(0.25, 0.25, 0), seed=seed,
    )
    return pkg.CartesianMotion(**{**settings, **kwargs})


def trackers(n_frames: int = 5, seed: int = 7, two_observers: bool = False, tracker_args=None, **observer_args):
    """The same tracker in both packages: {"jax": ..., "torch": ...}."""
    out = {}
    for name, (pkg, device) in PACKAGES.items():
        observers = [observer(pkg, n_frames, **observer_args)]
        if two_observers:  # another texture, starting two days late, noisier
            observers.append(observer(pkg, n_frames, first=2, sigma=0.25, seed=1))
        out[name] = pkg.Tracker(observers, seed=seed, **(tracker_args or {}), **device)
    return out


def copy_state(source, target, source_motion=None, target_motion=None) -> None:
    """The filter state is NumPy in both packages: copy it across."""
    target.particles = None if source.particles is None else source.particles.copy()
    target.weights = None if source.weights is None else source.weights.copy()
    target.templates = copy.deepcopy(source.templates)
    target.rng.bit_generator.state = source.rng.bit_generator.state
    if source_motion is not None:
        target_motion.rng.bit_generator.state = source_motion.rng.bit_generator.state


def filter_step(tracker, model, i, first, table, mask, template_rows, steps, tile_size=(15, 15)):
    """One pass of ``Tracker._run_filter``'s loop body; returns the moments
    before resampling (None at the first step) and after."""
    if i == first:
        tracker.particles = model.initialize_particles()
    else:
        model.evolve_particles(tracker.particles, dt=steps[i - 1])
    tracker.test_particles()
    if i == first:
        tracker.initialize_weights()
    for obs in np.flatnonzero(mask & (template_rows == i)):
        tracker.initialize_template(obs=obs, img=table[i][obs], tile_size=tile_size)
    posterior = None
    if i > first:
        tracker.update_weights(imgs=[img if keep else None for img, keep in zip(table[i], mask)], motion_model=model)
        posterior = np.concatenate([tracker.particle_mean, tracker.compute_particle_sigma()])
        tracker.resample_particles()
    return posterior, np.concatenate([tracker.particle_mean, tracker.compute_particle_sigma()])


def assert_moments_close(got, want, rtol=1e-6) -> None:
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def assert_tracks_close(got, want, rtol=2e-5) -> None:
    """Whole runs: a weight that differs at float32 rounding moves a mean by
    that share of the particles' spread (a few units), so 2e-5."""
    assert got.means.shape == want.means.shape
    np.testing.assert_array_equal(np.isnan(got.means), np.isnan(want.means))
    np.testing.assert_allclose(got.means, want.means, rtol=rtol, atol=rtol, equal_nan=True)
    if want.sigmas is not None:
        np.testing.assert_allclose(got.sigmas, want.sigmas, rtol=rtol, atol=rtol, equal_nan=True)
    np.testing.assert_array_equal(got.datetimes, want.datetimes)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.success, want.success)


# ---- The likelihood pipeline from shared particles ---- #


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("highpass", [(5, 5), (3, 7), (4, 4)])
def test_template_and_likelihoods_from_shared_particles(exact_sse, channels, highpass) -> None:
    """Template within 1e-12; log likelihoods within 2e-5 absolute and 1e-6
    of their spread; the spline sampling of the port's tracker, on its
    device, equal to ``Observer.sample_tile`` within 1e-12."""
    both = trackers(tracker_args={"highpass": {"size": highpass}}, channels=channels)
    particles = motion(glimpse_tpu, n=400, seed=3).initialize_particles()
    results = {}
    for name, tracker in both.items():
        tracker.particles = particles.copy()
        tracker.initialize_weights()
        tracker.initialize_template(obs=0, img=0, tile_size=(15, 15))
        tracker.particles[:, 0:2] += (2.0, -1.0)
        results[name] = tracker.compute_observer_log_likelihoods(obs=0, img=1)
    got, want = both["torch"].templates[0], both["jax"].templates[0]
    assert got["tile"].shape == want["tile"].shape == (15, 15) and got["tile"].dtype == np.float64
    np.testing.assert_array_equal(got["box"], want["box"])
    np.testing.assert_allclose(got["duv"], want["duv"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["tile"], want["tile"], rtol=0, atol=1e-12)
    for a, b in zip(got["histogram"], want["histogram"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert results["torch"].shape == (400,) and results["torch"].dtype == np.float64
    spread = np.ptp(results["jax"])
    assert spread > 1.0
    np.testing.assert_allclose(results["torch"], results["jax"], rtol=0, atol=max(2e-5, 1e-6 * spread))
    assert both["torch"].compute_observer_log_likelihoods(obs=0, img=None) is None
    # The tracker's own sampling against the observer's, on one surface.
    tracker = both["torch"]
    surface = np.random.default_rng(1).normal(size=(9, 12))
    box = np.array([40.0, 50.0, 52.0, 59.0])
    uv = np.random.default_rng(2).uniform(box[:2], box[2:], size=(50, 2))
    sampled = tracker._sample_tile(uv, torch.from_numpy(surface), box)
    np.testing.assert_allclose(sampled, tracker.observers[0].sample_tile(uv, tile=surface, box=box, kx=3, ky=3), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="outside box"):
        tracker._sample_tile(uv + 100, torch.from_numpy(surface), box)


def test_extract_tile_equal_and_search_box(exact_sse) -> None:
    both = trackers(channels=3)
    box = np.array([40, 45, 71, 68])
    want, want_cdf = both["jax"].extract_tile(obs=0, img=1, box=box, return_histogram=True)
    got, got_cdf = both["torch"].extract_tile(obs=0, img=1, box=box, return_histogram=True)
    assert isinstance(got, np.ndarray) and got.shape == (23, 31)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    matched = both["torch"].extract_tile(obs=0, img=2, box=box, histogram=got_cdf)
    np.testing.assert_allclose(matched, both["jax"].extract_tile(obs=0, img=2, box=box, histogram=want_cdf), rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    for spread in (0.01, 0.5, 6.0):  # a cloud tighter than the spline support grows the box
        uv = rng.normal((60.3, 55.7), spread, size=(100, 2))
        np.testing.assert_array_equal(
            both["torch"]._search_box(uv, np.array([15, 15])), both["jax"]._search_box(uv, np.array([15, 15])))


# ---- Steps from the reference's carried state, and free runs ---- #


@pytest.mark.parametrize("method", ["systematic", "stratified", "residual", "choice"])
def test_every_step_from_the_carried_state(exact_sse, method) -> None:
    """Two observers, the second two days late, each step started from the
    reference's state: moments before and after resampling within 1e-6, the
    resampled particles within 1e-9 (the same source indices)."""
    both = trackers(n_frames=6, two_observers=True, tracker_args={"resample_method": method})
    models = {name: motion(pkg, seed=11) for name, (pkg, _) in PACKAGES.items()}
    ref, port = both["jax"], both["torch"]
    datetimes = ref.datetimes
    np.testing.assert_array_equal(port.datetimes, datetimes)
    table = ref.match_datetimes(datetimes)
    np.testing.assert_array_equal(port.match_datetimes(datetimes), table)
    template_rows = np.not_equal(table, None).argmax(axis=0)
    np.testing.assert_array_equal(template_rows, [0, 2])
    steps = np.diff(datetimes)
    mask = np.array([True, True])
    for i in range(len(datetimes)):
        copy_state(ref, port, models["jax"], models["torch"])
        want = filter_step(ref, models["jax"], i, 0, table, mask, template_rows, steps)
        got = filter_step(port, models["torch"], i, 0, table, mask, template_rows, steps)
        if i:
            assert_moments_close(got[0], want[0])
        assert_moments_close(got[1], want[1])
        np.testing.assert_allclose(port.particles, ref.particles, rtol=0, atol=1e-9)
    assert port.templates[1]["img"] == 0 and port.templates[1]["tile"].shape == (15, 15)


@pytest.mark.parametrize("highpass", [(4, 4), (2, 3), (9, 9)])
def test_a_step_at_windows_outside_the_kernels_domain(exact_sse, highpass) -> None:
    """Even and over-49-tap high-pass windows: one step from a carried
    state, as for the odd ones."""
    both = trackers(n_frames=3, tracker_args={"highpass": {"size": highpass}})
    models = {name: motion(pkg, seed=5) for name, (pkg, _) in PACKAGES.items()}
    table = both["jax"].match_datetimes(both["jax"].datetimes)
    args = (table, np.array([True]), np.array([0]), np.diff(both["jax"].datetimes))
    for i in range(3):
        copy_state(both["jax"], both["torch"], models["jax"], models["torch"])
        want = filter_step(both["jax"], models["jax"], i, 0, *args)
        got = filter_step(both["torch"], models["torch"], i, 0, *args)
        assert_moments_close(got[1], want[1])


def test_steps_with_a_template_thinner_than_half_the_window(exact_sse) -> None:
    """A template two columns wide (``tile_size=(2, 15)``, x first) under
    7 x 7 taps: fewer columns than the window's pad of three, so its padding
    reflects more than once (ROADMAP C13).
    The template within 1e-12 and the log likelihoods from shared particles
    within this file's bound (2e-5 absolute, 1e-6 of their spread); then
    each step from the reference's carried state, the moments after
    resampling within 1e-6, as for the windows outside the kernel's domain."""
    both = trackers(tracker_args={"highpass": {"size": (7, 7)}})
    particles = motion(glimpse_tpu, n=400, seed=3).initialize_particles()
    likelihoods = {}
    for name, tracker in both.items():
        tracker.particles = particles.copy()
        tracker.initialize_weights()
        tracker.initialize_template(obs=0, img=0, tile_size=(2, 15))
        tracker.particles[:, 0:2] += (2.0, -1.0)
        likelihoods[name] = tracker.compute_observer_log_likelihoods(obs=0, img=1)
    got, want = both["torch"].templates[0]["tile"], both["jax"].templates[0]["tile"]
    assert got.shape == want.shape == (15, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    spread = np.ptp(likelihoods["jax"])
    np.testing.assert_allclose(likelihoods["torch"], likelihoods["jax"], rtol=0, atol=max(2e-5, 1e-6 * spread))

    both = trackers(n_frames=4, tracker_args={"highpass": {"size": (7, 7)}})
    models = {name: motion(pkg, seed=9) for name, (pkg, _) in PACKAGES.items()}
    table = both["jax"].match_datetimes(both["jax"].datetimes)
    args = (table, np.array([True]), np.array([0]), np.diff(both["jax"].datetimes))
    for i in range(4):
        copy_state(both["jax"], both["torch"], models["jax"], models["torch"])
        want = filter_step(both["jax"], models["jax"], i, 0, *args, tile_size=(2, 15))
        got = filter_step(both["torch"], models["torch"], i, 0, *args, tile_size=(2, 15))
        assert_moments_close(got[1], want[1])


@pytest.mark.parametrize("record", ["resampled", "posterior"])
def test_free_run_equal(exact_sse, record) -> None:
    """Three tracks over five frames, every generator from the same seeds
    (seeds on which no resampling threshold lies within rounding of a
    cumulative weight): means and sigmas within 2e-5 at every step."""
    both = trackers(tracker_args={"record": record})
    tracks = {}
    for name, (pkg, _) in PACKAGES.items():
        models = [motion(pkg, xy=(60.0 + 5 * k, 60.0), n=500, seed=42 + k) for k in range(3)]
        tracks[name] = both[name].track(models, tile_size=(15, 15))
    assert_tracks_close(tracks["torch"], tracks["jax"])
    assert tracks["torch"].success.all()
    assert all(w is None for w in tracks["torch"].warnings) and all(w is None for w in tracks["jax"].warnings)
    velocity = tracks["torch"].means[:, -1, 3:5]
    np.testing.assert_allclose(velocity, np.tile((2.0, -1.0), (3, 1)), atol=0.75)
    assert tracks["torch"].tracker is both["torch"]
    assert tracks["torch"].params["tile_size"] == (15, 15)
    with pytest.raises(ValueError, match="record must be"):
        glimpse_tpu_torch.Tracker(both["torch"].observers, record="smoothed", device="cpu")


def test_free_run_with_cv2_in(monkeypatch) -> None:
    """The reference as users run it, through ``cv2.matchTemplate``: its
    float32 SSE differs from the direct sum by about 1e-5 of the map, which a
    free run of four steps carries to the means at 1e-3 px and px/day."""
    pytest.importorskip("cv2")
    both = trackers()
    tracks = {name: both[name].track([motion(pkg, n=500, seed=42)]) for name, (pkg, _) in PACKAGES.items()}
    assert_tracks_close(tracks["torch"], tracks["jax"], rtol=1e-3)


def test_two_observers_a_late_one_and_an_observer_mask(exact_sse) -> None:
    """Track 0 sees both observers (the second from day 2), track 1 only the
    first, track 2 only the late one, so it starts on day 2."""
    both = trackers(n_frames=6, two_observers=True)
    mask = np.array([[True, True], [True, False], [False, True]])
    tracks = {}
    for name, (pkg, _) in PACKAGES.items():
        models = [motion(pkg, xy=(58.0 + 4 * k, 62.0), seed=20 + k) for k in range(3)]
        tracks[name] = both[name].track(models, observer_mask=mask)
    assert_tracks_close(tracks["torch"], tracks["jax"])
    assert np.isnan(tracks["torch"].means[2, :2]).all() and np.isfinite(tracks["torch"].means[2, 2:]).all()
    assert np.isfinite(tracks["torch"].means[:2]).all()
    np.testing.assert_array_equal(tracks["torch"].images[:, 1], [None, None, 0, 1, 2, 3])


def test_covariances_particles_and_reduce(exact_sse) -> None:
    both = trackers(n_frames=3)
    out = {}
    for name, (pkg, _) in PACKAGES.items():
        full = both[name].track([motion(pkg, n=100, seed=1)], return_covariances=True, return_particles=True)
        reduced = both[name].track(
            [motion(pkg, n=100, seed=1), motion(pkg, n=100, seed=2)],
            reduce_particles=lambda particles, weights: np.nanmax(particles[..., 0] * weights, axis=1),
        )
        out[name] = (full, reduced)
    (full, reduced), (want_full, want_reduced) = out["torch"], out["jax"]
    assert full.covariances.shape == (1, 3, 6, 6) and full.sigmas is None
    assert full.particles.shape == (1, 3, 100, 6) and full.weights.shape == (1, 3, 100)
    np.testing.assert_allclose(full.covariances, want_full.covariances, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(full.particles, want_full.particles, rtol=0, atol=1e-9)
    np.testing.assert_allclose(full.weights, want_full.weights, rtol=1e-4, atol=1e-300)
    np.testing.assert_allclose(full.means, want_full.means, rtol=2e-5, atol=2e-5)
    assert reduced.particles is None and len(reduced.reduced) == 2 and reduced.reduced[0].shape == (3,)
    for a, b in zip(reduced.reduced, want_reduced.reduced):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("parallel", [False, 3])
def test_parallel_both_ways(exact_sse, parallel) -> None:
    """Each track has its own clone and generators, so threads change
    nothing: the port's run equals its serial run exactly, and the
    reference's within 2e-5."""
    both = trackers(n_frames=3)
    models = {name: [motion(pkg, xy=(55.0 + 5 * k, 60.0), n=200, seed=k) for k in range(3)] for name, (pkg, _) in PACKAGES.items()}
    got = both["torch"].track(models["torch"], parallel=parallel)
    assert_tracks_close(got, both["jax"].track(models["jax"], parallel=parallel))
    serial = trackers(n_frames=3)["torch"].track([motion(glimpse_tpu_torch, xy=(55.0 + 5 * k, 60.0), n=200, seed=k) for k in range(3)])
    np.testing.assert_array_equal(got.means, serial.means)
    assert got.params["parallel"] == parallel and both["torch"].particles is None


# ---- Errors and warnings ---- #


def last_line(error) -> str:
    return str(error).strip().splitlines()[-1]


def test_the_same_errors_and_warnings_per_track(exact_sse) -> None:
    """A point outside the image, a NaN velocity, a point that drifts to the
    edge (a warning a step, no error) and a good one: each track's error
    class and message and its warnings equal in both packages; the stored
    error holds the formatted traceback."""
    both = trackers(n_frames=4)
    tracks = {}
    for name, (pkg, _) in PACKAGES.items():
        models = [
            motion(pkg, seed=0),
            motion(pkg, xy=(10000.0, 10000.0), seed=1),
            motion(pkg, vxyz=(np.nan, 0, 0), seed=2),
            motion(pkg, xy=(110.0, 60.0), vxyz=(6, 0, 0), vxyz_sigma=(0.1, 0.1, 0), xy_sigma=(0.5, 0.5), seed=3),
        ]
        tracks[name] = both[name].track(models)
    got, want = tracks["torch"], tracks["jax"]
    np.testing.assert_array_equal(got.success, [True, False, False, True])
    np.testing.assert_array_equal(got.success, want.success)
    for a, b in zip(got.errors, want.errors):
        assert type(a) is type(b)
        if a is not None:
            assert last_line(a) == last_line(b)
            assert "Traceback (most recent call last)" in str(a) and "_run_filter" in str(a)
    assert "missing (NaN) values" in str(got.errors[2])
    for a, b in zip(got.warnings, want.warnings):
        assert (a is None) == (b is None)
        if a is not None:
            assert [str(w.message) for w in a] == [str(w.message) for w in b]
    assert got.warnings[0] is None and "beyond image bounds" in str(got.warnings[3][0].message)
    assert_tracks_close(got, want)


def test_a_single_track_raises_its_error(exact_sse) -> None:
    for name, (pkg, _) in PACKAGES.items():
        tracker = trackers(n_frames=3)[name]
        with pytest.raises(ValueError, match="missing"):
            tracker.track([motion(pkg, vxyz=(np.nan, 0, 0))])
        with pytest.raises(ValueError, match="equal time units"):
            tracker.track([motion(pkg), motion(pkg, time_unit=2 * DAY)])


def test_viewshed_validation(exact_sse) -> None:
    """Particles on a non-visible viewshed cell: the same error; an
    all-visible viewshed changes nothing."""
    errors, runs = {}, {}
    for name, (pkg, device) in PACKAGES.items():
        obs = observer(pkg, 3)
        hidden = pkg.Raster(np.zeros((SIZE, SIZE)), x=(0, SIZE), y=(SIZE, 0))
        with pytest.raises(ValueError) as caught:
            pkg.Tracker([obs], viewshed=hidden, seed=0, **device).track([motion(pkg, n=50)])
        errors[name] = str(caught.value)
        half = np.ones((SIZE, SIZE))
        half[:, 70:] = 0
        split = pkg.Raster(half, x=(0, SIZE), y=(SIZE, 0))
        runs[name] = pkg.Tracker([obs], viewshed=split, seed=0, **device).track(
            [motion(pkg, xy=(40.0, 60.0), n=100, seed=4), motion(pkg, xy=(69.0, 60.0), n=100, seed=5)])
    assert errors["torch"] == errors["jax"] == "Some particles are on non-visible viewshed cells"
    np.testing.assert_array_equal(runs["torch"].success, [True, False])
    assert_tracks_close(runs["torch"], runs["jax"])
    assert "non-visible viewshed cells" in last_line(runs["torch"].errors[1])


# ---- Datetimes ---- #


def test_parse_and_match_datetimes(exact_sse) -> None:
    both = trackers(n_frames=6, two_observers=True)
    days = [T0 + k * DAY for k in range(6)]
    hour = datetime.timedelta(hours=1)
    cases = [
        (days, {}),
        (days[::-1], {}),
        ([days[0], days[1], days[1], days[3]], {}),  # a duplicate is dropped
        ([days[0], days[1] + hour, days[2], T0 + 9 * DAY], {}),  # unmatched ones are dropped
        ([days[0] + hour, days[1] - hour, days[4]], {"maxdt": 2 * hour}),
    ]
    for datetimes, kwargs in cases:
        parsed = {}
        for name, tracker in both.items():
            with pytest.warns(UserWarning) if datetimes not in (days, days[::-1]) and not kwargs else _no_warning():
                parsed[name] = tracker.parse_datetimes(datetimes, **kwargs)
        np.testing.assert_array_equal(parsed["torch"], parsed["jax"])
        np.testing.assert_array_equal(
            both["torch"].match_datetimes(parsed["torch"], **kwargs), both["jax"].match_datetimes(parsed["jax"], **kwargs))
    table = both["torch"].match_datetimes(days)
    np.testing.assert_array_equal(table[:, 0], range(6))
    np.testing.assert_array_equal(table[:, 1], [None, None, 0, 1, 2, 3])
    assert both["torch"].match_datetimes([days[0] + hour])[0, 0] is None
    for tracker in both.values():
        with pytest.raises(ValueError, match="monotonic"):
            tracker.parse_datetimes([days[0], days[2], days[1]])
        with pytest.raises(ValueError, match="Fewer than two"), pytest.warns(UserWarning):
            tracker.parse_datetimes([days[0], T0 + 9 * DAY])


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def test_tracking_on_given_datetimes(exact_sse) -> None:
    """Every other day, one of them off by an hour within ``maxdt``."""
    both = trackers(n_frames=6)
    wanted = [T0, T0 + 2 * DAY + datetime.timedelta(hours=1), T0 + 4 * DAY]
    tracks = {
        name: both[name].track([motion(pkg, seed=8)], datetimes=wanted, maxdt=datetime.timedelta(hours=2))
        for name, (pkg, _) in PACKAGES.items()
    }
    assert tracks["torch"].means.shape == (1, 3, 6)
    assert_tracks_close(tracks["torch"], tracks["jax"])
    np.testing.assert_array_equal(tracks["torch"].images[:, 0], [0, 2, 4])


# ---- The device ---- #


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card")
def test_the_default_device_needs_a_card() -> None:
    with pytest.raises((RuntimeError, AssertionError)):
        glimpse_tpu_torch.Tracker([observer(glimpse_tpu_torch, 3)])


def test_state_and_moments_are_host_float64(exact_sse) -> None:
    tracker = trackers(n_frames=3)["torch"]
    assert tracker.device == torch.device("cpu") and tracker.dtype == torch.float64
    tracker.particles = motion(glimpse_tpu_torch, n=50).initialize_particles()
    tracker.initialize_weights()
    tracker.weights[:] = np.arange(1, 51)
    np.testing.assert_allclose(tracker.particle_mean, np.average(tracker.particles, weights=tracker.weights, axis=0))
    np.testing.assert_allclose(np.sqrt(np.diag(tracker.particle_covariance)), tracker.compute_particle_sigma())
    tracker.reset()
    assert tracker.particles is None and tracker.weights is None and tracker.templates is None
