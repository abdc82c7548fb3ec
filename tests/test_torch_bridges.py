"""The host bridges of the port's batched tracker against the JAX package's:
``DeviceRaster.from_raster``, ``BatchMotion.from_motions``,
``BatchTracker.from_observers`` (and a host ``Raster`` as ``viewshed=``),
``feeder.stream_track`` and ``to_tracks``; then the slice as a whole, the
oblique 3-D recipe from objects to ``Tracks`` through both packages.

What a bridge builds (camera vectors, corrections, sigmas, motion tensors,
raster fields) must equal the reference's fields bit for bit. ``to_tracks``
on the same outputs gives equal arrays and the same ``errors`` pattern.
Tracking is held as in ``tests/test_torch_observers.py``: every step from
the reference's carried state within 1e-3.
"""
import dataclasses
import datetime
import inspect
import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

import glimpse_tpu
import glimpse_tpu_torch
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu.track import feeder as jax_feeder
from glimpse_tpu_torch.track import batch, convert, feeder
from test_batch_tracker import make_motion, make_scene

DAY = datetime.timedelta(days=1)
T0 = datetime.datetime(2020, 1, 1)
JPG = Path(__file__).parent / "assets" / "AK10b_20141013_020336.JPG"
MOTION_FIELDS = ("xy", "xy_sigma", "v_mean", "v_sigma", "a_mean", "a_sigma", "slope_sigma")
RASTER_FIELDS = ("array", "x0", "y0", "dx", "dy")


def assert_rasters_equal(port: batch.DeviceRaster, ref) -> None:
    for k in RASTER_FIELDS:
        got, want = getattr(port, k), np.asarray(getattr(ref, k))
        assert got.dtype == torch.float32 and want.dtype == np.float32, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


def assert_motions_equal(port: batch.BatchMotion, ref) -> None:
    assert port.kind == ref.kind and port.use_dem_sigma == ref.use_dem_sigma
    for k in MOTION_FIELDS:
        got, want = getattr(port, k), np.asarray(getattr(ref, k))
        assert got.dtype == torch.float32 and got.shape == want.shape, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    assert_rasters_equal(port.dem, ref.dem)
    assert_rasters_equal(port.dem_sigma, ref.dem_sigma)


def dem_array(size=64, seed=0, scale=60.0):
    return scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=(size, size)), size / 27) * scale


@pytest.mark.parametrize("x,y", [((-200, 600), (600, -200)), ((499000.3, 501000.3), (6781000.7, 6779000.7))])
def test_from_raster_equals_reference_fields(x, y) -> None:
    """The origin and cell size are rounded to float32 as the reference
    rounds them: at UTM northings that moves the origin by up to 0.25 m
    (recorded in ROADMAP.md); the port holds the reference's numbers."""
    z = dem_array()
    z[3, 4] = np.nan
    ref = jax_batch.DeviceRaster.from_raster(glimpse_tpu.Raster(z, x=x, y=y))
    port = batch.DeviceRaster.from_raster(glimpse_tpu_torch.Raster(z, x=x, y=y), device="cpu")
    assert_rasters_equal(port, ref)
    xy = np.random.default_rng(1).uniform([x[0] + 50, y[1] + 50], [x[1] - 50, y[0] - 50], (3, 20, 2)).astype(np.float32)
    np.testing.assert_allclose(
        port.sample(torch.from_numpy(xy)).numpy(), np.asarray(ref.sample(jnp.asarray(xy))), atol=1e-3, rtol=0, equal_nan=True)
    if x[0] > 1e5:
        assert abs(float(port.y0) - y[0]) > 0.1  # the float32 origin is not the raster's


HOST_MOTIONS = {
    "cartesian": ("CartesianMotion", dict(
        dem_sigma=0.5, xy_sigma=(1, 1), vxyz=(1, 0.5, 0), vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01))),
    "cartesian_no_sigma": ("CartesianMotion", dict(xy_sigma=(1, 2), vxyz_sigma=(1, 1, 0))),
    "cylindrical": ("CylindricalMotion", dict(
        dem_sigma="raster", xy_sigma=(1, 1), vrthz=(2, 0.5, 0), vrthz_sigma=(0.5, 0.2, 0.05), arthz_sigma=(0.1, 0.02, 0.01))),
    "tangent": ("TangentCartesianMotion", dict(
        dem_sigma=0.3, xy_sigma=(1, 1), vxy=(1, 0.5), vxy_sigma=(1, 1), axy_sigma=(0.1, 0.1), slope_sigma=0.05)),
    "tangent_cylindrical": ("TangentCylindricalMotion", dict(
        dem_sigma=0.3, xy_sigma=(1, 1), vrth=(2, 0.5), vrth_sigma=(0.5, 0.2), arth_sigma=(0.1, 0.02), slope_sigma=0.07)),
}


def host_motions(pkg, name, points):
    cls, kwargs = HOST_MOTIONS[name]
    kwargs = dict(kwargs)
    dem = pkg.Raster(dem_array(), x=(-200, 600), y=(600, -200))
    if kwargs.get("dem_sigma") == "raster":
        kwargs["dem_sigma"] = pkg.Raster(0.2 + np.random.default_rng(2).random((64, 64)), x=(-200, 600), y=(600, -200))
    return [getattr(pkg.track, cls)(xy=p, time_unit=DAY, dem=dem, n=10, seed=i, **kwargs) for i, p in enumerate(points)]


@pytest.mark.parametrize("name", list(HOST_MOTIONS))
def test_from_motions_equals_reference_fields(name) -> None:
    points = np.random.default_rng(3).uniform(100, 300, (7, 2))
    ref = jax_batch.BatchMotion.from_motions(host_motions(glimpse_tpu, name, points))
    port = batch.BatchMotion.from_motions(host_motions(glimpse_tpu_torch, name, points), device="cpu")
    assert_motions_equal(port, ref)
    assert port.n_points == 7


def test_from_motions_refuses_mixed_models() -> None:
    points = np.zeros((2, 2))
    a = host_motions(glimpse_tpu_torch, "cartesian", points)
    b = host_motions(glimpse_tpu_torch, "tangent", points)
    with pytest.raises(ValueError, match="same class"):
        batch.BatchMotion.from_motions([a[0], b[1]], device="cpu")
    with pytest.raises(ValueError, match="same dem"):
        batch.BatchMotion.from_motions([a[0], host_motions(glimpse_tpu_torch, "cartesian", points)[1]], device="cpu")
    with pytest.raises(TypeError, match="Unsupported"):
        batch.BatchMotion.from_motions([glimpse_tpu_torch.track.Motion(xy=(0, 0), time_unit=DAY)], device="cpu")


def test_bridges_default_to_the_card() -> None:
    for fn in (batch.DeviceRaster.from_raster, batch.BatchMotion.from_motions, batch.BatchTracker.from_observers):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        raster = glimpse_tpu_torch.Raster(dem_array(8), x=(0, 8), y=(8, 0))
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            batch.DeviceRaster.from_raster(raster)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            batch.BatchMotion.from_motions(host_motions(glimpse_tpu_torch, "cartesian", np.zeros((2, 2))))


# ---- to_tracks ---- #


def outputs_with_failures(seed=0, t=6, n=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(t, n, 6, 6)).astype(np.float32)
    valid = np.ones((t, n), np.float32)
    valid[3:, 1] = 0.0
    valid[0:, 3] = 0.0
    return {
        "mean": rng.normal(size=(t, n, 6)).astype(np.float32), "sigma": rng.random((t, n, 6)).astype(np.float32),
        "covariance": a @ np.swapaxes(a, -1, -2), "valid": valid,
    }


@pytest.mark.parametrize("covariances", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_to_tracks_equals_reference(covariances, with_valid) -> None:
    outputs = outputs_with_failures()
    if not with_valid:
        del outputs["valid"]
    datetimes = [T0 + i * DAY for i in range(7)]
    want = jax_batch.to_tracks(datetimes, DAY, {k: jnp.asarray(v) for k, v in outputs.items()}, covariances=covariances)
    got = batch.to_tracks(datetimes, DAY, {k: torch.from_numpy(v) for k, v in outputs.items()}, covariances=covariances)
    assert isinstance(got, glimpse_tpu_torch.track.Tracks)
    assert np.isnan(got.means[:, 0]).all()
    for attr in ("means", "sigmas", "covariances", "xyz_sigma"):
        w, g = getattr(want, attr), getattr(got, attr)
        if w is None:
            assert g is None, attr
            continue
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_array_equal(g, w, err_msg=attr)
    assert (got.datetimes == want.datetimes).all() and got.time_unit == want.time_unit
    if with_valid:
        assert [type(e) for e in got.errors] == [type(e) for e in want.errors] == [type(None), ValueError, type(None), ValueError]
        assert [str(e) for e in got.errors] == [str(e) for e in want.errors]
        assert np.isnan(got.means[1, 4:]).all() and np.isfinite(got.means[1, 1:4]).all() and np.isnan(got.means[3]).all()
        np.testing.assert_array_equal(got.success, want.success)
    else:
        assert got.errors is None and want.errors is None
    # NumPy outputs are taken as tensors are.
    again = batch.to_tracks(datetimes, DAY, outputs, covariances=covariances)
    np.testing.assert_array_equal(again.means, got.means)


# ---- from_observers, stream_track ---- #


def nadir_observers(frames, cam_vector, sigma=0.15):
    """One observer per package over the same frames, as ``Image`` objects
    whose arrays are set."""
    out = []
    for pkg, camera in ((glimpse_tpu, None), (glimpse_tpu_torch, None)):
        images = []
        for i, frame in enumerate(frames):
            cam = convert.camera_from_numpy(cam_vector) if pkg is glimpse_tpu_torch else glimpse_tpu.Camera(
                imgsz=cam_vector[6:8], f=cam_vector[8:10], c=cam_vector[10:12], k=cam_vector[12:18], p=cam_vector[18:20],
                xyz=cam_vector[0:3], viewdir=cam_vector[3:6])
            image = pkg.Image(f"frame{i}.jpg", cam=cam, datetime=T0 + i * DAY)
            image.array = frame
            images.append(image)
        out.append(pkg.track.Observer(images, sigma=sigma))
    return out


def test_from_observers_equals_reference_fields() -> None:
    cam, frames, _ = make_scene(n_frames=3)
    ref_obs, port_obs = nadir_observers(frames, cam.to_array())
    ref_obs.images[0].cam.correction = port_obs.images[0].cam.correction = glimpse_tpu.Camera._normalize_correction(True)
    motion = make_motion(np.array([[250.0, 250.0], [240.0, 255.0]]))
    config = dict(n_particles=64, search_size=(31, 31))
    ref = jax_batch.BatchTracker.from_observers([ref_obs, ref_obs], motion, config=jax_batch.BatchConfig(**config))
    port = batch.BatchTracker.from_observers(
        [port_obs, port_obs], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
        config=batch.BatchConfig(**config), device="cpu",
    )
    assert port.camera_vectors.dtype == torch.float32
    np.testing.assert_array_equal(port.camera_vectors.numpy(), ref.camera_vectors)
    assert port.corrections == ref.corrections == [(6.3781e6, 0.13)] * 2
    assert port.sigmas == ref.sigmas == (0.15, 0.15)
    assert port.n_observers == ref.n_observers == 2 and port.config.n_particles == ref.config.n_particles == 64
    assert port.viewshed is None


def test_stream_track_with_the_feeder_follows_the_reference() -> None:
    """tests/test_batch_tracker.py:497's scene, raw arrays through the
    feeder. The feeders yield the same stacks; the port's ``stream_track``
    equals its own ``track`` bit for bit. A stream takes no injected draws
    in either package, so the two runs share none: the port's is held to
    the scene's truth within a pixel, the reference's to what its own test
    asks (finite means)."""
    cam, frames, _ = make_scene(n_frames=4)
    frames = frames.astype(np.float32)
    motion = make_motion(np.array([[250.0, 250.0]]))
    ref = jax_batch.BatchTracker(cam.to_array()[None], [None], [0.15], motion, jax_batch.BatchConfig(n_particles=128))
    port = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
        batch.BatchConfig(n_particles=128), device="cpu",
    )
    sequences = [[f for f in frames]]
    assert len(feeder.FrameFeeder(sequences, prefetch=2)) == len(jax_feeder.FrameFeeder(sequences, prefetch=2)) == 4
    for a, b in zip(feeder.FrameFeeder(sequences, prefetch=3), jax_feeder.FrameFeeder(sequences, prefetch=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="different lengths"):
        feeder.FrameFeeder([sequences[0], sequences[0][:2]])
    _, ref_out = jax_feeder.stream_track(ref, jax.random.PRNGKey(0), sequences, np.ones(3))
    state, out = feeder.stream_track(port, torch.Generator().manual_seed(0), sequences, np.ones(3))
    assert len(out) == len(ref_out) == 3 and state.step == 3
    _, tracked = port.track(torch.Generator().manual_seed(0), frames[:, None], np.ones(3))
    for i in range(3):
        assert torch.equal(out[i]["mean"], tracked["mean"][i])
    assert np.isfinite(np.asarray(ref_out[-1]["mean"])).all()
    # The texture moves (2, 1) a frame under a point that starts at (250, 250).
    np.testing.assert_allclose(out[-1]["mean"].numpy()[0, :2], [256.0, 253.0], atol=1.0, rtol=0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_load_frame_matches(dtype) -> None:
    rng = np.random.default_rng(6)
    rgb = (rng.random((20, 30, 3)) * 255).astype(dtype)
    np.testing.assert_allclose(feeder.load_frame(rgb), jax_feeder.load_frame(rgb), atol=1e-4, rtol=0)
    gray = rgb[..., 0]
    got = feeder.load_frame(gray)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_feeder.load_frame(gray))


def test_from_observers_bridge_on_the_jpeg(tmp_path) -> None:
    """tests/test_batch_tracker.py:514: a tracker built from host observers
    over three copies of a photograph keeps its point within 0.5."""
    pytest.importorskip("PIL")
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"f{i}.jpg")
        shutil.copy(JPG, paths[-1])
    cam_args = {"imgsz": (200, 134), "fmm": 20, "sensorsz": (23.6, 15.8), "xyz": (0, 0, 0), "viewdir": (0, 0, 0)}
    images = [glimpse_tpu_torch.Image(p, cam=dict(cam_args), datetime=T0 + i * DAY) for i, p in enumerate(paths)]
    ref_images = [glimpse_tpu.Image(p, cam=dict(cam_args), datetime=T0 + i * DAY) for i, p in enumerate(paths)]
    observer = glimpse_tpu_torch.track.Observer(images, sigma=0.3)
    np.testing.assert_array_equal(feeder.load_frame(images[0]), jax_feeder.load_frame(ref_images[0]))
    xyz = images[0].cam.uv_to_xyz(np.array([[100.0, 67.0]]), depth=50.0)
    np.testing.assert_allclose(xyz, ref_images[0].cam.uv_to_xyz(np.array([[100.0, 67.0]]), depth=50.0), atol=1e-12, rtol=0)
    motions = [glimpse_tpu_torch.track.CartesianMotion(
        xy=xyz[0, 0:2], time_unit=DAY, dem=float(xyz[0, 2]), dem_sigma=0.05, xy_sigma=(0.1, 0.1),
        vxyz_sigma=(0.05, 0.05, 0.05))]
    tracker = batch.BatchTracker.from_observers(
        [observer], batch.BatchMotion.from_motions(motions, device="cpu"),
        config=batch.BatchConfig(n_particles=64, search_size=(31, 31)), device="cpu",
    )
    ref_tracker = jax_batch.BatchTracker.from_observers(
        [glimpse_tpu.track.Observer(ref_images, sigma=0.3)],
        jax_batch.BatchMotion.from_motions([glimpse_tpu.track.CartesianMotion(
            xy=xyz[0, 0:2], time_unit=DAY, dem=float(xyz[0, 2]), dem_sigma=0.05, xy_sigma=(0.1, 0.1),
            vxyz_sigma=(0.05, 0.05, 0.05))]),
        config=jax_batch.BatchConfig(n_particles=64, search_size=(31, 31)),
    )
    np.testing.assert_array_equal(tracker.camera_vectors.numpy(), ref_tracker.camera_vectors)
    assert_motions_equal(tracker.motion, ref_tracker.motion)
    state, outputs = feeder.stream_track(tracker, torch.Generator().manual_seed(0), [observer.images], np.ones(2))
    np.testing.assert_allclose(outputs[-1]["mean"].numpy()[0, 0:2], xyz[0, 0:2], atol=0.5)
    tracks = batch.to_tracks(observer.datetimes, DAY, {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]})
    assert tracks.means.shape == (1, 3, 6) and tracks.errors[0] is None


def test_host_raster_as_viewshed_checks_the_start_as_the_reference() -> None:
    """tests/test_batch_tracker.py:1098's viewshed as a host ``Raster``: a
    start on a non-visible cell or outside the raster is refused through
    ``Raster.sample(order=0)``, and the device copy equals ``from_raster``."""
    vs_array = np.ones((50, 50), np.float32)
    vs_array[:, 26:] = 0.0
    ref_vs = glimpse_tpu.Raster(vs_array, x=(0, 500), y=(500, 0))
    port_vs = glimpse_tpu_torch.Raster(vs_array, x=(0, 500), y=(500, 0))
    cam = np.zeros((1, 20), np.float32)

    def build(points):
        motion = make_motion(np.array(points))
        reference = None
        try:
            reference = jax_batch.BatchTracker(cam, [None], [0.3], motion, viewshed=ref_vs)
        except ValueError as e:
            reference = e
        port_motion = convert.motion_from_numpy(dataclasses.asdict(motion), "cpu")
        try:
            return reference, batch.BatchTracker(cam, [None], [0.3], port_motion, device="cpu", viewshed=port_vs)
        except ValueError as e:
            return reference, e

    for points in ([[250.0, 200.0], [270.0, 250.0]], [[250.0, 200.0], [600.0, 250.0]]):
        reference, port = build(points)
        assert isinstance(reference, ValueError) and isinstance(port, ValueError)
        assert str(port) == str(reference)
    reference, port = build([[250.0, 200.0], [255.0, 250.0]])
    assert_rasters_equal(port.viewshed, jax_batch.DeviceRaster.from_raster(ref_vs))
    assert_rasters_equal(port.viewshed, reference.viewshed)


# ---- The slice as a whole: the oblique 3-D recipe, objects in, Tracks out ---- #

N_POINTS, N_PARTICLES, N_FRAMES = 16, 256, 5
VELOCITY = (1.2, 0.8)
SETTINGS = dict(n_particles=N_PARTICLES, search_size=(41, 41))


@pytest.fixture(scope="module")
def oblique():
    """examples/oblique_3d_tracking.py at a small size, built twice from the
    same arrays: a 160-cell DEM, a 160 x 120 camera pitched 35 degrees down,
    frames rendered by the port's ``project_dem`` and inpainted, an
    ``Observer`` of ``Image`` objects, the DEM's viewshed from the camera,
    host ``CartesianMotion`` models with a 0.5 DEM prior."""
    rng = np.random.default_rng(7)
    z = scipy.ndimage.gaussian_filter(rng.normal(size=(160, 160)), 6.0) * 60
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(160, 160)), 0.8) * 100
    cam_args = dict(imgsz=(160, 120), f=200, xyz=(200, -150, 260), viewdir=(0, -35, 0))
    points = rng.uniform([150, 170], [250, 260], size=(N_POINTS, 2))
    port_dem = glimpse_tpu_torch.Raster(z, x=(-200, 600), y=(600, -200))
    port_cam = glimpse_tpu_torch.Camera(**cam_args)
    frames = []
    for i in range(N_FRAMES):
        shifted = scipy.ndimage.shift(
            texture, (VELOCITY[1] * i / port_dem.d[1], VELOCITY[0] * i / port_dem.d[0]), order=1, mode="nearest")
        img = glimpse_tpu_torch.render.project_dem(port_cam, port_dem, values=shifted[..., None], scale_limits=(1, 8))[..., 0]
        idx = scipy.ndimage.distance_transform_edt(np.isnan(img), return_distances=False, return_indices=True)
        frames.append(img[tuple(idx)].astype(np.float32))
    sides = {}
    for name, pkg, bt in (("ref", glimpse_tpu, jax_batch), ("port", glimpse_tpu_torch, batch)):
        dem = pkg.Raster(z, x=(-200, 600), y=(600, -200))
        images = []
        for i, frame in enumerate(frames):
            image = pkg.Image(f"frame{i}.jpg", cam=pkg.Camera(**cam_args), datetime=T0 + i * DAY)
            image.array = frame
            images.append(image)
        observer = pkg.track.Observer(images, sigma=0.2)
        device = dict(device="cpu") if pkg is glimpse_tpu_torch else {}
        visible = dem.viewshed(cam_args["xyz"], **device)
        viewshed = pkg.Raster(visible.astype(np.float32), x=dem.xlim, y=dem.ylim)
        motions = [
            pkg.track.CartesianMotion(
                xy=p, time_unit=DAY, dem=dem, dem_sigma=0.5, n=N_PARTICLES, xy_sigma=(1.0, 1.0),
                vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01))
            for p in points
        ]
        motion = bt.BatchMotion.from_motions(motions, **device)
        sides[name] = dict(dem=dem, observer=observer, viewshed=viewshed, motion=motion, visible=visible)
    return sides, np.stack(frames), points


def oblique_draws(seed=11):
    rng = np.random.default_rng(seed)
    n, p, t = N_POINTS, N_PARTICLES, N_FRAMES
    return {
        "init": {"xy": rng.normal(size=(n, p, 2)).astype(np.float32), "z": rng.normal(size=(n, p)).astype(np.float32),
                 "v": rng.normal(size=(n, p, 3)).astype(np.float32)},
        "a": rng.normal(size=(t - 1, n, p, 3)).astype(np.float32),
        "resample_u": rng.random((t - 1, n)).astype(np.float32),
    }


def oblique_trackers(sides):
    ref, port = sides["ref"], sides["port"]
    by_objects = jax_batch.BatchTracker.from_observers([ref["observer"]], ref["motion"], config=jax_batch.BatchConfig(**SETTINGS))
    reference = jax_batch.BatchTracker(
        by_objects.camera_vectors, by_objects.corrections, by_objects.sigmas, ref["motion"],
        jax_batch.BatchConfig(**SETTINGS), viewshed=ref["viewshed"],
    )
    tracker = batch.BatchTracker.from_observers(
        [port["observer"]], port["motion"], config=batch.BatchConfig(**SETTINGS), device="cpu", viewshed=port["viewshed"])
    return reference, tracker


def test_oblique_objects_build_equal_trackers(oblique) -> None:
    sides, frames, points = oblique
    np.testing.assert_array_equal(sides["port"]["visible"], sides["ref"]["visible"])
    assert 0.3 < sides["port"]["visible"].mean() <= 1.0
    reference, tracker = oblique_trackers(sides)
    np.testing.assert_array_equal(tracker.camera_vectors.numpy(), reference.camera_vectors)
    assert tracker.corrections == reference.corrections == [None] and tracker.sigmas == reference.sigmas == (0.2,)
    assert_motions_equal(tracker.motion, reference.motion)
    assert_rasters_equal(tracker.viewshed, reference.viewshed)
    for a, b in zip(feeder.FrameFeeder([sides["port"]["observer"].images]), jax_feeder.FrameFeeder([sides["ref"]["observer"].images])):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (1, 120, 160) and a.dtype == np.float32


def test_oblique_each_step_from_carried_state(oblique) -> None:
    """Every step from the reference's carried state: outputs within 1e-3,
    the same validity, and at least 98 % of the resampled rows equal."""
    sides, frames, _ = oblique
    reference, tracker = oblique_trackers(sides)
    noise = oblique_draws()
    images = frames[:, None]
    ref_step = reference.step  # eager: its viewshed test reads host arrays
    state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    mine = tracker.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    np.testing.assert_allclose(mine.particles.numpy(), np.asarray(state.particles), atol=1e-3, rtol=0)
    np.testing.assert_allclose(mine.templates.numpy(), np.asarray(state.templates), atol=1e-3, rtol=0)
    for i in range(N_FRAMES - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        nxt, out = tracker.step(
            convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[1 + i]), torch.tensor(1.0),
            noise=step_noise)
        state, ref_out = ref_step(state, images[1 + i], np.float32(1.0), noise=step_noise)
        for k in ("mean", "sigma"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), atol=1e-3, rtol=0, err_msg=f"{k} {i}")
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))
        same = np.abs(nxt.particles.numpy() - np.asarray(state.particles)).max(-1) <= 1e-3
        assert same.mean() >= 0.98, (i, same.mean())


def test_oblique_objects_in_tracks_out(oblique) -> None:
    """The port's whole path at the small size: ``stream_track`` forward and
    backward, ``to_tracks``, ``reverse``, ``Tracks.from_multiple``; the
    fused tracks recover the scene's motion and stay within the DEM prior.
    The example asserts a median final position error under 0.5 m at f = 400
    over 10 frames; at f = 200 over 5 frames a pixel covers about 2.2 m of
    ground at the points' range of 440 m, and the bound is half of that."""
    sides, frames, points = oblique
    _, tracker = oblique_trackers(sides)
    port = sides["port"]
    datetimes = list(port["observer"].datetimes)
    runs = []
    for label, images in (("forward", port["observer"].images), ("backward", port["observer"].images[::-1])):
        _, outputs = feeder.stream_track(tracker, torch.Generator().manual_seed(11), [images], np.ones(N_FRAMES - 1, np.float32))
        stacked = {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}
        tracks = batch.to_tracks(datetimes if label == "forward" else datetimes[::-1], DAY, stacked)
        if label == "backward":
            tracks.reverse()
        assert all(e is None for e in tracks.errors)
        sign = 1 if label == "forward" else -1
        velocity = np.median(sign * tracks.vxyz[:, -1 if label == "forward" else 0, 0:2], axis=0)
        np.testing.assert_allclose(velocity, VELOCITY, atol=0.35)
        runs.append(tracks)
    fused = glimpse_tpu_torch.track.Tracks.from_multiple(runs, ignore_nan=True)
    assert fused.means.shape == (N_POINTS, N_FRAMES, 6)
    error = np.nanmedian(np.abs(fused.xyz[:, -1, 0:2] - (points + np.multiply(VELOCITY, N_FRAMES - 1))))
    assert error < 1.1, error
    z_error = np.nanmedian(np.abs(fused.xyz[:, -1, 2] - port["dem"].sample(fused.xyz[:, -1, 0:2], bounds_error=False)))
    assert z_error < 0.5, z_error
