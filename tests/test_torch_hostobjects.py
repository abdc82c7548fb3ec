"""The port's host motion models, ``Observer``, ``Tracks``, the RTS smoother
and the native feeder functions against the JAX package's.

All of these are NumPy on the host in both packages. The motion models get
the same ``numpy.random`` seed and must give the same particles bit for bit
(their DEM samples go through the port's tensor ops in the reference's
order of operations); ``Tracks`` and the smoother are held exactly; the
observer's spline tile sampling within 1e-9.
"""
import datetime

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import glimpse_tpu
import glimpse_tpu_torch
from glimpse_tpu import native as ref_native
from glimpse_tpu.track import smooth as ref_smooth
from glimpse_tpu_torch import native
from glimpse_tpu_torch.track import convert, smooth

DAY = datetime.timedelta(days=1)
T0 = datetime.datetime(2020, 1, 1)

MOTIONS = {
    "cartesian": ("CartesianMotion", dict(
        dem_sigma=0.5, xy_sigma=(1, 1), vxyz=(1, 0.5, 0), vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01))),
    "cartesian_raster_sigma": ("CartesianMotion", dict(
        dem_sigma="raster", xy_sigma=(1, 1), vxyz_sigma=(1.5, 1.5, 0.05), axyz=(0.01, 0, 0), axyz_sigma=(0.1, 0.1, 0.01))),
    "cartesian_no_sigma": ("CartesianMotion", dict(xy_sigma=(1, 1), vxyz_sigma=(1, 1, 0))),
    "cylindrical": ("CylindricalMotion", dict(
        dem_sigma=0.5, xy_sigma=(1, 1), vrthz=(2, 0.5, 0), vrthz_sigma=(0.5, 0.2, 0.05), arthz_sigma=(0.1, 0.02, 0.01))),
    "tangent": ("TangentCartesianMotion", dict(
        dem_sigma=0.3, xy_sigma=(1, 1), vxy=(1, 0.5), vxy_sigma=(1, 1), axy_sigma=(0.1, 0.1), slope_sigma=0.05)),
    "tangent_cylindrical": ("TangentCylindricalMotion", dict(
        dem_sigma=0.3, xy_sigma=(1, 1), vrth=(2, 0.5), vrth_sigma=(0.5, 0.2), arth_sigma=(0.1, 0.02), slope_sigma=0.05)),
}


def dem_arrays():
    rng = np.random.default_rng(0)
    z = scipy.ndimage.gaussian_filter(rng.normal(size=(64, 64)), 4) * 60
    return z, 0.2 + rng.random((64, 64))


def build(pkg, name, seed=3, n=200):
    cls, kwargs = MOTIONS[name]
    z, sigma = dem_arrays()
    kwargs = dict(kwargs)
    if kwargs.get("dem_sigma") == "raster":
        kwargs["dem_sigma"] = pkg.Raster(sigma, x=(-200, 600), y=(600, -200))
    dem = pkg.Raster(z, x=(-200, 600), y=(600, -200))
    return getattr(pkg.track, cls)(xy=(210.0, 190.0), time_unit=DAY, dem=dem, n=n, seed=seed, **kwargs)


@pytest.mark.parametrize("name", list(MOTIONS))
def test_host_motion_same_seed_same_particles(name) -> None:
    ref, port = build(glimpse_tpu, name), build(glimpse_tpu_torch, name)
    want, got = ref.initialize_particles(), port.initialize_particles()
    assert got.shape == (200, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for dt in (DAY, DAY / 2, 3 * DAY):
        ref.evolve_particles(want, dt)
        port.evolve_particles(got, dt)
        np.testing.assert_array_equal(got, want)
    ll_want, ll_got = ref.compute_log_likelihoods(want), port.compute_log_likelihoods(got)
    if ll_want is None:
        assert ll_got is None
    else:
        np.testing.assert_array_equal(ll_got, ll_want)


@pytest.mark.parametrize("name", list(MOTIONS))
def test_host_motion_from_the_reference_fields(name) -> None:
    """``convert.host_motion_from_numpy`` rebuilds a reference model from its
    attributes as plain data, generator state included: from a model that
    has already drawn, both go on with the same numbers."""
    ref = build(glimpse_tpu, name)
    ref.initialize_particles()  # advance the generator
    fields = dict(vars(ref))
    for key in ("dem", "dem_sigma"):
        raster = fields.get(key)
        if raster is not None:
            fields[key] = dict(array=raster.array, xlim=raster.xlim, ylim=raster.ylim)
    kind = {"CartesianMotion": "cartesian", "CylindricalMotion": "cylindrical",
            "TangentCartesianMotion": "tangent", "TangentCylindricalMotion": "tangent_cylindrical"}[MOTIONS[name][0]]
    port = convert.host_motion_from_numpy(kind, fields)
    assert type(port).__name__ == type(ref).__name__ and type(port).__module__.startswith("glimpse_tpu_torch")
    np.testing.assert_array_equal(port.initialize_particles(), ref.initialize_particles())


def test_base_motion_matches() -> None:
    ref = glimpse_tpu.track.Motion(xy=(1, 2), time_unit=DAY, n=50, vxyz_sigma=(1, 2, 0.1), seed=5)
    port = glimpse_tpu_torch.track.Motion(xy=(1, 2), time_unit=DAY, n=50, vxyz_sigma=(1, 2, 0.1), seed=5)
    want, got = ref.initialize_particles(), port.initialize_particles()
    ref.evolve_particles(want, 2 * DAY)
    port.evolve_particles(got, 2 * DAY)
    np.testing.assert_array_equal(got, want)
    assert port.compute_log_likelihoods(got) is None


# ---- Observer ---- #


def observers(n=4, size=(48, 36)):
    rng = np.random.default_rng(1)
    frames = [scipy.ndimage.gaussian_filter(rng.normal(size=size[::-1]), 1.5) * 50 for _ in range(n)]
    out = []
    for pkg in (glimpse_tpu, glimpse_tpu_torch):
        images = []
        for i, frame in enumerate(frames):
            image = pkg.Image(f"frame{i}.jpg", cam=pkg.Camera(imgsz=size, f=60, xyz=(0, 0, 10), viewdir=(0, -90, 0)),
                              datetime=T0 + i * DAY)
            image.array = frame
            images.append(image)
        out.append(pkg.track.Observer(images, sigma=0.2))
    return out


def test_observer_tiles_match() -> None:
    ref, port = observers()
    assert port.sigma == ref.sigma and (port.datetimes == ref.datetimes).all()
    assert port.index(T0 + 2 * DAY) == ref.index(T0 + 2 * DAY) == 2
    with pytest.raises(ValueError, match="out of range"):
        port.index(T0 + DAY / 2)
    xyz = np.array([[1.0, 2.0, 0.0], [-2.0, 1.0, 0.5]])
    np.testing.assert_allclose(port.xyz_to_uv(xyz, img=1), ref.xyz_to_uv(xyz, img=1), atol=1e-12, rtol=0)
    uv = (20.3, 15.8)
    box_r, box_p = ref.tile_box(uv, (15, 11), img=0), port.tile_box(uv, (15, 11), img=0)
    np.testing.assert_array_equal(box_p, box_r)
    tile_r, tile_p = ref.extract_tile(box_r, img=0), port.extract_tile(box_p, img=0)
    np.testing.assert_array_equal(tile_p, tile_r)
    duv = (0.3, -0.45)
    np.testing.assert_allclose(port.shift_tile(tile_p, duv), ref.shift_tile(tile_r, duv), atol=1e-9, rtol=0)
    np.testing.assert_allclose(port.shift_tile(tile_p, duv, kx=1, ky=1), ref.shift_tile(tile_r, duv, kx=1, ky=1), atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="0.5"):
        port.shift_tile(tile_p, (0.6, 0))
    pts = np.random.default_rng(2).uniform(box_p[0:2] + 1.0, box_p[2:4] - 1.0, (30, 2))
    np.testing.assert_allclose(port.sample_tile(pts, tile_p, box_p), ref.sample_tile(pts, tile_r, box_r), atol=1e-9, rtol=0)
    gu, gv = np.linspace(box_p[0] + 1, box_p[2] - 1, 7), np.linspace(box_p[1] + 1, box_p[3] - 1, 5)
    np.testing.assert_allclose(
        port.sample_tile((gu, gv), tile_p, box_p, grid=True), ref.sample_tile((gu, gv), tile_r, box_r, grid=True),
        atol=1e-9, rtol=0,
    )
    with pytest.raises(ValueError, match="outside box"):
        port.sample_tile(np.array([[0.0, 0.0]]), tile_p, box_p)


def test_observer_subset_split_and_checks() -> None:
    ref, port = observers(n=6)
    sub_r = ref.subset(start=T0 + DAY, end=T0 + 4 * DAY)
    sub_p = port.subset(start=T0 + DAY, end=T0 + 4 * DAY)
    assert (sub_p.datetimes == sub_r.datetimes).all() and sub_p.sigma == port.sigma
    assert [len(o.images) for o in port.split(2)] == [len(o.images) for o in ref.split(2)]
    port.clear_images()
    assert all(image.array is None for image in port.images)
    with pytest.raises(ValueError, match="two or greater"):
        glimpse_tpu_torch.track.Observer(port.images[:1])
    with pytest.raises(ValueError, match="strictly increasing"):
        glimpse_tpu_torch.track.Observer(port.images[::-1])


# ---- Tracks ---- #


def track_arrays(seed=0, n=5, t=7):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, t, 6)).cumsum(axis=1)
    sigmas = 0.1 + rng.random((n, t, 6))
    means[1, 4:] = np.nan
    sigmas[1, 4:] = np.nan
    means[:, 0] = np.nan
    sigmas[:, 0] = np.nan
    a = rng.normal(size=(n, t, 6, 6))
    covariances = a @ np.swapaxes(a, -1, -2)
    errors = np.full(n, None, dtype=object)
    errors[1] = ValueError("failed")
    return means, sigmas, covariances, errors


def both_tracks(seed=0, covariances=False):
    means, sigmas, cov, errors = track_arrays(seed)
    datetimes = np.array([T0 + i * DAY for i in range(means.shape[1])])
    kwargs = dict(covariances=cov) if covariances else dict(sigmas=sigmas)
    return [
        pkg.track.Tracks(datetimes=datetimes.copy(), time_unit=DAY, means=means.copy(), errors=errors.copy(), **{
            k: v.copy() for k, v in kwargs.items()})
        for pkg in (glimpse_tpu, glimpse_tpu_torch)
    ]


def assert_tracks_equal(port, ref) -> None:
    for attr in ("means", "sigmas", "covariances", "xyz", "vxyz", "xyz_sigma", "vxyz_sigma", "success"):
        want, got = getattr(ref, attr), getattr(port, attr)
        if want is None:
            assert got is None, attr
        else:
            np.testing.assert_array_equal(got, want, err_msg=attr)
    assert (port.datetimes == ref.datetimes).all()
    for a, b in zip(port.endpoints, ref.endpoints):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("covariances", [False, True])
def test_tracks_properties_and_reverse_match(covariances) -> None:
    ref, port = both_tracks(covariances=covariances)
    assert_tracks_equal(port, ref)
    assert port.success.tolist() == [True, False, True, True, True]
    ref.reverse()
    port.reverse()
    assert_tracks_equal(port, ref)


@pytest.mark.parametrize("ignore_nan", [False, True])
def test_tracks_from_multiple_matches(ignore_nan) -> None:
    ref_a, port_a = both_tracks(seed=0)
    ref_b, port_b = both_tracks(seed=1)
    ref_b.reverse(), port_b.reverse()
    ref_b.reverse(), port_b.reverse()
    want = glimpse_tpu.track.Tracks.from_multiple([ref_a, ref_b], ignore_nan=ignore_nan)
    got = glimpse_tpu_torch.track.Tracks.from_multiple([port_a, port_b], ignore_nan=ignore_nan)
    assert_tracks_equal(got, want)
    for a, b in zip(port_a.average(ignore_nan=True), ref_a.average(ignore_nan=True)):
        np.testing.assert_array_equal(a, b)


# ---- Smoother and native feeder functions ---- #


def test_rts_smooth_matches() -> None:
    rng = np.random.default_rng(4)
    T, N = 12, 3
    means = rng.normal(size=(T, N, 6)).cumsum(axis=0)
    a = rng.normal(size=(T, N, 6, 6)) * 0.3
    covs = a @ np.swapaxes(a, -1, -2) + np.eye(6) * 0.05
    dts = np.full(T - 1, 1.0)
    a_sigma = np.array([0.1, 0.1, 0.01])
    np.testing.assert_array_equal(smooth.transition_matrix(0.5), ref_smooth.transition_matrix(0.5))
    np.testing.assert_array_equal(smooth.process_noise(0.5, a_sigma), ref_smooth.process_noise(0.5, a_sigma))
    want = ref_smooth.rts_smooth(means, covs, dts, a_sigma)
    got = smooth.rts_smooth(means, covs, dts, a_sigma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("backend", ["built", "numpy"])
def test_native_feeder_functions_match(backend, monkeypatch) -> None:
    """The port builds its own copy of the feeder source with g++ into
    ``build/`` (never loading the reference's library); with no library every
    entry point takes its NumPy path. Both are held to the reference's
    functions: exactly for the integer and copy paths, 1e-5 for float sums."""
    if backend == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_error", "disabled for this test")
        assert native.backend() == "numpy"
        with pytest.raises(RuntimeError, match="unavailable"):
            native.load(required=True)
    else:
        lib = native.load(required=True)
        assert lib is not None and native.backend() == "native", native._load_error
        path = native.library_path()
        assert path.exists() and path.parent.name == "glimpse_tpu_torch" and path.parent.parent.name == "build"
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    np.testing.assert_allclose(native.gray_f32(rgb), ref_native.gray_f32(rgb), atol=1e-4, rtol=0)
    image = rng.normal(size=(40, 52)).astype(np.float32)
    corners = np.array([[0, 0], [10, 20], [38, 50], [-3, 5]], dtype=np.int32)
    np.testing.assert_array_equal(
        native.extract_tiles_f32(image, corners, (7, 9)), ref_native.extract_tiles_f32(image, corners, (7, 9)))
    tiles = rng.normal(size=(5, 9, 9)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        native.normalize_tiles_f32(tiles.copy()), ref_native.normalize_tiles_f32(tiles.copy()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        native.median_highpass_f32(tiles, (5, 5)), ref_native.median_highpass_f32(tiles, (5, 5)), atol=1e-6, rtol=0)


RACE_WORKER = """
import importlib.util, pathlib, sys, time
spec = importlib.util.spec_from_file_location("feeder_native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.BUILD_DIR = pathlib.Path(sys.argv[2])
while time.time() < float(sys.argv[3]):
    pass
native.load(required=True)
print(native.library_path().name)
"""


def test_native_feeder_builds_once_under_concurrent_loads(tmp_path) -> None:
    """Eight processes call ``load(required=True)`` at the same moment
    against an empty build directory: all load the library, the compiler
    runs once (the others wait on the lock and find the finished file), and
    no partial file is left. ``CXX`` names a wrapper that logs each run."""
    import os
    import subprocess
    import sys
    import time

    log = tmp_path / "cxx.log"
    wrapper = tmp_path / "cxx.sh"
    wrapper.write_text(f'#!/bin/sh\necho run >> "{log}"\nexec g++ "$@"\n')
    wrapper.chmod(0o755)
    build = tmp_path / "build"
    source = native.__file__
    start = time.time() + 3.0
    env = dict(os.environ, CXX=str(wrapper))
    procs = [
        subprocess.Popen([sys.executable, "-c", RACE_WORKER, source, str(build), str(start)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(8)
    ]
    results = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == native.library_path().name
    assert log.read_text().count("run") == 1
    assert sorted(f.name for f in build.iterdir() if not f.name.endswith(".lock")) == [native.library_path().name]


def test_native_feeder_retries_after_a_failure_that_is_not_the_compilers(monkeypatch, tmp_path) -> None:
    """A build cut by its time limit is not remembered: the next call builds
    and loads. A compiler's refusal is remembered, and ``load(required=True)``
    raises with its text."""
    import subprocess

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    real_build = native._build
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise subprocess.TimeoutExpired("g++", 600)
        real_build(path)

    monkeypatch.setattr(native, "_build", flaky)
    with pytest.warns(UserWarning, match="TimeoutExpired"):
        assert native.load() is None
    assert native._load_error is None
    assert native.load(required=True) is not None and len(calls) == 2
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "other")

    def refuse(path):
        raise native._BuildError("g++ failed on feeder.cpp (1): no such thing")

    monkeypatch.setattr(native, "_build", refuse)
    with pytest.raises(RuntimeError, match="no such thing"), pytest.warns(UserWarning):
        native.load(required=True)
    assert "no such thing" in native._load_error
