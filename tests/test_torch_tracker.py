"""The port's batched tracker in lockstep with the reference's, on the CPU.

Both trackers get the same scene, motion and injected draws. The reference
runs its XLA high-pass (bit-equal to its Pallas one) and its merge-rank
resample (ties to the right, the port's to the left; no threshold lands on
a slot in these runs). What differs is float32 rounding in sums and
transcendental functions, so the first step is held to 1e-3 and the
trajectory to 1e-2, the tolerance of the reference's own Pallas-against-XLA
test (tests/test_batch_tracker.py:141).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.track import batch, convert
from test_batch_tracker import make_motion, make_scene

N, P, T = 8, 256, 6
SIZES = dict(template_size=(15, 15), search_size=(41, 41))


@pytest.fixture(scope="module")
def scene():
    cam, frames, _ = make_scene(n_frames=T, velocity=(2.0, 1.0))
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(N, 2))
    rng = np.random.default_rng(5)
    noise = {
        "init": {
            "xy": rng.normal(size=(N, P, 2)).astype(np.float32),
            "v": rng.normal(size=(N, P, 3)).astype(np.float32),
        },
        "a": rng.normal(size=(T - 1, N, P, 3)).astype(np.float32),
        "resample_u": rng.random((T - 1, N)).astype(np.float32),
    }
    jax_motion = make_motion(points_xy)
    reference = jax_batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], jax_motion, jax_batch.BatchConfig(n_particles=P, **SIZES)
    )
    port = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15],
        convert.motion_from_numpy(dataclasses.asdict(jax_motion), "cpu"),
        batch.BatchConfig(n_particles=P, **SIZES), device="cpu",
    )
    return frames[:, None], noise, reference, port


def test_track_lockstep_with_reference(scene) -> None:
    images, noise, reference, port = scene
    dts = np.ones(T - 1)
    ref_state, ref_out = reference.track(jax.random.PRNGKey(0), images, dts, noise=noise)
    state, out = port.track(torch.Generator().manual_seed(0), images, dts, noise=noise)
    ref_mean = np.asarray(ref_out["mean"])
    mean = out["mean"].numpy()
    assert mean.shape == (T - 1, N, 6)
    np.testing.assert_allclose(state.templates.numpy(), np.asarray(ref_state.templates), atol=1e-5, rtol=0)
    np.testing.assert_allclose(state.template_table.numpy(), np.asarray(ref_state.template_table), atol=1e-5, rtol=0)
    np.testing.assert_allclose(state.template_duv.numpy(), np.asarray(ref_state.template_duv), atol=1e-3, rtol=0)
    np.testing.assert_allclose(mean[0], ref_mean[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(mean, ref_mean, atol=1e-2, rtol=0)
    np.testing.assert_allclose(out["sigma"].numpy(), np.asarray(ref_out["sigma"]), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))


def test_step_from_carried_reference_state(scene) -> None:
    """One step from the reference's own initial state, carried across by
    convert.state_from_numpy: the same moments, resampled particles and
    weights."""
    images, noise, reference, port = scene
    ref_state = jax.jit(reference.initialize)(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    step_noise = {"a": noise["a"][0], "resample_u": noise["resample_u"][0]}
    ref_next, ref_out = jax.jit(reference.step)(ref_state, images[1], np.float32(1.0), noise=step_noise)
    leaves = {f.name: np.asarray(getattr(ref_state, f.name)) for f in dataclasses.fields(ref_state) if f.name != "key"}
    state = convert.state_from_numpy(**leaves, device="cpu")
    nxt, out = port.step(state, torch.from_numpy(images[1]), torch.tensor(1.0), noise=step_noise)
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(ref_out["mean"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(nxt.particles.numpy(), np.asarray(ref_next.particles), atol=1e-3, rtol=0)
    np.testing.assert_allclose(nxt.weights.numpy(), np.asarray(ref_next.weights), rtol=1e-3, atol=1e-30)
    assert nxt.step == 1


def test_port_recovers_velocity() -> None:
    """Without injected draws, the port recovers a known texture velocity
    (as tests/test_batch_tracker.py:82-93 asks of the reference)."""
    velocity = (2.0, 1.0)
    cam, frames, _ = make_scene(n_frames=6, velocity=velocity)
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(8, 2))
    motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(points_xy)), "cpu")
    tracker = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], motion, batch.BatchConfig(n_particles=512, **SIZES), device="cpu"
    )
    _, out = tracker.track(torch.Generator().manual_seed(0), frames[:, None], np.ones(5))
    means = out["mean"].numpy()
    sigmas = out["sigma"].numpy()
    assert np.median(np.abs(means[-1, :, 3:5] - np.asarray(velocity))) < 0.5, means[-1, :, 3:5]
    dx = means[-1, :, 0] - points_xy[:, 0]
    assert np.median(np.abs(dx - velocity[0] * 5)) < 2.0, dx
    assert np.median(sigmas[-1, :, 0]) < 1.5


def test_motion_with_dem_sigma_matches_reference() -> None:
    """initialize (with "z" draws), evolve and the DEM-distance prior on a
    sloped DEM with a DEM sigma, against the reference: the same float32
    operations in the same order, so within a few ulps (rtol 1e-6)."""
    rng = np.random.default_rng(7)
    n, p = 6, 64
    yy, xx = np.mgrid[0:20, 0:30]
    raster = dict(x0=np.float32(0.0), y0=np.float32(200.0), dx=np.float32(10.0), dy=np.float32(-10.0))
    dem = dict(array=(0.5 * xx + 0.2 * yy + rng.normal(size=xx.shape)).astype(np.float32), **raster)
    dem_sigma = dict(array=rng.uniform(0.5, 2.0, xx.shape).astype(np.float32), **raster)
    fields = dict(
        kind="cartesian",
        xy=np.column_stack([rng.uniform(50, 250, n), rng.uniform(50, 150, n)]).astype(np.float32),
        xy_sigma=np.full((n, 2), 3.0, np.float32),
        v_mean=rng.normal(size=(n, 3)).astype(np.float32),
        v_sigma=np.full((n, 3), 0.5, np.float32),
        a_mean=np.zeros((n, 3), np.float32),
        a_sigma=np.full((n, 3), 0.1, np.float32),
        slope_sigma=np.zeros(n, np.float32),
        use_dem_sigma=True,
    )
    reference = jax_batch.BatchMotion(
        dem=jax_batch.DeviceRaster(**dem), dem_sigma=jax_batch.DeviceRaster(**dem_sigma), **fields
    )
    port = convert.motion_from_numpy(dict(fields, dem=dem, dem_sigma=dem_sigma), "cpu")
    init = {k: rng.normal(size=(n, p) + s).astype(np.float32) for k, s in (("xy", (2,)), ("z", ()), ("v", (3,)))}
    a = rng.normal(size=(n, p, 3)).astype(np.float32)
    ref_particles = reference.initialize(jax.random.PRNGKey(0), p, noise=init)
    particles = port.initialize(None, p, noise=init)
    np.testing.assert_allclose(particles.numpy(), np.asarray(ref_particles), atol=0, rtol=1e-6)
    ref_evolved = reference.evolve(jax.random.PRNGKey(1), ref_particles, np.float32(2.0), noise={"a": a})
    evolved = port.evolve(None, particles, torch.tensor(2.0), noise={"a": a})
    np.testing.assert_allclose(evolved.numpy(), np.asarray(ref_evolved), atol=0, rtol=1e-6)
    ll = port.log_likelihoods(evolved).numpy()
    assert (ll > 0).all()
    np.testing.assert_allclose(ll, np.asarray(reference.log_likelihoods(ref_evolved)), atol=0, rtol=1e-6)


def test_config_refuses_unported_settings() -> None:
    """The four float dtypes the reference runs construct; a dtype that is
    not a float is refused with ValueError. Values the reference refuses
    raise ValueError here too, and every value it takes constructs."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        assert batch.BatchConfig(dtype=dtype).dtype == dtype
    for dtype in (torch.int32, torch.complex64):
        with pytest.raises(ValueError):
            batch.BatchConfig(dtype=dtype)
    for settings in [dict(resample_method="multinomial"), dict(interpolation_order=2)]:
        with pytest.raises(ValueError):
            batch.BatchConfig(**settings)
    for size in ((4, 5), (4, 4), (2, 3), (9, 9), (1, 51)):  # the reference takes them under its default mode
        assert batch.BatchConfig(highpass_size=size).highpass_size == size
        jax_batch.BatchConfig(highpass_size=size)
    for method in ("systematic", "stratified", "residual", "choice"):
        for order in (1, 3):
            batch.BatchConfig(
                resample_method=method, interpolation_order=order, resample_threshold=0.5, return_covariances=True
            )
    leaves = dataclasses.asdict(make_motion(np.zeros((2, 2))))
    for kind in ("cartesian", "cylindrical", "tangent", "tangent_cylindrical"):
        assert convert.motion_from_numpy(leaves | {"kind": kind}, "cpu").kind == kind
    with pytest.raises(ValueError):
        convert.motion_from_numpy(leaves | {"kind": "polar"}, "cpu")


def test_state_without_validity_steps_as_valid(scene) -> None:
    """A reference state with valid=None (a version-1 snapshot's) carries
    across as all ones, and the step's validity equals the reference's, not
    NaN."""
    images, noise, reference, port = scene
    ref_state = jax.jit(reference.initialize)(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    ref_state = dataclasses.replace(ref_state, valid=None)
    step_noise = {"a": noise["a"][0], "resample_u": noise["resample_u"][0]}
    _, ref_out = reference.step(ref_state, images[1], np.float32(1.0), noise=step_noise)
    leaves = {
        f.name: None if getattr(ref_state, f.name) is None else np.asarray(getattr(ref_state, f.name))
        for f in dataclasses.fields(ref_state) if f.name != "key"
    }
    state = convert.state_from_numpy(**leaves, device="cpu")
    np.testing.assert_array_equal(state.valid.numpy(), np.ones(N, np.float32))
    _, out = port.step(state, torch.from_numpy(images[1]), torch.tensor(1.0), noise=step_noise)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(ref_out["mean"]), atol=1e-3, rtol=0)


def test_track_one_frame_returns_empty_outputs(scene) -> None:
    """One frame: no step. The initial state comes back, with outputs whose
    leading axis is 0, as the reference's zero-length scan gives."""
    images, noise, reference, port = scene
    init = {k: v for k, v in noise.items() if k == "init"}
    ref_state, ref_out = reference.track(jax.random.PRNGKey(0), images[:1], np.ones(0), noise=init)
    state, out = port.track(torch.Generator().manual_seed(0), images[:1], np.ones(0), noise=init)
    assert state.step == 0
    assert set(out) == set(ref_out)
    for k in out:
        assert tuple(out[k].shape) == np.asarray(ref_out[k]).shape, k
    assert tuple(out["mean"].shape) == (0, N, 6) and tuple(out["valid"].shape) == (0, N)
    np.testing.assert_allclose(state.particles.numpy(), np.asarray(ref_state.particles), atol=0, rtol=1e-6)
    np.testing.assert_allclose(state.templates.numpy(), np.asarray(ref_state.templates), atol=1e-5, rtol=0)


def test_tracker_defaults_to_the_card() -> None:
    """``BatchTracker`` and ``DeviceRaster.constant`` default to ``"cuda"``,
    as the port's other entry points do. Built without ``device=`` on a host
    without a card, a tracker raises rather than landing on the CPU."""
    import inspect

    for fn in (batch.BatchTracker.__init__, batch.DeviceRaster.constant):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(np.zeros((2, 2)))), "cpu")
    cam = np.zeros((1, 20), np.float32)
    if torch.cuda.is_available():
        assert batch.BatchTracker(cam, [None], [0.3], motion).device.type == "cuda"
        assert batch.DeviceRaster.constant(0.0).array.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        batch.BatchTracker(cam, [None], [0.3], motion)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        batch.DeviceRaster.constant(0.0)


@pytest.mark.parametrize("size", [(4, 4), (2, 3), (9, 9)])
def test_highpass_windows_outside_the_kernels_domain(size) -> None:
    """Even and over-49-tap windows lie outside the CUDA kernel's domain
    (``kernels.highpass.covers``): the tracker routes them to the plain
    version, which equals the reference's ``imageproc.highpass`` exactly, and
    initializes and steps from the reference's carried state like any other
    window (first-step bound of this file, 1e-3)."""
    from glimpse_tpu.ops import imageproc as jax_imageproc
    from glimpse_tpu_torch.kernels import highpass as highpass_kernel
    from glimpse_tpu_torch.ops import imageproc

    assert not highpass_kernel.covers(size) and highpass_kernel.covers((5, 5))
    tiles = np.random.default_rng(2).normal(size=(3, 41, 41)).astype(np.float32)
    want = jax_imageproc.highpass(tiles, size=size, xp=np)
    np.testing.assert_array_equal(imageproc.highpass(torch.from_numpy(tiles), size).numpy(), want)
    np.testing.assert_array_equal(highpass_kernel.highpass(torch.from_numpy(tiles), size).numpy(), want)
    with pytest.raises(ValueError):
        highpass_kernel.median_highpass(torch.from_numpy(tiles), size)

    cam, frames, _ = make_scene(n_frames=2, velocity=(2.0, 1.0))
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(N, 2))
    rng = np.random.default_rng(5)
    noise = {
        "init": {"xy": rng.normal(size=(N, P, 2)).astype(np.float32), "v": rng.normal(size=(N, P, 3)).astype(np.float32)},
        "a": rng.normal(size=(N, P, 3)).astype(np.float32), "resample_u": rng.random(N).astype(np.float32),
    }
    jax_motion = make_motion(points_xy)
    reference = jax_batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], jax_motion, jax_batch.BatchConfig(n_particles=P, highpass_size=size, **SIZES))
    port = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], convert.motion_from_numpy(dataclasses.asdict(jax_motion), "cpu"),
        batch.BatchConfig(n_particles=P, highpass_size=size, **SIZES), device="cpu")
    images = frames[:, None]
    ref_state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    state = port.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    np.testing.assert_allclose(state.templates.numpy(), np.asarray(ref_state.templates), atol=1e-5, rtol=0)
    step_noise = {"a": noise["a"], "resample_u": noise["resample_u"]}
    ref_next, ref_out = reference.step(ref_state, images[1], np.float32(1.0), noise=step_noise)
    leaves = {f.name: np.asarray(getattr(ref_state, f.name)) for f in dataclasses.fields(ref_state) if f.name != "key"}
    nxt, out = port.step(convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[1]), torch.tensor(1.0), noise=step_noise)
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(ref_out["mean"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(out["sigma"].numpy(), np.asarray(ref_out["sigma"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(nxt.particles.numpy(), np.asarray(ref_next.particles), atol=1e-3, rtol=0)


def test_three_by_three_templates_under_seven_by_seven_taps() -> None:
    """``BatchConfig(template_size=(3, 3), highpass_size=(7, 7))``: every
    template is thinner than half the window, so its padding reflects more
    than once (ROADMAP C13). The port's templates equal the reference's
    (its XLA high-pass, what ``highpass_mode="auto"`` takes off a TPU)
    within 1e-5, and three steps, each from the reference's carried state,
    agree within 1e-3."""
    steps = 3
    cam, frames, _ = make_scene(n_frames=steps + 1, velocity=(2.0, 1.0))
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(N, 2))
    rng = np.random.default_rng(5)
    noise = {
        "init": {"xy": rng.normal(size=(N, P, 2)).astype(np.float32), "v": rng.normal(size=(N, P, 3)).astype(np.float32)},
        "a": rng.normal(size=(steps, N, P, 3)).astype(np.float32), "resample_u": rng.random((steps, N)).astype(np.float32),
    }
    sizes = dict(template_size=(3, 3), search_size=(41, 41), highpass_size=(7, 7))
    jax_motion = make_motion(points_xy)
    reference = jax_batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], jax_motion, jax_batch.BatchConfig(n_particles=P, **sizes))
    assert reference.config.highpass_mode == "xla"
    port = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], convert.motion_from_numpy(dataclasses.asdict(jax_motion), "cpu"),
        batch.BatchConfig(n_particles=P, **sizes), device="cpu")
    images = frames[:, None]
    ref_state = jax.jit(reference.initialize)(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    state = port.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    assert state.templates.shape == (1, N, 3, 3)
    np.testing.assert_allclose(state.templates.numpy(), np.asarray(ref_state.templates), atol=1e-5, rtol=0)
    reference_step = jax.jit(reference.step)
    for i in range(steps):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        leaves = {f.name: np.asarray(getattr(ref_state, f.name)) for f in dataclasses.fields(ref_state) if f.name != "key"}
        _, out = port.step(convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[i + 1]),
                           torch.tensor(1.0), noise=step_noise)
        ref_state, ref_out = reference_step(ref_state, images[i + 1], np.float32(1.0), noise=step_noise)
        for key in ("mean", "sigma"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref_out[key]), atol=1e-3, rtol=0, err_msg=f"{key} {i}")
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))


def test_package_surface() -> None:
    """``import glimpse_tpu_torch`` gives what ``import glimpse_tpu`` gives:
    ``optimize``, ``svg``, ``convert``, ``parallel``, ``profiling``,
    ``Tracker``, ``__all__`` (every name of it defined, each also a name of
    the JAX package's or one of the port's own three, and every name of the
    JAX package's in it) and ``__version__``."""
    import glimpse_tpu
    import glimpse_tpu_torch

    assert glimpse_tpu_torch.__version__ == glimpse_tpu.__version__
    assert glimpse_tpu_torch.optimize.Cameras and glimpse_tpu_torch.svg.read
    assert glimpse_tpu_torch.Tracker is glimpse_tpu_torch.track.Tracker is glimpse_tpu_torch.track.tracker.Tracker
    names = set(glimpse_tpu_torch.__all__)
    assert len(names) == len(glimpse_tpu_torch.__all__)
    assert all(hasattr(glimpse_tpu_torch, name) for name in names)
    assert {"optimize", "svg", "Tracker"} <= names
    assert names - set(glimpse_tpu.__all__) == {"kernels", "track", "Motion"}
    assert set(glimpse_tpu.__all__) - names == set()
    assert glimpse_tpu_torch.convert.Converter and glimpse_tpu_torch.parallel.get_mesh
    assert glimpse_tpu_torch.profiling.Timer
    assert set(glimpse_tpu_torch.track.__all__) == set(glimpse_tpu.track.__all__)
