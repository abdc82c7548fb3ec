"""The port's batched tracker with several observers, observation masks,
late templates, ESS-triggered resampling and a viewshed, in lockstep with
the JAX package on the CPU.

Both trackers get the same scene, motion and injected draws. What differs
is float32 rounding in sums and transcendental functions, so step 1 and
every step from the reference's carried state are held to 1e-3; free
trajectories to 1e-2 for the median point and half a pixel for each (see
``assert_free_lockstep``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu import Camera
from glimpse_tpu.raster import Raster
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.track import batch, convert
from test_batch_tracker import make_motion, make_scene

SIZES = dict(template_size=(15, 15), search_size=(41, 41))


def render(cam, n_frames, velocity, seed=0):
    """Frames of make_scene's moving ground texture through another camera."""
    import scipy.ndimage

    world = scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=(500, 500)), 0.8) * 100
    texture = Raster(world, x=(0, 500), y=(500, 0))
    rays = cam.uv_to_xyz(cam.grid(step=1, mode="points"))
    ground = cam.xyz + rays * (-cam.xyz[2] / rays[:, 2])[:, None]
    frames = [
        texture.sample(ground[:, 0:2] - np.multiply(velocity, i), bounds_error=False, fill_value=0.0)
        for i in range(n_frames)
    ]
    return np.stack(frames).reshape(n_frames, *cam.imgsz[::-1].astype(int))


def draws(n, p, t, seed):
    rng = np.random.default_rng(seed)
    return {
        "init": {"xy": rng.normal(size=(n, p, 2)).astype(np.float32), "v": rng.normal(size=(n, p, 3)).astype(np.float32)},
        "a": rng.normal(size=(t - 1, n, p, 3)).astype(np.float32),
        "resample_u": rng.random((t - 1, n)).astype(np.float32),
    }


def pair(cams, motion, viewshed=None, **settings):
    """The reference tracker and the port's, on the same cameras and motion."""
    cams = np.stack(cams).astype(np.float32)
    O = len(cams)
    reference = jax_batch.BatchTracker(
        cams, [None] * O, [0.15] * O, motion, jax_batch.BatchConfig(**settings), viewshed=viewshed
    )
    port_viewshed = None
    if viewshed is not None:
        port_viewshed = convert.raster_from_numpy(
            dict(array=viewshed.array, x0=viewshed.xlim[0], y0=viewshed.ylim[0], dx=viewshed.d[0], dy=viewshed.d[1]),
            "cpu",
        )
    port = batch.BatchTracker(
        cams, [None] * O, [0.15] * O, convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
        batch.BatchConfig(**settings), device="cpu", viewshed=port_viewshed,
    )
    return reference, port


def assert_free_lockstep(out, ref_out, keys):
    """Free runs: step 1 within 1e-3, the trajectory within 1e-2.

    A free-running filter amplifies rounding: the likelihood is steep (sigma
    0.15 px), so a rounding-level change in a weighted mean moves a search
    box or a resampling threshold across a slot, and the point then follows
    another, equally likely particle path. The reference parts from itself
    that way: on late_scene with draws seed 12, its jitted ``track`` and its
    eager ``step`` loop part by 0.47 on one point. So the draws of these
    runs are ones that meet no such near-tie, and
    ``test_each_step_from_carried_state`` holds every step at 1e-3."""
    for k in keys:
        got, want = out[k].numpy(), np.asarray(ref_out[k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0, err_msg=k)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0, err_msg=k)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))


@pytest.fixture(scope="module")
def two_cameras():
    """tests/test_batch_tracker.py:412's scene: two nadir cameras 14 px
    apart over a texture moving (2, 1) per frame; 8 frames."""
    n_frames, velocity = 8, (2.0, 1.0)
    cam1, frames1, _ = make_scene(n_frames=n_frames, velocity=velocity)
    cam2 = Camera(imgsz=256, f=300, xyz=(260, 240, 300), viewdir=(0, -90, 0))
    frames2 = render(cam2, n_frames, velocity)
    images = np.stack([frames1, frames2], axis=1).astype(np.float32)
    points_xy = np.array([[250.0, 250.0], [230.0, 260.0], [245.0, 235.0], [262.0, 255.0]])
    return (cam1.to_array(), cam2.to_array()), images, make_motion(points_xy), draws(4, 256, n_frames, 9)


@pytest.fixture(scope="module")
def late_scene():
    """tests/test_batch_tracker.py:1222's scene: observer B first fires at
    step 4, then A and B alternate; B's template frame is a wrong image."""
    n_points, n_particles, n_frames = 3, 300, 9
    cam, frames, _ = make_scene(n_frames=n_frames, velocity=(1.2, -0.7))
    starts = np.random.default_rng(9).uniform(200, 300, size=(n_points, 2))
    present_b = np.array([False, False, False, True, False, True, False, True])
    present_a = np.array([True, True, True, False, True, False, True, False])
    masks = np.stack([present_a, present_b], axis=1).astype(np.float32)
    images = np.repeat(frames[:, None], 2, axis=1).astype(np.float32)
    images[0, 1] = np.roll(frames[0], 10, axis=1)
    motion = make_motion(starts, v_sigma=0.5)
    return cam.to_array(), images, masks, motion, draws(n_points, n_particles, n_frames, 39)


@pytest.fixture(scope="module")
def cases(two_cameras, late_scene):
    """(reference, port, images, noise, obs_masks, obs_mask0, output keys) by name:
    "masks", two observers with the second missing at steps 2 and 5;
    "ess", resample_threshold=0.5 with covariance outputs; "late", observer
    B starting late on late_scene."""
    cams, images, motion, noise = two_cameras
    masks = np.ones((len(images) - 1, 2), np.float32)
    masks[[1, 4], 1] = 0.0
    ess = dict(n_particles=256, resample_threshold=0.5, return_covariances=True, **SIZES)
    cam, late_images, late_masks, late_motion, late_noise = late_scene
    keys = ("mean", "sigma")
    return {
        "masks": (*pair(cams, motion, n_particles=256, **SIZES), images, noise, masks, None, keys),
        "ess": (*pair(cams, motion, **ess), images, noise, None, None, keys + ("covariance",)),
        "late": (
            *pair([cam, cam], late_motion, n_particles=300, **SIZES), late_images, late_noise, late_masks,
            np.array([1.0, 0.0], np.float32), keys,
        ),
    }


@pytest.mark.parametrize("case", ["masks", "ess", "late"])
def test_free_run_lockstep(cases, case) -> None:
    reference, port, images, noise, masks, mask0, keys = cases[case]
    dts = np.ones(len(images) - 1, np.float32)
    ref_state, ref_out = reference.track(
        jax.random.PRNGKey(0), images, dts, noise=noise, obs_masks=masks, obs_mask0=mask0
    )
    state, out = port.track(
        torch.Generator().manual_seed(0), images, dts, noise=noise, obs_masks=masks, obs_mask0=mask0
    )
    assert set(out) == set(ref_out)
    assert_free_lockstep(out, ref_out, keys)
    assert state.templates.shape == np.asarray(ref_state.templates).shape
    if case == "ess":
        # Accumulated weights are renormalized to mean 1.
        np.testing.assert_allclose(state.weights.mean(-1).numpy(), 1.0, rtol=1e-5)
    if case == "late":
        assert port._template_plan(masks, mask0) == ((True, False), {4: (1,)})


@pytest.mark.parametrize("case", ["masks", "ess", "late"])
def test_each_step_from_carried_state(cases, case) -> None:
    """Every step from the reference's own state (the late observer's
    template step included): outputs and templates within 1e-3, and the
    resampled rows and their weights."""
    reference, port, images, noise, masks, mask0, keys = cases[case]
    _, plan = port._template_plan(masks, mask0)
    ref_step = jax.jit(reference.step, static_argnames=("init_template_for",))
    state = reference.initialize(
        jax.random.PRNGKey(0), images[0], noise=noise["init"], obs_mask0=None if mask0 is None else (True, False)
    )
    for i in range(len(images) - 1):
        kwargs = dict(
            noise={"a": noise["a"][i], "resample_u": noise["resample_u"][i]},
            obs_mask=None if masks is None else masks[i], init_template_for=plan.get(i + 1, ()),
        )
        leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        nxt, out = port.step(
            convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[1 + i]), torch.tensor(1.0),
            **kwargs,
        )
        state, ref_out = ref_step(state, images[1 + i], np.float32(1.0), **kwargs)
        for k in keys:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), atol=1e-3, rtol=0, err_msg=f"{k} {i}")
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))
        np.testing.assert_allclose(nxt.templates.numpy(), np.asarray(state.templates), atol=1e-4, rtol=0)
        np.testing.assert_allclose(nxt.template_duv.numpy(), np.asarray(state.template_duv), atol=1e-3, rtol=0)
        # A resampling threshold within rounding of a slot gives that slot
        # another source row: at most 2 % of the rows; the rest agree.
        particles, want = nxt.particles.numpy(), np.asarray(state.particles)
        same = np.abs(particles - want).max(-1) <= 1e-3
        assert same.mean() >= 0.98, (i, same.mean())
        np.testing.assert_allclose(nxt.weights.numpy()[same], np.asarray(state.weights)[same], rtol=1e-3, atol=1e-6)


def test_late_observer_initialize_leaves_zero_templates(late_scene) -> None:
    cam, images, masks, motion, noise = late_scene
    reference, port = pair([cam, cam], motion, n_particles=300, **SIZES)
    mask0 = np.array([True, False])
    ref_state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"], obs_mask0=mask0)
    state = port.initialize(torch.Generator(), torch.from_numpy(images[0]), noise=noise["init"], obs_mask0=mask0)
    for k in ("templates", "template_table", "template_duv"):
        assert not getattr(state, k)[1].any(), k
        np.testing.assert_allclose(getattr(state, k).numpy(), np.asarray(getattr(ref_state, k)), atol=1e-3, rtol=0)


def test_fully_masked_observer_equals_one_observer(late_scene) -> None:
    """tests/test_batch_tracker.py:1003: an observer masked on every step
    adds exactly nothing: the same trajectory, bit for bit."""
    cam, images, _, motion, noise = late_scene
    port_motion = convert.motion_from_numpy(dataclasses.asdict(motion), "cpu")
    config = batch.BatchConfig(n_particles=300, **SIZES)
    dts = np.ones(len(images) - 1, np.float32)

    def run(n_obs, masks):
        tracker = batch.BatchTracker(np.stack([cam] * n_obs), [None] * n_obs, [0.15] * n_obs, port_motion, config, device="cpu")
        return tracker.track(torch.Generator(), images[:, :n_obs], dts, noise=noise, obs_masks=masks)[1]["mean"]

    masks = np.stack([np.ones(len(dts)), np.zeros(len(dts))], axis=1)
    assert torch.equal(run(2, masks), run(1, None))


def test_all_observers_masked_carries_weights(late_scene) -> None:
    """tests/test_batch_tracker.py:1059: a step with every observer masked
    keeps the weights it was given; from the reference's state the port
    resamples the same rows."""
    cam, images, _, motion, noise = late_scene
    reference, port = pair([cam], motion, n_particles=300, **SIZES)
    ref_state = reference.initialize(jax.random.PRNGKey(0), images[0, :1], noise=noise["init"])
    ref_state, _ = reference.step(ref_state, images[1, :1], np.float32(1.0), noise={"a": noise["a"][0], "resample_u": noise["resample_u"][0]})
    step_noise = {"a": noise["a"][1], "resample_u": noise["resample_u"][1]}
    off = np.zeros(1, np.float32)
    ref_next, ref_out = reference.step(ref_state, images[2, :1], np.float32(1.0), noise=step_noise, obs_mask=off)
    leaves = {f.name: np.array(getattr(ref_state, f.name)) for f in dataclasses.fields(ref_state) if f.name != "key"}
    state = convert.state_from_numpy(**leaves, device="cpu")
    masked, out = port.step(state, torch.from_numpy(images[2, :1]), torch.tensor(1.0), noise=step_noise, obs_mask=off)
    unmasked, _ = port.step(state, torch.from_numpy(images[2, :1]), torch.tensor(1.0), noise=step_noise)
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(ref_out["mean"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(masked.weights.numpy(), np.asarray(ref_next.weights), rtol=1e-5, atol=0)
    assert np.isin(np.unique(masked.weights.numpy()), np.unique(leaves["weights"])).all()
    assert not torch.allclose(masked.weights, unmasked.weights)


def test_viewshed_validity_latches_as_reference() -> None:
    """tests/test_batch_tracker.py:1098: point 1 crosses onto non-visible
    cells at step 5 and stays invalid; point 0 stays valid."""
    velocity, n_frames = (2.0, 0.0), 9
    cam, frames, _ = make_scene(n_frames=n_frames, velocity=velocity)
    motion = make_motion(np.array([[250.0, 200.0], [250.0, 250.0]]))
    motion.xy_sigma = jnp.zeros((2, 2), jnp.float32)
    motion.v_mean = jnp.asarray([[0.0, 0.0, 0.0], [velocity[0], velocity[1], 0.0]], jnp.float32)
    motion.v_sigma = jnp.zeros((2, 3), jnp.float32)
    motion.a_sigma = jnp.zeros((2, 3), jnp.float32)
    vs_array = np.ones((50, 50), np.float32)
    vs_array[:, 26:] = 0.0  # world x >= 260 invisible
    viewshed = Raster(vs_array, x=(0, 500), y=(500, 0))
    reference, port = pair([cam.to_array()], motion, viewshed=viewshed, n_particles=64)
    dts = np.ones(n_frames - 1)
    _, ref_out = reference.track(jax.random.PRNGKey(0), frames[:, None], dts)
    _, out = port.track(torch.Generator().manual_seed(0), frames[:, None], dts)
    valid = out["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref_out["valid"]))
    assert (valid[:, 0] == 1).all() and (valid[:4, 1] == 1).all() and (valid[4:, 1] == 0).all()
    np.testing.assert_allclose(out["mean"].numpy()[:, 0], np.asarray(ref_out["mean"])[:, 0], atol=1e-2, rtol=0)


def test_viewshed_start_check() -> None:
    """tests/test_batch_tracker.py:670: a point on a non-visible cell is
    refused, as is a point outside the raster (the reference's order-0
    sample raises there); all-visible points construct."""
    viewshed = convert.raster_from_numpy(
        dict(array=np.array([[1.0, 0.0], [1.0, 1.0]]), x0=0.0, y0=64.0, dx=32.0, dy=-32.0), "cpu"
    )
    cam = np.zeros((1, 20), np.float32)

    def build(points):
        motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(np.array(points))), "cpu")
        return batch.BatchTracker(cam, [None], [0.3], motion, device="cpu", viewshed=viewshed)

    with pytest.raises(ValueError, match="non-visible"):
        build([[16.0, 48.0], [48.0, 48.0]])
    with pytest.raises(ValueError, match="outside"):
        build([[16.0, 48.0], [70.0, 16.0]])
    with pytest.raises(ValueError, match="outside"):
        build([[16.0, -1.0]])
    assert build([[16.0, 48.0], [16.0, 16.0], [64.0, 0.0]]).viewshed is not None
    reference_vs = Raster(np.array([[1.0, 0.0], [1.0, 1.0]]), x=(0, 64), y=(64, 0))
    with pytest.raises(ValueError):
        jax_batch.BatchTracker(cam, [None], [0.3], make_motion(np.array([[70.0, 16.0]])), viewshed=reference_vs)


def test_masks_from_frame_table_matches_reference() -> None:
    table = [[0, 0], [1, None], [None, 1], [2, 2]]
    want = jax_batch.masks_from_frame_table(table)
    got = batch.masks_from_frame_table(table)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(batch.masks_from_frame_table(np.arange(6).reshape(3, 2)), np.ones((3, 2)))
