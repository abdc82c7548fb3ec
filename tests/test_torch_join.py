"""Stabilize, then track: ``track_stream`` with per-frame cameras that vary,
the port against the JAX package on the CPU.

``benchmarks/columbia_pipeline.py`` tracks a wobbling sequence through the
view directions that stabilization recovered (``camera_vectors_seq``). Here
both packages run ``track_stream`` on the same 128 x 128 frames of that
scene (``chip_smoke.stabilization_scene``: the same world, a camera of f =
128), 16 points x 256 particles x 6 steps, with each frame's true view
direction, which wobbles by (0.1, 0.1, 0.03) deg a frame, and shared
injected draws: one observer, and two with disjoint fire times as in
``main_two_observers`` (A on even steps, B on odd ones, B's template-frame
camera its first fire's). The reference's stream calls its jitted
``initialize`` and ``step`` through recording wrappers; the port's stream
then takes every step from the reference's carried state, and each step's
camera row, frame and outputs are held to the reference's: the rows
bit for bit in float32 (row 0 makes the templates), the outputs within
1e-3 as ``tests/test_torch_observers.py`` holds them.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from chip_smoke import join_points, stabilization_scene
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.track import batch, convert

N_POINTS, N_PARTICLES, N_FRAMES, IMGSZ = 16, 256, 7, 128
SETTINGS = dict(n_particles=N_PARTICLES, template_size=(15, 15), search_size=(31, 31))
# main_two_observers' second station: west of the scene, looking east.
CAM_B = dict(cam_xyz=(-200.0, 270.0, 400.0), viewdir=(90.0, -35.0, 0.0), jitter_seed=43)


def camera_rows(base, viewdirs) -> np.ndarray:
    rows = np.tile(base, (len(viewdirs), 1))
    rows[:, 3:6] = viewdirs
    return rows


@pytest.fixture(scope="module")
def scenes():
    """(cameras (O, 20), camera_vectors_seq (T, O, 20), template frame (O, H,
    W), frames (T - 1, O, H, W), obs_masks or None) by name."""
    frames_a, truth_a, base_a, _ = stabilization_scene(N_FRAMES, "cpu", imgsz=IMGSZ)
    frames_b, truth_b, base_b, _ = stabilization_scene(N_FRAMES, "cpu", imgsz=IMGSZ, **CAM_B)
    frames_a, frames_b = frames_a.astype(np.float32), frames_b.astype(np.float32)
    seq_a, seq_b = camera_rows(base_a, truth_a), camera_rows(base_b, truth_b)
    one = (base_a[None], seq_a[:, None], frames_a[0][None], frames_a[1:, None], None)
    # Disjoint fire times: A fires at even steps, B at odd ones; a masked
    # observer's image is zeros. B's template comes from its first fire.
    zero = np.zeros_like(frames_a[0])
    stacked = np.stack([np.stack([frames_a[t], zero] if t % 2 == 0 else [zero, frames_b[t]]) for t in range(N_FRAMES)])
    stacked[0] = np.stack([frames_a[0], frames_b[1]])
    seq = np.stack([seq_a, seq_b], axis=1)
    seq[0, 1] = seq[1, 1]
    steps = np.arange(1, N_FRAMES)
    masks = np.stack([steps % 2 == 0, steps % 2 == 1], axis=1).astype(np.float32)
    two = (np.stack([base_a, base_b]), seq, stacked[0], stacked[1:], masks)
    return {"one observer": one, "two observers": two}


def draws(seed: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "init": {"xy": rng.normal(size=(N_POINTS, N_PARTICLES, 2)).astype(np.float32),
                 "v": rng.normal(size=(N_POINTS, N_PARTICLES, 3)).astype(np.float32)},
        "a": rng.normal(size=(N_FRAMES - 1, N_POINTS, N_PARTICLES, 3)).astype(np.float32),
        "resample_u": rng.random((N_FRAMES - 1, N_POINTS)).astype(np.float32),
    }


def trackers(cams):
    """The reference tracker and the port's on columbia_pipeline.py's recipe
    (its ``_tracking_setup``, rebuilt on these starts)."""
    starts, _ = join_points(N_POINTS, N_FRAMES, np.random.default_rng(5))
    n = len(starts)
    motion = jax_batch.BatchMotion(
        kind="cartesian", xy=jnp.asarray(starts, jnp.float32), xy_sigma=jnp.full((n, 2), 1.0, jnp.float32),
        v_mean=jnp.zeros((n, 3), jnp.float32), v_sigma=jnp.full((n, 3), 0.5, jnp.float32).at[:, 2].set(0.0),
        a_mean=jnp.zeros((n, 3), jnp.float32), a_sigma=jnp.full((n, 3), 0.05, jnp.float32).at[:, 2].set(0.0),
        slope_sigma=jnp.zeros((n,), jnp.float32), dem=jax_batch.DeviceRaster.constant(0.0),
        dem_sigma=jax_batch.DeviceRaster.constant(0.0), use_dem_sigma=False,
    )
    O = len(cams)
    reference = jax_batch.BatchTracker(cams.astype(np.float32), [None] * O, [0.3] * O, motion,
                                       jax_batch.BatchConfig(**SETTINGS))
    port = batch.BatchTracker(cams, [None] * O, [0.3] * O, convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
                              batch.BatchConfig(**SETTINGS), device="cpu")
    return reference, port


def step_noise(noise, i) -> dict:
    return {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}


class _Unjitted:
    """The ``jax`` module as the reference's ``track/batch.py`` sees it, but
    with ``jit`` handing the function back: its ``track_stream`` then calls
    the recording ``initialize`` and ``step`` below with concrete arrays,
    and they run the reference's own jitted functions."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        return fn


@pytest.fixture(scope="module")
def recorded(scenes):
    """The reference's ``track_stream`` by name, with the draws injected:
    its initial state and, step by step, (state in, frame, camera row,
    obs_mask, outputs)."""
    noise = draws()
    out = {}
    for name, (cams, seq, first, frames, masks) in scenes.items():
        reference, _ = trackers(cams)
        initialize = jax.jit(functools.partial(reference.initialize, noise=noise["init"]), static_argnames=("obs_mask0",))
        step = jax.jit(reference.step, static_argnames=("init_template_for",))
        calls, init = [], {}

        def recording_initialize(key, images0, **kwargs):
            init["camera_vectors"] = np.asarray(kwargs["camera_vectors"])
            init["state"] = initialize(key, images0, **kwargs)
            return init["state"]

        def recording_step(state, images, dt, **kwargs):
            nxt, outputs = step(state, images, dt, noise=step_noise(noise, len(calls)), **kwargs)
            calls.append((state, np.asarray(images), np.asarray(kwargs["camera_vectors"]), kwargs.get("obs_mask"), outputs))
            return nxt, outputs

        reference.initialize, reference.step = recording_initialize, recording_step
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_batch, "jax", _Unjitted())
            _, outputs = reference.track_stream(
                jax.random.PRNGKey(0), first, iter(frames), np.ones(N_FRAMES - 1, np.float32),
                camera_vectors_seq=seq, obs_masks=masks,
            )
        assert len(calls) == len(outputs) == N_FRAMES - 1
        out[name] = (init, calls)
    return out


def leaves(state) -> dict:
    return {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", ["one observer", "two observers"])
def test_stream_with_varying_cameras_follows_the_reference(scenes, recorded, name, chunk) -> None:
    """The port's ``track_stream`` (frame by frame, and in chunks of 4 as
    a long run streams) from the reference's carried state at every step:
    the template frame's cameras are row 0, each step's are row t, both
    float32 and equal to the reference's; the templates within 1e-4 and
    their offsets within 1e-3; each step's outputs within 1e-3."""
    cams, seq, first, frames, masks = scenes[name]
    init, calls = recorded[name]
    _, port = trackers(cams)
    noise = draws()
    initialize, step = port.initialize, port.step
    seen = []

    def checked_initialize(generator, images0, **kwargs):
        got = kwargs["camera_vectors"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), init["camera_vectors"])
        state = initialize(generator, images0, noise=noise["init"], **kwargs)
        want = init["state"]
        np.testing.assert_allclose(state.templates.numpy(), np.asarray(want.templates), atol=1e-4, rtol=0)
        np.testing.assert_allclose(state.template_duv.numpy(), np.asarray(want.template_duv), atol=1e-3, rtol=0)
        np.testing.assert_allclose(state.particles.numpy(), np.asarray(want.particles), atol=1e-4, rtol=0)
        return state

    def checked_step(state, images, dt, **kwargs):
        i = len(seen)
        ref_state, ref_images, ref_cams, ref_mask, ref_out = calls[i]
        np.testing.assert_array_equal(images.numpy(), ref_images)
        assert kwargs["camera_vectors"].dtype == torch.float32
        np.testing.assert_array_equal(kwargs["camera_vectors"].numpy(), ref_cams)
        if masks is not None:
            np.testing.assert_array_equal(kwargs["obs_mask"].numpy(), np.asarray(ref_mask))
        carried = convert.state_from_numpy(**leaves(ref_state), device="cpu")
        nxt, out = step(carried, images, dt, noise=step_noise(noise, i), **kwargs)
        for k in ("mean", "sigma"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), atol=1e-3, rtol=0, err_msg=f"{k} {i}")
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))
        seen.append(i)
        return nxt, out

    port.initialize, port.step = checked_initialize, checked_step
    _, outputs = port.track_stream(
        torch.Generator().manual_seed(0), first, iter(frames), np.ones(N_FRAMES - 1, np.float32),
        camera_vectors_seq=seq, obs_masks=masks, chunk=chunk,
    )
    assert seen == list(range(N_FRAMES - 1))
    assert sum(len(o["mean"]) if chunk > 1 else 1 for o in outputs) == N_FRAMES - 1
    # The wobble is real: the rows part from frame to frame.
    assert np.abs(np.diff(seq[:, :, 3:6], axis=0)).max() > 0.05
