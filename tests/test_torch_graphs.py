"""The port's step programs (``track.batch.StepProgram``) on the CPU.

``track`` and ``track_stream`` run every step after a key's first through a
:class:`StepProgram`, which copies the step's inputs and state into buffers
of its own and runs the eager ``step`` there (on a card it replays a CUDA
graph captured from it instead; ``tests/test_torch_cuda.py`` holds that).
Here each run is held bit for bit against a loop of the eager ``step`` from
the same generator seed, 16 points x 64 particles x 6 steps on 32 x 32
frames: generator draws and injected ones, chunked streams with per-frame
cameras, a late observer whose template step runs eagerly between program
steps, ESS resampling, covariances, float32 and float64, a two-slice mesh;
the outputs kept from each step against snapshots taken as it returned; the
cache key; and one run against the JAX package's ``track``.
"""
import dataclasses

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch import parallel
from glimpse_tpu_torch.track import batch, convert

N, P, T, SIZE = 16, 64, 6, 32
SETTINGS = dict(n_particles=P, template_size=(7, 7), search_size=(15, 15))
FLAT = {"array": np.zeros((1, 1), np.float32), "x0": np.float32(0.0), "y0": np.float32(0.0), "dx": np.float32(1e30),
        "dy": np.float32(1e30)}
MOTION = dict(
    kind="cartesian",
    xy=np.random.default_rng(1).uniform(11, 21, size=(N, 2)).astype(np.float32),
    xy_sigma=np.full((N, 2), 0.5, np.float32),
    v_mean=np.zeros((N, 3), np.float32),
    v_sigma=np.tile(np.float32([0.5, 0.5, 0.0]), (N, 1)),
    a_mean=np.zeros((N, 3), np.float32),
    a_sigma=np.tile(np.float32([0.1, 0.1, 0.0]), (N, 1)),
    slope_sigma=np.zeros(N, np.float32),
    use_dem_sigma=False,
)


def camera(wobble: float = 0.0) -> np.ndarray:
    """A nadir camera over the frame's centre, one world unit a pixel."""
    cam = np.zeros(20, np.float32)
    cam[0:3], cam[3:6], cam[6:10] = (SIZE / 2, SIZE / 2, SIZE), (wobble, -90.0, 0.0), SIZE
    return cam


def frames(n_observers: int = 1) -> np.ndarray:
    """(T, O, 32, 32) float32: smoothed noise drifting 0.4 px a frame, each
    observer two rows further down the texture."""
    base = scipy.ndimage.gaussian_filter(np.random.default_rng(2).normal(size=(64, 64)), 1.0) * 100
    out = np.empty((T, n_observers, SIZE, SIZE), np.float32)
    for t in range(T):
        moved = scipy.ndimage.shift(base, (0.0, 0.4 * t), order=1, mode="wrap")
        for o in range(n_observers):
            out[t, o] = moved[8 + 2 * o : 8 + 2 * o + SIZE, 8 : 8 + SIZE]
    return out


def make_tracker(n_observers: int = 1, mesh=None, **settings):
    viewshed = convert.raster_from_numpy(
        {"array": np.ones((8, 8)), "x0": -SIZE, "y0": 2 * SIZE, "dx": 3 * SIZE / 8, "dy": -3 * SIZE / 8}, "cpu"
    )
    motion = convert.motion_from_numpy(dict(MOTION, dem=FLAT, dem_sigma=FLAT), "cpu")
    return batch.BatchTracker(
        np.stack([camera()] * n_observers), [None] * n_observers, [0.3] * n_observers, motion,
        batch.BatchConfig(**SETTINGS, **settings), device="cpu", viewshed=viewshed, mesh=mesh,
    )


def noise(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "init": {"xy": rng.normal(size=(N, P, 2)).astype(np.float32), "v": rng.normal(size=(N, P, 3)).astype(np.float32)},
        "a": rng.normal(size=(T - 1, N, P, 3)).astype(np.float32),
        "resample_u": rng.random((T - 1, N)).astype(np.float32),
    }


def eager_loop(tracker, generator, images, noise=None, obs_masks=None, obs_mask0=None, cams=None):
    """initialize, then :meth:`step` once a frame, as ``track`` did before
    it ran step programs: (final state, time-major outputs)."""
    dtype = tracker.config.dtype
    images = batch._as_tensor(images, tracker.device, dtype)
    noise = noise or {}
    mask0, plan = tracker._template_plan(obs_masks, obs_mask0)
    state = tracker.initialize(generator, images[0], noise=noise.get("init"), obs_mask0=mask0,
                               camera_vectors=None if cams is None else cams[0])
    outs = []
    for i in range(T - 1):
        kwargs = {}
        if obs_masks is not None:
            kwargs["obs_mask"] = batch._as_tensor(obs_masks[i], tracker.device, dtype)
        if cams is not None:
            kwargs["camera_vectors"] = cams[1 + i]
        state, out = tracker.step(
            state, images[1 + i], torch.tensor(1.0, dtype=dtype),
            noise={k: noise[k][i] for k in batch.STEP_NOISE_KEYS if k in noise}, init_template_for=plan.get(i + 1, ()),
            **kwargs,
        )
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def assert_same_run(got, want, generators=None) -> None:
    (state, out), (want_state, want_out) = got, want
    assert out.keys() == want_out.keys()
    for k in want_out:
        assert torch.equal(out[k], want_out[k]), k
    for name in batch.STATE_FIELDS:
        assert torch.equal(getattr(state, name), getattr(want_state, name)), name
    assert state.step == want_state.step == T - 1
    if generators is not None:
        assert torch.equal(generators[0].get_state(), generators[1].get_state())


def concat(outputs) -> dict:
    return {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("settings", [{}, {"resample_threshold": 0.5}, {"return_covariances": True}],
                         ids=["every-step", "ess", "covariances"])
def test_track_with_generator_draws_equals_the_step_loop(dtype, settings) -> None:
    """The generator's draws, and the generator after the run, are the
    eager loop's."""
    tracker = make_tracker(dtype=dtype, **settings)
    images = frames()
    generators = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = tracker.track(generators[0], images, np.ones(T - 1))
    assert_same_run(got, eager_loop(tracker, generators[1], images), generators)
    assert tracker._programs == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_track_with_injected_noise_equals_the_step_loop(dtype) -> None:
    tracker = make_tracker(dtype=dtype)
    images, draws = frames(), noise()
    got = tracker.track(torch.Generator().manual_seed(0), images, np.ones(T - 1), noise=draws)
    assert_same_run(got, eager_loop(tracker, torch.Generator().manual_seed(0), images, noise=draws))


@pytest.mark.parametrize("chunk", [1, 3])
def test_stream_with_per_frame_cameras_equals_the_step_loop(chunk) -> None:
    """Wobbling cameras, a (T, 1, 20) sequence: each frame of a chunk is
    one program step."""
    tracker = make_tracker()
    images = frames()
    cams = torch.from_numpy(np.stack([[camera(0.2 * np.sin(t))] for t in range(T)]))
    generators = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    state, outputs = tracker.track_stream(generators[0], images[0], iter(images[1:]), np.ones(T - 1),
                                          camera_vectors_seq=cams.numpy(), chunk=chunk)
    if chunk == 1:
        outputs = [{k: v[None] for k, v in o.items()} for o in outputs]
    assert [len(o["mean"]) for o in outputs] == ([1] * 5 if chunk == 1 else [3, 2])
    assert_same_run((state, concat(outputs)), eager_loop(tracker, generators[1], images, cams=cams), generators)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_late_observer_runs_its_template_step_eagerly_between_program_steps(monkeypatch, dtype) -> None:
    """Two observers, the second without an image at the template frame and
    masked at steps 1-2: its template is cut at step 3, eagerly, between
    steps the program runs (2, 4 and 5), whose next call copies the eager
    step's state into its buffers; the run equals the step loop. In float64
    the template is cut at float64 particle means."""
    tracker = make_tracker(n_observers=2, resample_threshold=0.5, dtype=dtype)
    images = frames(2)
    masks = np.ones((T - 1, 2), np.float32)
    masks[0:2, 1] = 0.0
    mask0 = np.float32([1.0, 0.0])
    calls = []
    program_call = batch.StepProgram.__call__

    def spy(self, state, inputs):
        calls.append(state.step + 1)
        return program_call(self, state, inputs)

    monkeypatch.setattr(batch.StepProgram, "__call__", spy)
    got = tracker.track(torch.Generator().manual_seed(6), images, np.ones(T - 1), obs_masks=masks, obs_mask0=mask0)
    assert calls == [2, 4, 5]
    want = eager_loop(tracker, torch.Generator().manual_seed(6), images, obs_masks=masks, obs_mask0=mask0)
    assert_same_run(got, want)
    assert got[0].templates[1].abs().sum() > 0


def test_mesh_tracker_runs_a_program_a_slice() -> None:
    """Two slices on the CPU: each slice's steps go through a program of its
    own, with its own generator, and the run equals the mesh's eager step
    loop."""
    mesh = parallel.get_mesh(devices=["cpu"] * 2)
    tracker = make_tracker(mesh=mesh)
    images = torch.from_numpy(frames())
    built = []
    init = batch.StepProgram.__init__

    def spy(self, tracker_, state, inputs):
        built.append((tracker_, state.generator))
        init(self, tracker_, state, inputs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(batch.StepProgram, "__init__", spy)
        state, out = tracker.track(torch.Generator().manual_seed(8), images, np.ones(T - 1))
    assert [t for t, _ in built] == tracker.parts
    assert [g for _, g in built] == [part.generator for part in state.parts]
    want = tracker.initialize(torch.Generator().manual_seed(8), images[0])
    outs = []
    for i in range(T - 1):
        want, step_out = tracker.step(want, images[1 + i], torch.tensor(1.0))
        outs.append(step_out)
    for k in out:
        assert torch.equal(out[k], torch.stack([o[k] for o in outs])), k
    for mine, theirs in zip(state.parts, want.parts):
        for name in batch.STATE_FIELDS:
            assert torch.equal(getattr(mine, name), getattr(theirs, name)), name
        assert torch.equal(mine.generator.get_state(), theirs.generator.get_state())
    assert all(part._programs == {} for part in tracker.parts)


def test_kept_outputs_are_the_steps_own(monkeypatch) -> None:
    """Every output ``track_stream`` hands back, read after the run, equals
    the snapshot taken as its step returned, and shares no memory with the
    program's buffers or with another step's outputs."""
    tracker = make_tracker(return_covariances=True)
    images = frames()
    snapshots, programs = [], []
    program_call = batch.StepProgram.__call__

    def spy(self, state, inputs):
        new_state, out = program_call(self, state, inputs)
        snapshots.append({k: v.clone() for k, v in out.items()})
        programs.append(self)
        return new_state, out

    monkeypatch.setattr(batch.StepProgram, "__call__", spy)
    _, outputs = tracker.track_stream(torch.Generator().manual_seed(9), images[0], iter(images[1:]), np.ones(T - 1))
    assert len(snapshots) == T - 2 and len(set(map(id, programs))) == 1
    kept = outputs[1:]  # the first step ran eagerly
    for out, snapshot in zip(kept, snapshots):
        for k in snapshot:
            assert torch.equal(out[k], snapshot[k]), k
    buffers = [getattr(programs[0].state, name) for name in batch.STATE_FIELDS] + list(programs[0].buffers.values())
    pointers = [v.data_ptr() for out in kept for v in out.values()]
    assert len(set(pointers)) == len(pointers)
    assert not set(pointers) & {b.data_ptr() for b in buffers}


def test_programs_are_cached_by_generator_and_noise_keys() -> None:
    """A key's first step runs eagerly and its second builds the program,
    which later steps reuse; other injected draws or a new generator make
    another key, and so another program. ``_release`` drops them."""
    tracker = make_tracker()
    images = torch.from_numpy(frames())
    dt = torch.tensor(1.0)
    draws = {k: torch.from_numpy(v) for k, v in noise().items() if k != "init"}

    def advance(state, i, **kwargs):
        return tracker._advance(state, images[1 + i], dt, **kwargs)[0]

    state = tracker.initialize(torch.Generator().manual_seed(0), images[0])
    state = advance(state, 0)
    assert list(tracker._programs.values()) == [None]
    state = advance(advance(state, 1), 2)
    (first,) = tracker._programs.values()
    assert isinstance(first, batch.StepProgram) and first.generator is state.generator
    state = advance(advance(state, 3, noise={"a": draws["a"][3]}), 4, noise={"a": draws["a"][4]})
    programs = [p for p in tracker._programs.values() if p is not None]
    assert len(programs) == 2 and programs[0] is first and programs[1].buffers.keys() == {"images", "dt", "a"}
    other = tracker.initialize(torch.Generator().manual_seed(0), images[0])
    other = advance(advance(other, 0), 1)
    programs = [p for p in tracker._programs.values() if p is not None]
    assert len(programs) == 3 and programs[2].generator is other.generator is not state.generator
    with pytest.raises(ValueError, match="another generator"):
        first(other, batch._step_inputs(tracker.config, images[1], dt, {}, None, None))
    tracker._release()
    assert tracker._programs == {}


def test_program_run_follows_the_reference() -> None:
    """The JAX package's ``track`` on the same frames, masks, late observer
    and injected draws: step 1 within 1e-3 and the run within 1e-2, as
    tests/test_torch_tracker.py holds the port to it."""
    images, draws = frames(2), noise()
    masks = np.ones((T - 1, 2), np.float32)
    masks[0, 1] = 0.0
    mask0 = np.float32([1.0, 0.0])
    reference = jax_batch.BatchTracker(
        np.stack([camera()] * 2), [None, None], [0.3, 0.3],
        jax_batch.BatchMotion(dem=jax_batch.DeviceRaster(**FLAT), dem_sigma=jax_batch.DeviceRaster(**FLAT), **MOTION),
        jax_batch.BatchConfig(**SETTINGS),
    )
    _, ref_out = reference.track(jax.random.PRNGKey(0), images, np.ones(T - 1, np.float32), noise=draws,
                                 obs_masks=masks, obs_mask0=mask0)
    tracker = make_tracker(n_observers=2)
    _, out = tracker.track(torch.Generator().manual_seed(0), images, np.ones(T - 1), noise=draws,
                           obs_masks=masks, obs_mask0=mask0)
    ref_mean = np.asarray(ref_out["mean"])
    np.testing.assert_allclose(out["mean"][0].numpy(), ref_mean[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out["mean"].numpy(), ref_mean, atol=1e-2, rtol=0)
    np.testing.assert_allclose(out["sigma"].numpy(), np.asarray(ref_out["sigma"]), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]))
