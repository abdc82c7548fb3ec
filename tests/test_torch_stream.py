"""The port's streamed tracking and checkpoints, on the CPU.

``track_stream`` runs the same steps as ``track`` in the same order, so on
one device it is bit-equal to it, chunked or not, with a late observer's
template step inside a chunk. A checkpoint resumes bit for bit. The
returned list has the reference's format, and a reference snapshot is
refused.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu.track import checkpoint as jax_checkpoint
from glimpse_tpu_torch.track import batch, checkpoint, convert
from test_batch_tracker import make_motion, make_scene

N_FRAMES = 7
SETTINGS = dict(n_particles=128, template_size=(11, 11), search_size=(25, 25))


@pytest.fixture(scope="module")
def scene():
    """tests/test_batch_tracker.py:1315's scene: observer B fires first at
    step 2, so with chunk 3 its template step lies inside the first chunk."""
    cam, frames, _ = make_scene(n_frames=N_FRAMES, velocity=(1.0, 0.5))
    starts = np.array([[250.0, 250.0], [230.0, 260.0], [270.0, 240.0]])
    present_b = np.array([False, True, False, True, True, True])
    masks = np.stack([np.ones(N_FRAMES - 1), present_b], axis=1).astype(np.float32)
    images = np.repeat(frames[:, None], 2, axis=1)
    cams = np.stack([cam.to_array()] * 2)
    motion = make_motion(starts)
    tracker = batch.BatchTracker(
        cams, [None, None], [0.15, 0.15], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
        batch.BatchConfig(**SETTINGS), device="cpu",
    )
    return tracker, cams, motion, images, masks, np.array([True, False])


def _concat(outputs):
    return {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}


@pytest.fixture(scope="module")
def tracked(scene):
    tracker, _, _, images, masks, mask0 = scene
    dts = np.ones(N_FRAMES - 1, np.float32)
    return tracker.track(torch.Generator().manual_seed(3), images, dts, obs_masks=masks, obs_mask0=mask0)


@pytest.mark.parametrize("chunk, lengths", [(1, [1] * 6), (3, [1, 1, 1, 3]), (4, [1, 1, 1, 1, 2])])
def test_stream_equals_track(scene, tracked, chunk, lengths) -> None:
    tracker, _, _, images, masks, mask0 = scene
    state, out = tracked
    stream_state, outputs = tracker.track_stream(
        torch.Generator().manual_seed(3), images[0], iter(images[1:]), np.ones(N_FRAMES - 1),
        obs_masks=masks, obs_mask0=mask0, chunk=chunk,
    )
    if chunk == 1:
        assert all(o["mean"].shape == (3, 6) for o in outputs)
        outputs = [{k: v[None] for k, v in o.items()} for o in outputs]
    assert [len(o["mean"]) for o in outputs] == lengths
    streamed = _concat(outputs)
    for k in out:
        assert torch.equal(streamed[k], out[k]), k
    assert torch.equal(stream_state.particles, state.particles)
    assert torch.equal(stream_state.templates, state.templates)
    assert stream_state.step == state.step == N_FRAMES - 1


def test_stream_with_per_frame_cameras(scene, tracked) -> None:
    """A constant camera_vectors_seq gives the run without one, bit for bit."""
    tracker, cams, _, images, masks, mask0 = scene
    camseq = np.tile(cams[None], (N_FRAMES, 1, 1))
    _, outputs = tracker.track_stream(
        torch.Generator().manual_seed(3), images[0], iter(images[1:]), np.ones(N_FRAMES - 1),
        camera_vectors_seq=camseq, obs_masks=masks, obs_mask0=mask0, chunk=3,
    )
    assert torch.equal(_concat(outputs)["mean"], tracked[1]["mean"])


def test_stream_format_matches_reference(scene) -> None:
    """The reference's track_stream gives a list of the same length, entry
    by entry of the same shapes, for chunk 1 and 3."""
    tracker, cams, motion, images, masks, mask0 = scene
    reference = jax_batch.BatchTracker(cams, [None, None], [0.15, 0.15], motion, jax_batch.BatchConfig(**SETTINGS))
    for chunk in (1, 3):
        _, ref_outputs = reference.track_stream(
            jax.random.PRNGKey(3), images[0], iter(images[1:]), np.ones(N_FRAMES - 1),
            obs_masks=masks, obs_mask0=mask0, chunk=chunk,
        )
        _, outputs = tracker.track_stream(
            torch.Generator().manual_seed(3), images[0], iter(images[1:]), np.ones(N_FRAMES - 1),
            obs_masks=masks, obs_mask0=mask0, chunk=chunk,
        )
        assert [{k: tuple(v.shape) for k, v in o.items()} for o in outputs] == [
            {k: np.asarray(v).shape for k, v in o.items()} for o in ref_outputs
        ]


def test_checkpoint_resumes_bit_exactly(scene, tracked, tmp_path) -> None:
    """Save after step 3, load, run the rest: the outputs and particles of
    the uninterrupted run, bit for bit; every field round-trips."""
    tracker, _, _, images, masks, mask0 = scene
    _, plan = tracker._template_plan(masks, mask0)
    state = tracker.initialize(torch.Generator().manual_seed(3), torch.from_numpy(images[0]).float(), obs_mask0=mask0)

    def step(state, i):
        return tracker.step(
            state, torch.from_numpy(images[1 + i]).float(), torch.tensor(1.0), obs_mask=masks[i],
            init_template_for=plan.get(i + 1, ()),
        )

    for i in range(3):
        state, _ = step(state, i)
    path = tmp_path / "state.npz"
    checkpoint.save_state(state, path)
    restored = checkpoint.load_state(path)
    for k in ("particles", "weights", "templates", "template_table", "template_duv", "valid"):
        assert torch.equal(getattr(restored, k), getattr(state, k)), k
    assert restored.step == 3
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    outs = []
    for i in range(3, N_FRAMES - 1):
        restored, out = step(restored, i)
        outs.append(out)
    final, uninterrupted = tracked
    for k in uninterrupted:
        assert torch.equal(torch.stack([o[k] for o in outs]), uninterrupted[k][3:]), k
    assert torch.equal(restored.particles, final.particles)


def test_checkpoint_refuses_other_snapshots(scene, tmp_path) -> None:
    """A snapshot of the JAX package is refused with a pointer to
    convert.state_from_numpy; a CPU generator's state does not resume on
    another device type."""
    tracker, cams, motion, images, masks, mask0 = scene
    reference = jax_batch.BatchTracker(cams, [None, None], [0.15, 0.15], motion, jax_batch.BatchConfig(**SETTINGS))
    ref_path = tmp_path / "reference.npz"
    jax_checkpoint.save_state(reference.initialize(jax.random.PRNGKey(0), images[0]), ref_path)
    with pytest.raises(ValueError, match="state_from_numpy"):
        checkpoint.load_state(ref_path)
    path = tmp_path / "port.npz"
    checkpoint.save_state(tracker.initialize(torch.Generator(), torch.from_numpy(images[0]).float()), path)
    with pytest.raises(ValueError, match="cpu generator"):
        checkpoint.load_state(path, device="cuda")
    np.savez(tmp_path / "other.npz", particles=np.zeros(3))
    with pytest.raises(ValueError, match="not a"):
        checkpoint.load_state(tmp_path / "other.npz")
