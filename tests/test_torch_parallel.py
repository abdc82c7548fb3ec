"""``glimpse_tpu_torch.parallel`` against ``glimpse_tpu.parallel``, and the
batched tracker on a mesh against the tracker without one, on the CPU.

A mesh here repeats the CPU (``get_mesh(devices=["cpu"] * k)``), the port's
stand-in for the reference's forced host devices. The sliced tracker is
held bit for bit to the unsliced one: every operation of a step is either
elementwise or a per-point reduction, and the CPU's batched products
(the SSE map, the spline prefilter) reduce each point's rows in the same
order whatever the number of points beside it, which these tests pin.

On a card the same holds only within a bound: cuDNN and cuBLAS choose their
algorithms by batch size, so a slice of 2,560 points may round otherwise
than the batch of 10,240. chip_smoke phase 20 holds the sliced run on the
card to the unsliced one as phase 7 holds a free run (1e-3 at step 1, 1e-2
for the median point, 0.5 for the worst); it measured 6.1e-5 at every step
on an H100.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu import parallel as ref_parallel
from glimpse_tpu_torch import parallel
from glimpse_tpu_torch.track import batch, checkpoint, convert
from test_batch_tracker import make_motion, make_scene


def test_local_points_slice_matches_reference() -> None:
    for n in (0, 1, 37, 100):
        assert parallel.mesh.local_points_slice(n) == ref_parallel.mesh.local_points_slice(n)


def test_get_mesh_and_shardings() -> None:
    mesh = parallel.get_mesh(devices=["cpu"] * 3)
    assert mesh.size == len(mesh) == 3 and mesh.axis_names == ("points",)
    assert all(d == torch.device("cpu") for d in mesh)
    assert parallel.get_mesh(n_devices=2, devices=["cpu"] * 3).size == 2
    assert parallel.get_mesh(devices=["cpu"], axis="tracks").axis_names == ("tracks",)
    assert parallel.points_sharding(mesh).slices(37) == [slice(0, 13), slice(13, 25), slice(25, 37)]
    assert parallel.points_sharding(mesh, points_axis_index=1).axis == 1
    assert parallel.replicated_sharding(mesh).mesh is mesh
    with pytest.raises(ValueError):
        parallel.get_mesh(devices=[])


def test_shard_batch_splits_points_and_replicates_the_rest() -> None:
    mesh = parallel.get_mesh(devices=["cpu"] * 3)
    rng = np.random.default_rng(0)
    points = rng.normal(size=(7, 4)).astype(np.float32)
    inner = torch.as_tensor(rng.normal(size=(2, 7, 5)))
    shared = rng.normal(size=(3, 3))
    tree = {"points": points, "stack": (inner, shared)}
    shards = parallel.shard_batch(tree, mesh, points_axes={id(points): 0, id(inner): 1})
    assert len(shards) == 3
    np.testing.assert_array_equal(np.concatenate([s["points"].numpy() for s in shards]), points)
    np.testing.assert_array_equal(torch.cat([s["stack"][0] for s in shards], dim=1).numpy(), inner.numpy())
    for s in shards:
        assert isinstance(s["stack"], tuple)
        np.testing.assert_array_equal(s["stack"][1].numpy(), shared)
    with pytest.raises(ValueError, match="disagree"):
        parallel.shard_batch({"a": points, "b": shared}, mesh, points_axes={id(points): 0, id(shared): 0})


N, P, T = 37, 64, 5  # 4 steps after the template frame


@pytest.fixture(scope="module")
def scene():
    cam, frames, _ = make_scene(n_frames=T, velocity=(2.0, 1.0))
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(N, 2))
    rng = np.random.default_rng(7)
    noise = {
        "init": {
            "xy": rng.normal(size=(N, P, 2)).astype(np.float32),
            "v": rng.normal(size=(N, P, 3)).astype(np.float32),
        },
        "a": rng.normal(size=(T - 1, N, P, 3)).astype(np.float32),
        "resample_u": rng.random((T - 1, N)).astype(np.float32),
    }
    motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(points_xy)), "cpu")
    return cam, frames[:, None], noise, motion


def make_tracker(scene, mesh=None):
    cam, _, _, motion = scene
    config = batch.BatchConfig(n_particles=P, template_size=(15, 15), search_size=(41, 41))
    return batch.BatchTracker(cam.to_array()[None], [None], [0.15], motion, config, device="cpu", mesh=mesh)


STATE_FIELDS = ("particles", "weights", "templates", "template_table", "template_duv", "valid")


def assert_same_state(got, want) -> None:
    assert type(got) is batch.BatchState
    for name in STATE_FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0, msg=name)
    assert got.step == want.step


@pytest.mark.parametrize("k", [3, 4])
def test_tracker_on_a_mesh_equals_the_tracker_without(scene, k) -> None:
    """N = 37 points (not divisible by k) x 64 particles x 4 steps, from
    injected draws: means, sigmas, validity and the final state (a plain
    ``BatchState``, the slices joined) equal the unsliced run's bit for bit;
    the counterpart of the reference's ``tests/test_batch_tracker.py:96``."""
    _, images, noise, _ = scene
    dts = np.ones(T - 1)
    state, out = make_tracker(scene).track(torch.Generator().manual_seed(0), images, dts, noise=noise)
    sliced = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * k))
    assert isinstance(sliced, parallel.MeshTracker) and isinstance(sliced, batch.BatchTracker)
    assert [part.motion.n_points for part in sliced.parts] == [
        s.stop - s.start for s in parallel.points_sharding(sliced.mesh).slices(N)
    ]
    mesh_state, mesh_out = sliced.track(torch.Generator().manual_seed(0), images, dts, noise=noise)
    for key in out:
        torch.testing.assert_close(mesh_out[key], out[key], rtol=0, atol=0)
    assert_same_state(mesh_state, state)
    assert mesh_state.step == T - 1


def test_tracker_on_a_mesh_checkpoints_and_resumes(scene, tmp_path) -> None:
    """A 3-slice tracker saved after 2 steps with ``track.checkpoint`` and
    resumed for 2 more gives the outputs and final state of the unsliced
    tracker's 4 uninterrupted steps, bit for bit."""
    _, images, noise, _ = scene
    state, out = make_tracker(scene).track(torch.Generator().manual_seed(0), images, np.ones(T - 1), noise=noise)
    sliced = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * 3))
    frames = torch.as_tensor(images, dtype=torch.float32)
    resumed = sliced.initialize(torch.Generator().manual_seed(0), frames[0], noise=noise["init"])
    outs = []
    for t in range(T - 1):
        if t == 2:
            checkpoint.save_state(resumed, tmp_path / "mesh.npz")
            resumed = checkpoint.load_state(tmp_path / "mesh.npz")
        resumed, step_out = sliced.step(resumed, frames[1 + t], 1.0,
                                        noise={key: noise[key][t] for key in ("a", "resample_u")})
        outs.append(step_out)
    for key in out:
        torch.testing.assert_close(torch.stack([o[key] for o in outs]), out[key], rtol=0, atol=0)
    assert_same_state(resumed, state)


def test_from_observers_takes_a_mesh_and_the_plain_tracker_none(scene) -> None:
    """``mesh=`` reaches the constructor through ``from_observers``; a
    subclass other than :class:`MeshTracker` refuses a mesh."""
    cam, _, _, motion = scene
    observer = types.SimpleNamespace(images=[types.SimpleNamespace(cam=cam)], sigma=0.15)
    mesh = parallel.get_mesh(devices=["cpu"] * 2)
    tracker = batch.BatchTracker.from_observers([observer], motion, device="cpu", mesh=mesh)
    assert isinstance(tracker, parallel.MeshTracker) and tracker.mesh is mesh and len(tracker.parts) == 2
    assert batch.BatchTracker.from_observers([observer], motion, device="cpu").mesh is None

    class Plain(batch.BatchTracker):
        pass

    with pytest.raises(TypeError, match="takes no mesh"):
        Plain(cam.to_array()[None], [None], [0.15], motion, device="cpu", mesh=mesh)


def test_tracker_on_a_mesh_launches_each_kernel_once_per_slice(scene, monkeypatch) -> None:
    """Each step calls the high-pass and the systematic resample once per
    slice (the wrappers are counted here, where they run their plain
    versions)."""
    calls = {"highpass": 0, "resample": 0}
    highpass, resample = batch.routed_highpass, batch.systematic_resample

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(batch, "routed_highpass", counted("highpass", highpass))
    monkeypatch.setattr(batch, "systematic_resample", counted("resample", resample))
    _, images, noise, _ = scene
    tracker = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * 3))
    state = tracker.initialize(torch.Generator().manual_seed(0), torch.as_tensor(images[0], dtype=torch.float32),
                               noise=noise["init"])
    calls.update(highpass=0, resample=0)
    tracker.step(state, torch.as_tensor(images[1], dtype=torch.float32), 1.0,
                 noise={k: noise[k][0] for k in ("a", "resample_u")})
    assert calls == {"highpass": 3, "resample": 3}

