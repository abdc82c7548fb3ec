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
import sys
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


def test_get_mesh_without_a_card_raises(monkeypatch) -> None:
    """With no CUDA device and no ``devices``, get_mesh raises and names the
    CPU mesh to ask for; it does not carry on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
        parallel.get_mesh()
    assert parallel.get_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)


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
    """``got``, a mesh's state (its slices joined here) or a plain one,
    equals the plain state ``want`` bit for bit."""
    for name in STATE_FIELDS:
        value = got.joined(name, "cpu") if isinstance(got, parallel.MeshState) else getattr(got, name)
        torch.testing.assert_close(value, getattr(want, name), rtol=0, atol=0, msg=name)
    assert got.step == want.step


@pytest.mark.parametrize("k", [3, 4])
def test_tracker_on_a_mesh_equals_the_tracker_without(scene, k) -> None:
    """N = 37 points (not divisible by k) x 64 particles x 4 steps, from
    injected draws: means, sigmas, validity and the final state (a
    ``MeshState``, its slices joined here) equal the unsliced run's bit for
    bit; the counterpart of the reference's ``tests/test_batch_tracker.py:96``."""
    _, images, noise, _ = scene
    dts = np.ones(T - 1)
    state, out = make_tracker(scene).track(torch.Generator().manual_seed(0), images, dts, noise=noise)
    sliced = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * k))
    assert isinstance(sliced, parallel.MeshTracker) and isinstance(sliced, batch.BatchTracker)
    assert [part.motion.n_points for part in sliced.parts] == [
        s.stop - s.start for s in parallel.points_sharding(sliced.mesh).slices(N)
    ]
    mesh_state, mesh_out = sliced.track(torch.Generator().manual_seed(0), images, dts, noise=noise)
    assert isinstance(mesh_state, parallel.MeshState) and len(mesh_state.parts) == k
    for key in out:
        torch.testing.assert_close(mesh_out[key], out[key], rtol=0, atol=0)
    assert_same_state(mesh_state, state)
    assert mesh_state.step == T - 1


def test_tracker_on_a_mesh_checkpoints_and_resumes(scene, tmp_path) -> None:
    """A 3-slice tracker's ``MeshState`` saved after 2 steps with
    ``track.checkpoint`` and resumed for 2 more gives the outputs and final
    state of the unsliced tracker's 4 uninterrupted steps, bit for bit."""
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
            assert isinstance(resumed, parallel.MeshState) and len(resumed.parts) == 3
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



def test_each_slice_keeps_its_state_generator_and_images_on_its_device(scene, monkeypatch) -> None:
    """Each slice's state, generator and frame are on the slice's device
    (one entry of the mesh), each slice has a generator of its own, and a
    step hands each slice its own state and joins none: the state a slice
    gets is the one it returned."""
    _, images, _, _ = scene
    tracker = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * 3))
    seen = []
    for part in tracker.parts:
        def spy(state, frame, dt, part=part, step=part.step, **kwargs):
            seen.append((part, state, frame))
            return step(state, frame, dt, **kwargs)

        monkeypatch.setattr(part, "step", spy)
    frames = torch.as_tensor(images, dtype=torch.float32)
    state = tracker.initialize(torch.Generator().manual_seed(0), frames[0])
    assert isinstance(state, parallel.MeshState) and len(state.parts) == 3
    generators = [part.generator for part in state.parts]
    assert len({id(g) for g in generators}) == 3
    for _ in range(2):
        given = state
        state, _ = tracker.step(state, frames[1], 1.0)
        assert [s for _, s, _ in seen[-3:]] == given.parts
        for (part, part_state, frame), generator, mine in zip(seen[-3:], generators, state.parts):
            assert part_state.generator is generator is mine.generator
            assert generator.device == frame.device == part.device
            for name in STATE_FIELDS:
                assert getattr(part_state, name).device == part.device
    for mine, points in zip(state.parts, tracker.slices):
        assert mine.particles.shape[0] == points.stop - points.start


def test_slice_generators_are_drawn_from_the_callers_generator() -> None:
    """The slices' generators depend on the caller's generator state and
    the slice's index only, and the caller's generator is not advanced."""
    generator = torch.Generator().manual_seed(5)
    before = generator.get_state()
    first = [g.initial_seed() for g in parallel.slice_generators(generator, ["cpu"] * 3)]
    assert torch.equal(generator.get_state(), before)
    assert first == [g.initial_seed() for g in parallel.slice_generators(generator, ["cpu"] * 3)]
    assert len(set(first)) == 3
    other = [g.initial_seed() for g in parallel.slice_generators(torch.Generator().manual_seed(6), ["cpu"] * 3)]
    assert not set(first) & set(other)


def test_mesh_checkpoint_resumes_the_slices_generators(scene, tmp_path) -> None:
    """Without injected draws every slice draws from its own generator: a
    3-slice run saved after 2 steps and resumed for 2 equals the 4
    uninterrupted steps bit for bit, and the resumed slices' generators sit
    on the saved devices."""
    _, images, _, _ = scene
    tracker = make_tracker(scene, parallel.get_mesh(devices=["cpu"] * 3))
    frames = torch.as_tensor(images, dtype=torch.float32)

    def run(state, lo, hi):
        outs = []
        for t in range(lo, hi):
            state, out = tracker.step(state, frames[1 + t], 1.0)
            outs.append(out)
        return state, outs

    whole, whole_outs = run(tracker.initialize(torch.Generator().manual_seed(3), frames[0]), 0, T - 1)
    half, _ = run(tracker.initialize(torch.Generator().manual_seed(3), frames[0]), 0, 2)
    checkpoint.save_state(half, tmp_path / "mesh.npz")
    restored = checkpoint.load_state(tmp_path / "mesh.npz")
    assert [p.generator.device for p in restored.parts] == list(tracker.mesh.devices)
    assert all(torch.equal(a.generator.get_state(), b.generator.get_state()) for a, b in zip(restored.parts, half.parts))
    resumed, resumed_outs = run(restored, 2, T - 1)
    for a, b in zip(resumed_outs, whole_outs[2:]):
        for key in b:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    for got, want in zip(resumed.parts, whole.parts):
        for name in STATE_FIELDS:
            torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)
    with pytest.raises(ValueError, match="3 mesh slices"):
        checkpoint.load_state(tmp_path / "mesh.npz", device=["cpu"] * 2)
    with pytest.raises(ValueError, match="cpu generator"):
        checkpoint.load_state(tmp_path / "mesh.npz", device=["cpu", "cpu", "cuda"])


def test_the_two_cuts_of_the_points_axis() -> None:
    """A mesh in one process cuts by ``numpy.array_split``; processes cut
    ceil-divided, as the reference does (the module's docstring)."""
    mesh = parallel.get_mesh(devices=["cpu"] * 4)
    assert [s.stop - s.start for s in parallel.points_sharding(mesh).slices(10)] == [3, 3, 2, 2]
    per_rank = []
    for rank in range(4):
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(parallel.mesh, "_world", lambda rank=rank: (4, rank))
            per_rank.append(parallel.local_points_slice(10))
    assert per_rank == [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
    # One process, no group: every point is local and gathering returns it.
    assert parallel.local_points_slice(10) == slice(0, 10)
    local = torch.arange(10.0)
    assert parallel.gather_points(local, 10) is local


# ---- The two-process run: one process a slice, over gloo ---- #


def port_track_slice(frames, starts, n_particles, noise, points: slice, imgsz,
                     dtype=torch.float32) -> np.ndarray:
    """``tests/multihost_worker.track_slice`` through the port on the CPU:
    means (T-1, n_local, 6) of points[points] from injected draws, tracked
    in ``dtype`` and widened exactly to float32 (at least)."""
    from glimpse_tpu_torch import Camera

    cam = Camera(imgsz=imgsz, f=imgsz, xyz=(imgsz / 2, imgsz / 2, imgsz), viewdir=(0, -90, 0))
    n = len(starts[points])
    v_sigma = np.full((n, 3), 1.0)
    v_sigma[:, 2] = 0.0
    a_sigma = np.full((n, 3), 0.2)
    a_sigma[:, 2] = 0.0
    dem = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    motion = convert.motion_from_numpy({
        "kind": "cartesian", "xy": starts[points], "xy_sigma": np.full((n, 2), 1.0), "v_mean": np.zeros((n, 3)),
        "v_sigma": v_sigma, "a_mean": np.zeros((n, 3)), "a_sigma": a_sigma, "slope_sigma": np.zeros(n),
        "dem": dem, "dem_sigma": dem, "use_dem_sigma": False,
    }, "cpu")
    config = batch.BatchConfig(n_particles=n_particles, template_size=(11, 11), search_size=(25, 25), dtype=dtype)
    tracker = batch.BatchTracker(cam.to_array()[None], [None], [0.3], motion, config, device="cpu")
    _, out = tracker.track(
        torch.Generator().manual_seed(0), frames[:, None], np.ones(len(frames) - 1, np.float32),
        noise={
            "init": {"xy": noise["init_xy"][points].astype(np.float32),
                     "v": noise["init_v"][points].astype(np.float32)},
            "a": noise["a"][:, points].astype(np.float32),
            "resample_u": noise["resample_u"][:, points].astype(np.float32),
        },
    )
    mean = out["mean"]
    return (mean.float() if mean.element_size() == 2 else mean).numpy()


N_MULTI, T_MULTI = 8, 6


def carried_steps(frames, starts, n_particles, noise, imgsz) -> np.ndarray:
    """The port's means (T-1, N, 6) of ``tests/multihost_worker.track_slice``'s
    problem, each step taken from the JAX package's carried state."""
    from glimpse_tpu import Camera as RefCamera
    from glimpse_tpu.track import batch as jax_batch

    n = len(starts)
    cam = RefCamera(imgsz=imgsz, f=imgsz, xyz=(imgsz / 2, imgsz / 2, imgsz), viewdir=(0, -90, 0)).to_array()
    motion = make_motion(starts, v_sigma=1.0)
    motion.xy_sigma = jax.numpy.ones((n, 2), jax.numpy.float32)
    config = dict(n_particles=n_particles, template_size=(11, 11), search_size=(25, 25))
    reference = jax_batch.BatchTracker(cam[None], [None], [0.3], motion, jax_batch.BatchConfig(**config))
    port = batch.BatchTracker(cam[None], [None], [0.3], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
                              batch.BatchConfig(**config), device="cpu")
    state = reference.initialize(jax.random.PRNGKey(0), frames[:1], noise={
        "xy": noise["init_xy"].astype(np.float32), "v": noise["init_v"].astype(np.float32)})
    means = []
    for i in range(len(frames) - 1):
        step_noise = {"a": noise["a"][i].astype(np.float32), "resample_u": noise["resample_u"][i].astype(np.float32)}
        leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        _, out = port.step(convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(frames[1 + i : 2 + i]),
                           torch.tensor(1.0), noise=step_noise)
        means.append(out["mean"].numpy())
        state, _ = reference.step(state, frames[1 + i : 2 + i], np.float32(1.0), noise=step_noise)
    return np.stack(means)


def worker(rank: int, world: int, port: int, outdir: str, dtype_name: str = "float32") -> None:
    """One process of the two-process run: join the group over gloo, track
    this process's ``local_points_slice`` in ``dtype_name``, stitch every
    process's means with ``gather_points`` (in that dtype) and sum them
    with one ``all_reduce``."""
    import torch.distributed as dist

    import multihost_worker

    parallel.initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank)
    assert dist.get_backend() == "gloo"
    imgsz, _, frames, starts, n_particles, noise = multihost_worker.tracking_problem(N_MULTI, T_MULTI)
    points = parallel.local_points_slice(N_MULTI)
    dtype = getattr(torch, dtype_name)
    # The widened means narrow back exactly to the tracked dtype.
    means = torch.from_numpy(port_track_slice(frames, starts, n_particles, noise, points, imgsz, dtype)).to(dtype)
    stitched = parallel.gather_points(means, N_MULTI, axis=1)
    assert stitched.dtype == dtype
    total = means.double().sum(dim=(0, 1))
    dist.all_reduce(total)
    np.save(f"{outdir}/stitched_{rank}.npy", stitched.float().numpy())
    np.save(f"{outdir}/total_{rank}.npy", total.numpy())
    np.save(f"{outdir}/slice_{rank}.npy", np.array([points.start, points.stop]))
    dist.destroy_process_group()


def test_two_processes_over_gloo_equal_one_process(tmp_path) -> None:
    """The counterpart of ``tests/test_parallel.py::test_two_process_distributed_tracking``
    on its problem (8 points x 64 particles x 6 frames): two processes, each
    on its ``local_points_slice``, joined with ``initialize_distributed``'s
    default backend (gloo). The means every process stitches equal the
    single-process port run bit for bit; the collective's sum is the same on
    both processes.

    Against the JAX package's single-process ``track_slice``: every step
    from the reference's carried state within 1e-4, and the free run within
    1e-4 for its first four steps. At the fifth, one of point 6's 64
    resampled rows crosses a systematic threshold that float32 rounding
    moves (the port's weights differ from the reference's in the last
    bits), and that point's mean parts by 0.0103; the whole free run is
    held as chip_smoke phase 7 holds one (1e-3 at step 1, 1e-2 for the
    median point, 0.5 for the worst)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    import multihost_worker as mw

    tests = Path(__file__).parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([str(tests.parent), str(tests)]))
    procs = [
        subprocess.Popen([sys.executable, __file__, "worker", str(rank), "2", str(port), str(tmp_path)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)
    ]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err.decode()[-3000:]
    imgsz, _, frames, starts, n_particles, noise = mw.tracking_problem(N_MULTI, T_MULTI)
    whole = port_track_slice(frames, starts, n_particles, noise, slice(0, N_MULTI), imgsz)
    reference = mw.track_slice(frames, starts, n_particles, noise, slice(0, N_MULTI), imgsz)
    assert [tuple(np.load(tmp_path / f"slice_{r}.npy")) for r in range(2)] == [(0, 4), (4, 8)]
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"stitched_{rank}.npy"), whole)
    np.testing.assert_allclose(whole[:4], reference[:4], atol=1e-4, rtol=0)
    per_point = np.abs(whole - reference).max(axis=(0, 2))
    assert np.abs(whole[0] - reference[0]).max() <= 1e-3 and np.median(per_point) <= 1e-2 and per_point.max() <= 0.5
    np.testing.assert_allclose(carried_steps(frames, starts, n_particles, noise, imgsz), reference, atol=1e-4, rtol=0)
    totals = [np.load(tmp_path / f"total_{rank}.npy") for rank in range(2)]
    np.testing.assert_array_equal(totals[0], totals[1])
    np.testing.assert_allclose(totals[0], whole.astype(np.float64).sum(axis=(0, 1)), rtol=1e-9)


def test_two_processes_over_gloo_in_bfloat16(tmp_path) -> None:
    """The two-process run with the tracker in bfloat16: gloo's
    ``all_gather`` takes bfloat16 tensors as they are, and the means every
    process stitches equal the single-process bfloat16 run bit for bit."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    import multihost_worker as mw

    tests = Path(__file__).parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([str(tests.parent), str(tests)]))
    procs = [
        subprocess.Popen([sys.executable, __file__, "worker", str(rank), "2", str(port), str(tmp_path), "bfloat16"],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)
    ]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err.decode()[-3000:]
    imgsz, _, frames, starts, n_particles, noise = mw.tracking_problem(N_MULTI, T_MULTI)
    whole = port_track_slice(frames, starts, n_particles, noise, slice(0, N_MULTI), imgsz, torch.bfloat16)
    assert np.isfinite(whole).all()
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"stitched_{rank}.npy"), whole)
    totals = [np.load(tmp_path / f"total_{rank}.npy") for rank in range(2)]
    np.testing.assert_array_equal(totals[0], totals[1])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], *sys.argv[6:7])
