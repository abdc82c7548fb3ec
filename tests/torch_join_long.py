"""Stabilize, then track, over the full 1,000 frames on the CPU: the JAX
package beside the port, at a cut width.

``benchmarks/columbia_pipeline.py`` reported 22.78 (world units) of
stabilized tracking RMSE for its own run on a TPU; ``chip_smoke.py`` phase 24
reports about 0.31 for the port on an H100 on the recipe rebuilt from JPEG
frames. This script runs both packages' ``track_stream`` on the CPU, through
all frames, on the same frames, cameras and starts, so that the two figures
can be read against each other:

- the reference's own frames (``SceneRenderer.render``, float, as the
  pipeline tracks them), through the true per-frame cameras and through the
  nominal camera (the pipeline's unstabilized run), in both packages;
- the port's frames as phase 24 tracks them (``chip_smoke.
  stabilization_scene``, uint8, written as JPEG at quality 95 and decoded),
  through the true cameras, in both packages.

The starts are the pipeline's (``_tracking_setup``'s draws from seed 42 after
the wobble). The generators differ (a JAX key, a torch generator), so the
two packages' RMSEs agree as statistics, not bit for bit. Each run prints
its final RMSE against the truth and its seconds; the last line is one JSON
object of them all.

With ``--observers 2`` the script runs ``main_two_observers`` instead, as
``chip_smoke.py`` phase 25 does: observer A fires at even steps and B (the
west station) at odd ones, each on its own JPEG frames of the port's scene,
and both packages' ``track_stream`` follow the union timeline with phase 25's
``obs_masks`` and a (T, 2, 20) ``camera_vectors_seq``: the fitted cameras
phase 25 saved (``--cameras chiprun_out/phase25_cameras.npy``, when given),
the true cameras, and none (the nominal cameras).

Run from the root of a checkout, with JAX on the CPU:
``JAX_PLATFORMS=cpu python tests/torch_join_long.py [--points 64]
[--particles 512] [--frames 1000] [--observers 2 [--cameras PATH]]``.
"""
import argparse
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jpeg_round_trip(frames: np.ndarray) -> np.ndarray:
    """Each uint8 frame written as a JPEG at quality 95, as phase 18 writes
    them, and decoded."""
    import PIL.Image

    out = np.empty_like(frames)
    for i, frame in enumerate(frames):
        buffer = io.BytesIO()
        PIL.Image.fromarray(frame).save(buffer, format="JPEG", quality=95)
        out[i] = np.asarray(PIL.Image.open(io.BytesIO(buffer.getvalue())).convert("L"))
    return out


def reference_tracker(bases, starts, n_particles):
    import jax.numpy as jnp

    from glimpse_tpu.track.batch import BatchConfig, BatchMotion, BatchTracker, DeviceRaster

    n = len(starts)
    motion = BatchMotion(
        kind="cartesian", xy=jnp.asarray(starts, jnp.float32), xy_sigma=jnp.full((n, 2), 1.0, jnp.float32),
        v_mean=jnp.zeros((n, 3), jnp.float32), v_sigma=jnp.full((n, 3), 0.5, jnp.float32).at[:, 2].set(0.0),
        a_mean=jnp.zeros((n, 3), jnp.float32), a_sigma=jnp.full((n, 3), 0.05, jnp.float32).at[:, 2].set(0.0),
        slope_sigma=jnp.zeros((n,), jnp.float32), dem=DeviceRaster.constant(0.0),
        dem_sigma=DeviceRaster.constant(0.0), use_dem_sigma=False,
    )
    config = BatchConfig(n_particles=n_particles, template_size=(15, 15), search_size=(31, 31))
    O = len(bases)
    return BatchTracker(camera_vectors=bases, corrections=[None] * O, sigmas=[0.3] * O, motion=motion, config=config)


def run_reference(problem, seq, starts, n_particles, chunk):
    """The JAX package's ``track_stream`` on a problem (nominal cameras (O,
    20), the template frame (O, H, W), a function of the frame (O, H, W) at
    steps 1..T-1, T, obs_masks or None)."""
    import jax

    bases, first, frame_at, T, masks = problem
    tracker = reference_tracker(bases, starts, n_particles)
    _, outputs = tracker.track_stream(
        jax.random.PRNGKey(0), first.astype(np.float32), (frame_at(t).astype(np.float32) for t in range(1, T)),
        np.ones(T - 1, np.float32), camera_vectors_seq=seq, obs_masks=masks, chunk=chunk,
    )
    return np.asarray(outputs[-1]["mean"][-1], np.float64)


def run_port(problem, seq, starts, n_particles, chunk):
    import torch

    from chip_smoke import columbia_tracker

    bases, first, frame_at, T, masks = problem
    tracker = columbia_tracker(bases, None, starts, n_particles, torch.device("cpu"))
    _, outputs = tracker.track_stream(
        torch.Generator().manual_seed(0), first, (frame_at(t) for t in range(1, T)),
        np.ones(T - 1, np.float32), camera_vectors_seq=seq, obs_masks=masks, chunk=chunk,
    )
    return outputs[-1]["mean"][-1].double().numpy()


def one_observer(frames, base):
    """A one-observer problem over ``frames`` (T, H, W)."""
    return base[None], frames[0][None], lambda t: frames[t][None], len(frames), None


def two_observers(T: int, cameras=None):
    """Phase 25's problem on the CPU: each observer's frames (the port's
    scene at its fire steps, through JPEG), the masks, and the true and (from
    ``cameras``, a (T, 2, 20) array) fitted camera sequences."""
    from chip_smoke import CAM_B_VIEWDIR, CAM_B_XYZ, STAB_CAM_XYZ, STAB_IMG, STAB_VIEWDIR, stabilization_scene

    fires = [np.arange(0, T, 2), np.arange(1, T, 2)]
    stations = [dict(cam_xyz=STAB_CAM_XYZ, viewdir=STAB_VIEWDIR, jitter_seed=42),
                dict(cam_xyz=CAM_B_XYZ, viewdir=CAM_B_VIEWDIR, jitter_seed=43)]
    frames, bases, truths = [], [], []
    for steps, station in zip(fires, stations):
        rendered, truth, base, _ = stabilization_scene(len(steps), "cpu", steps=steps, **station)
        frames.append(jpeg_round_trip(rendered))
        bases.append(base)
        truths.append(truth)
    bases = np.stack(bases)
    true_seq = np.tile(bases, (T, 1, 1))
    for o, steps in enumerate(fires):
        true_seq[steps, o, 3:6] = truths[o]
    true_seq[0, 1] = true_seq[1, 1]  # B's template frame is its first fire
    fitted = None
    if cameras is not None:
        fitted = np.load(cameras)
        others = np.delete(fitted, [3, 4, 5], axis=-1)
        if fitted.shape != (T, 2, 20) or not np.array_equal(others, np.delete(np.tile(bases, (T, 1, 1)), [3, 4, 5], axis=-1)):
            raise AssertionError(f"{cameras}: not phase 25's cameras for {T} steps")
    steps_1 = np.arange(1, T)
    masks = np.stack([steps_1 % 2 == 0, steps_1 % 2 == 1], axis=1).astype(np.float32)
    zero = np.zeros((STAB_IMG, STAB_IMG), np.uint8)

    def frame_at(t):
        image = frames[t % 2][t // 2]
        return np.stack([image, zero] if t % 2 == 0 else [zero, image])

    first = np.stack([frames[0][0], frames[1][0]])
    return (bases, first, frame_at, T, masks), true_seq, fitted


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--points", type=int, default=64)
    parser.add_argument("--particles", type=int, default=512)
    parser.add_argument("--frames", type=int, default=1000)
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--observers", type=int, choices=(1, 2), default=1)
    parser.add_argument("--cameras", help="phase 25's fitted cameras, a (T, 2, 20) .npy (two observers only)")
    args = parser.parse_args(argv)

    import faulthandler

    from benchmarks.columbia_pipeline import SceneRenderer
    from chip_smoke import join_points, stabilization_scene

    faulthandler.cancel_dump_traceback_later()  # armed by the pipeline's module for its unattended runs

    T = args.frames
    starts, truth = join_points(args.points, T)
    if args.observers == 2:
        start = time.perf_counter()
        problem, true_seq, fitted = two_observers(T, args.cameras)
        print(f"frames: {T} union steps of two observers through JPEG, {time.perf_counter() - start:.1f} s", flush=True)
        cases = [(f"two observers, {name}, {label}", package, problem, seq)
                 for name, seq in (("fitted cameras", fitted), ("true cameras", true_seq), ("nominal cameras", None))
                 if name != "fitted cameras" or fitted is not None
                 for label, package in (("JAX package", run_reference), ("port", run_port))]
        return report(cases, starts, truth, args)
    rng = np.random.default_rng(42)
    true_viewdirs = np.tile(np.asarray((0.0, -35.0, 0.0)), (T, 1))
    true_viewdirs[1:] += rng.normal(0, (0.1, 0.1, 0.03), size=(T - 1, 3))

    start = time.perf_counter()
    renderer = SceneRenderer(seed=0)
    rendered = np.stack([renderer.render(i, true_viewdirs[i]) for i in range(T)]).astype(np.float32)
    jpeg, scene_viewdirs, base, _ = stabilization_scene(T, "cpu")
    jpeg = jpeg_round_trip(jpeg)
    if not np.allclose(scene_viewdirs, true_viewdirs) or not np.allclose(base, renderer.base_vector):
        raise AssertionError("the port's scene and the reference's renderer disagree on the cameras")
    print(f"frames: {T} rendered by the reference, {T} by the port through JPEG, {time.perf_counter() - start:.1f} s",
          flush=True)
    true_seq = np.tile(base, (T, 1))
    true_seq[:, 3:6] = true_viewdirs
    true_seq = true_seq[:, None]

    rendered, jpeg = one_observer(rendered, base), one_observer(jpeg, base)
    report([
        ("reference frames, true cameras, JAX package", run_reference, rendered, true_seq),
        ("reference frames, true cameras, port", run_port, rendered, true_seq),
        ("reference frames, nominal camera, JAX package", run_reference, rendered, None),
        ("reference frames, nominal camera, port", run_port, rendered, None),
        ("JPEG frames, true cameras, JAX package", run_reference, jpeg, true_seq),
        ("JPEG frames, true cameras, port", run_port, jpeg, true_seq),
    ], starts, truth, args)


def report(cases, starts, truth, args) -> None:
    """Each case (name, package's runner, problem, camera sequence) run and
    its final RMSE printed; then one JSON line of them all."""
    runs = {}
    for name, package, problem, seq in cases:
        start = time.perf_counter()
        final = package(problem, seq, starts, args.particles, args.chunk)
        if final.shape != (args.points, 6) or not np.isfinite(final).all():
            raise AssertionError(f"{name}: final means {final.shape}, finite {np.isfinite(final).all()}")
        error = np.sqrt(np.sum((final[:, 0:2] - truth) ** 2, axis=-1))
        runs[name] = {"rmse": float(np.sqrt(np.mean(error ** 2))), "median": float(np.median(error)),
                      "max": float(error.max()), "seconds": time.perf_counter() - start}
        print(f"{name}: final RMSE {runs[name]['rmse']:.4f}, median {runs[name]['median']:.4f}, max"
              f" {runs[name]['max']:.4f} ({runs[name]['seconds']:.1f} s)", flush=True)
    print(json.dumps({"points": args.points, "particles": args.particles, "frames": args.frames,
                      "observers": args.observers, "runs": runs}))


if __name__ == "__main__":
    main()
