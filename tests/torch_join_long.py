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

Run from the root of a checkout, with JAX on the CPU:
``JAX_PLATFORMS=cpu python tests/torch_join_long.py [--points 64]
[--particles 512] [--frames 1000]``.
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


def reference_tracker(base, starts, n_particles):
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
    return BatchTracker(camera_vectors=base[None], corrections=[None], sigmas=[0.3], motion=motion, config=config)


def run_reference(frames, base, seq, starts, n_particles, chunk):
    import jax

    tracker = reference_tracker(base, starts, n_particles)
    _, outputs = tracker.track_stream(
        jax.random.PRNGKey(0), frames[0][None].astype(np.float32),
        (frames[i][None].astype(np.float32) for i in range(1, len(frames))), np.ones(len(frames) - 1, np.float32),
        camera_vectors_seq=seq, chunk=chunk,
    )
    return np.asarray(outputs[-1]["mean"][-1], np.float64)


def run_port(frames, base, seq, starts, n_particles, chunk):
    import torch

    from chip_smoke import columbia_tracker

    tracker = columbia_tracker(base[None], None, starts, n_particles, torch.device("cpu"))
    _, outputs = tracker.track_stream(
        torch.Generator().manual_seed(0), frames[0][None], (frames[i][None] for i in range(1, len(frames))),
        np.ones(len(frames) - 1, np.float32), camera_vectors_seq=seq, chunk=chunk,
    )
    return outputs[-1]["mean"][-1].double().numpy()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--points", type=int, default=64)
    parser.add_argument("--particles", type=int, default=512)
    parser.add_argument("--frames", type=int, default=1000)
    parser.add_argument("--chunk", type=int, default=8)
    args = parser.parse_args(argv)

    import faulthandler

    from benchmarks.columbia_pipeline import SceneRenderer
    from chip_smoke import join_points, stabilization_scene

    faulthandler.cancel_dump_traceback_later()  # armed by the pipeline's module for its unattended runs

    T = args.frames
    starts, truth = join_points(args.points, T)
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

    runs = {}
    for name, package, frames, seq in (
        ("reference frames, true cameras, JAX package", run_reference, rendered, true_seq),
        ("reference frames, true cameras, port", run_port, rendered, true_seq),
        ("reference frames, nominal camera, JAX package", run_reference, rendered, None),
        ("reference frames, nominal camera, port", run_port, rendered, None),
        ("JPEG frames, true cameras, JAX package", run_reference, jpeg, true_seq),
        ("JPEG frames, true cameras, port", run_port, jpeg, true_seq),
    ):
        start = time.perf_counter()
        final = package(frames, base, seq, starts, args.particles, args.chunk)
        if final.shape != (args.points, 6) or not np.isfinite(final).all():
            raise AssertionError(f"{name}: final means {final.shape}, finite {np.isfinite(final).all()}")
        error = np.sqrt(np.sum((final[:, 0:2] - truth) ** 2, axis=-1))
        runs[name] = {"rmse": float(np.sqrt(np.mean(error ** 2))), "median": float(np.median(error)),
                      "max": float(error.max()), "seconds": time.perf_counter() - start}
        print(f"{name}: final RMSE {runs[name]['rmse']:.4f}, median {runs[name]['median']:.4f}, max"
              f" {runs[name]['max']:.4f} ({runs[name]['seconds']:.1f} s)", flush=True)
    print(json.dumps({"points": args.points, "particles": args.particles, "frames": T, "runs": runs}))


if __name__ == "__main__":
    main()
