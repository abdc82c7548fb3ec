"""3-D tracking from an oblique camera with DEM uncertainty and fusion, on the port.

The recipe of ``examples/oblique_3d_tracking.py`` on ``glimpse_tpu_torch``:
a time-lapse camera looks obliquely across terrain; surface points move in
3-D, their heights held by a DEM with uncertainty; tracking runs forward and
backward and the two passes fuse by inverse-variance weighting
(``Tracks.from_multiple``). Frames are rendered from the DEM itself with
``render.project_dem``.

Run: python examples/torch_oblique_3d_tracking.py [--device cpu]
(the card by default; a few minutes on a CPU)
"""
import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.ndimage
import torch

from glimpse_tpu_torch import Camera, Raster, Tracks, profiling, render
from glimpse_tpu_torch.track.batch import BatchConfig, BatchMotion, BatchTracker, DeviceRaster, to_tracks


def main(device: str = "cuda") -> float:
    rng = np.random.default_rng(7)
    # Gently undulating DEM (z in meters) with a sharp ortho texture on top.
    z = scipy.ndimage.gaussian_filter(rng.normal(size=(320, 320)), 12.0) * 60
    dem = Raster(z, x=(-200, 600), y=(600, -200))
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(320, 320)), 0.8) * 100
    cam = Camera(imgsz=(320, 240), f=400, xyz=(200, -150, 260), viewdir=(0, -35, 0))

    # Render frames by advecting the texture across the (fixed) DEM.
    velocity = (1.2, 0.8)  # m/day in world x, y
    n_frames = 10
    frames = []
    for i in range(n_frames):
        shifted = scipy.ndimage.shift(
            texture, (velocity[1] * i / dem.d[1], velocity[0] * i / dem.d[0]), order=1, mode="nearest")
        img = render.project_dem(cam, dem, values=shifted[..., None], scale_limits=(1, 8))[..., 0]
        # Inpaint holes (sky, occlusion streaks) from the nearest rendered pixel.
        idx = scipy.ndimage.distance_transform_edt(np.isnan(img), return_distances=False, return_indices=True)
        frames.append(img[tuple(idx)])
    frames = np.stack(frames).astype(np.float32)

    # Points on the surface; DEM prior with 0.5 m uncertainty.
    points_xy = rng.uniform([120, 150], [280, 280], size=(16, 2))
    N = len(points_xy)

    def full(value, width=None, z=None):
        a = np.full((N,) if width is None else (N, width), value, np.float32)
        if z is not None:
            a[:, 2] = z
        return torch.as_tensor(a, device=device)

    motion = BatchMotion(
        kind="cartesian",
        xy=torch.as_tensor(points_xy, dtype=torch.float32, device=device),
        xy_sigma=full(1.0, 2), v_mean=full(0.0, 3), v_sigma=full(1.5, 3, z=0.05),
        a_mean=full(0.0, 3), a_sigma=full(0.1, 3, z=0.01), slope_sigma=full(0.0),
        dem=DeviceRaster.from_raster(dem, device=device), dem_sigma=DeviceRaster.constant(0.5, device=device),
        use_dem_sigma=True,
    )
    tracker = BatchTracker(
        camera_vectors=cam.to_array()[None], corrections=[None], sigmas=[0.2], motion=motion,
        config=BatchConfig(n_particles=512, search_size=(41, 41)), device=device,
    )

    t0 = datetime.datetime(2020, 1, 1)
    day = datetime.timedelta(days=1)
    datetimes = [t0 + i * day for i in range(n_frames)]
    dts = np.ones(n_frames - 1, np.float32)

    # Forward and backward passes, fused by inverse variance.
    timer = profiling.Timer()
    runs = []
    for label, seq in (("forward", frames), ("backward", frames[::-1])):
        generator = torch.Generator(device=device).manual_seed(11)
        with timer(label):
            _, out = tracker.track(generator, seq[:, None], dts)
            profiling.sync(out["mean"])
        run_times = datetimes if label == "forward" else datetimes[::-1]
        tracks = to_tracks(run_times, day, out)
        if label == "backward":
            tracks.reverse()  # restore forward temporal order for fusion
        runs.append(tracks)
        v = tracks.vxyz[:, -1 if label == "forward" else 0, 0:2]
        # Backward runs estimate -v (reverse() reorders time but keeps the sign).
        sign = 1 if label == "forward" else -1
        print(f"{label}: median velocity = {np.median(sign * v, axis=0).round(2)} (true {velocity})")
    fused = Tracks.from_multiple(runs, ignore_nan=True)
    err = float(np.nanmedian(np.abs(fused.xyz[:, -1, 0:2] - (points_xy + np.multiply(velocity, n_frames - 1)))))
    print(f"fused: median final position error = {err:.2f} m")
    xy_final = np.nan_to_num(fused.xyz[:, -1, 0:2], nan=200.0)
    zerr = np.nanmedian(np.abs(fused.xyz[:, -1, 2] - dem.sample(xy_final, bounds_error=False)))
    print(f"fused: median |z - DEM| = {zerr:.2f} m (prior sigma 0.5)")
    print(timer.report())
    assert err < 0.5, "position error too large"
    return err


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(parser.parse_args().device)
