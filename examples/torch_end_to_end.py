"""End-to-end glimpse_tpu_torch workflow on synthetic data.

The recipe of ``examples/end_to_end.py`` on the port:

1. Build a world texture and render a time-lapse sequence through a camera.
2. Re-calibrate a second camera's view direction from synthetic matches by
   bundle adjustment (``optimize.Cameras``, exact Jacobian on the device).
3. Track a grid of points with the batched particle filter, its points cut
   over a mesh of two slices (``parallel.get_mesh``), and summarize the
   velocities (with uncertainty) as ``Tracks``.

Run: python examples/torch_end_to_end.py [--device cpu]  (the card by default)
"""
import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import scipy.ndimage
import torch

import glimpse_tpu_torch as gt
from glimpse_tpu_torch import optimize, parallel, profiling
from glimpse_tpu_torch.track.batch import BatchConfig, BatchMotion, BatchTracker, DeviceRaster, to_tracks

DAY = datetime.timedelta(days=1)
T0 = datetime.datetime(2020, 1, 1)


def make_scene(n_frames=6, velocity=(2.0, 1.0), imgsz=256, seed=0):
    """Nadir camera over a drifting ground texture."""
    rng = np.random.default_rng(seed)
    world = scipy.ndimage.gaussian_filter(rng.normal(size=(500, 500)), 0.8) * 100
    texture = gt.Raster(world, x=(0, 500), y=(500, 0))
    cam = gt.Camera(imgsz=imgsz, f=300, xyz=(250, 250, 300), viewdir=(0, -90, 0))
    uv = cam.grid(step=1, mode="points")
    rays = cam.uv_to_xyz(uv)
    ground = cam.xyz + rays * (-cam.xyz[2] / rays[:, 2])[:, None]
    frames = []
    for i in range(n_frames):
        shifted = ground[:, 0:2] - np.asarray(velocity) * i
        frames.append(texture.sample(shifted, bounds_error=False, fill_value=0.0).reshape(imgsz, imgsz))
    return cam, np.stack(frames)


def main(device: str = "cuda"):
    timer = profiling.Timer()
    velocity = (2.0, 1.0)
    with timer("render"):
        cam, frames = make_scene(velocity=velocity)

    # --- Calibration: recover an unknown second-camera rotation -----------
    rotation = np.array([0.5, -0.3, 0.2])
    cam_true = cam.copy()
    cam_true.viewdir = np.array(cam.viewdir) + rotation
    rng = np.random.default_rng(1)
    uvA = rng.uniform(40, 216, size=(60, 2))
    uvB = cam_true.xyz_to_uv(cam.uv_to_xyz(uvA), directions=True)
    keep = np.isfinite(uvB).all(axis=1)
    cam_guess = cam.copy()  # starts at the unrotated view direction
    matches = optimize.Matches(cams=(cam, cam_guess), uvs=[uvA[keep], uvB[keep]])
    model = optimize.Cameras(cams=[cam_guess], controls=[matches], cam_params=[{"viewdir": True}], device=device)
    with timer("calibration"):
        model.set_cameras(model.fit(jac="exact"))
    print("calibration: viewdir error =", np.abs(cam_guess.viewdir - cam_true.viewdir).max(), "deg")

    # --- Tracking: batched particle filter on a mesh of two slices --------
    n_points = 64
    points_xy = rng.uniform(180, 320, size=(n_points, 2)).astype(np.float32)

    def full(value, width, z=None):
        a = np.full((n_points, width), value, np.float32)
        if z is not None:
            a[:, 2] = z
        return torch.as_tensor(a, device=device)

    motion = BatchMotion(
        kind="cartesian", xy=torch.as_tensor(points_xy, device=device), xy_sigma=full(1.5, 2),
        v_mean=full(0.0, 3), v_sigma=full(3.0, 3, z=0.0), a_mean=full(0.0, 3), a_sigma=full(0.2, 3, z=0.0),
        slope_sigma=torch.zeros(n_points, device=device), dem=DeviceRaster.constant(0.0, device=device),
        dem_sigma=DeviceRaster.constant(0.0, device=device), use_dem_sigma=False,
    )
    tracker = BatchTracker(
        camera_vectors=cam.to_array()[None], corrections=[None], sigmas=[0.15], motion=motion,
        config=BatchConfig(n_particles=512, search_size=(41, 41)), device=device,
        mesh=parallel.get_mesh(devices=[device] * 2),
    )
    n_frames = frames.shape[0]
    with timer("tracking"):
        state, outputs = tracker.track(torch.Generator(device=device).manual_seed(0), frames[:, None],
                                       np.ones(n_frames - 1))
        profiling.sync(outputs["mean"])
    datetimes = [T0 + i * DAY for i in range(n_frames)]
    tracks = to_tracks(datetimes, DAY, outputs)
    v = tracks.vxyz[:, -1, 0:2]
    err = np.abs(v - np.asarray(velocity))
    print(f"tracking: {n_points} points x 512 particles x {n_frames - 1} steps, in {len(tracker.parts)} slices")
    print("tracking: median velocity error =", np.median(err, axis=0), "px/day")
    print("tracking: median position sigma =", float(np.median(tracks.xyz_sigma[:, -1, 0])), "px")
    print(timer.report())
    return tracks


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(parser.parse_args().device)
