"""The oblique scene: Welty 2018's 3-D set-up, one oblique camera over terrain
whose height and height uncertainty on the tracking date come from two
surveys.

``examples/oblique_3d_tracking.py``'s scene at 512 x 512, as the program's
``chip_smoke.oblique_scene`` builds it (copied, so that the benchmark does not
move when that script does): a gently undulating DEM (Gaussian-filtered
noise) of 640 x 640 cells of 1.25 m, a sharp texture draped on it that moves
``velocity`` (m a frame in world x, y), seen from (200, -150, 260) pitched
35 deg down with f = 512. As Welty's Columbia runs get their DEM, the
tracking date's DEM and its sigma come from ``RasterInterpolant(...,
return_sigma=True)`` over two survey DEMs: the first is that surface, the
second the same surface with a smooth change added, each with a uniform
sigma; the interpolated sigma adds a term in the change, so it varies over
the DEM. ``render.project_dem`` renders the interpolated DEM's world xy under
each pixel once, its holes (sky) filled from the nearest rendered pixel as
the example fills its frames'; each frame then reads the shifted texture
there, on ``device``, where the frames are held. (Draping each shifted
texture with ``project_dem``, as the example does, took some 13 s of a
run's set-up for 65 frames on an 8-core host and spread it widely from run
to run.) The
viewshed from the camera is computed on ``device``.

Start points are drawn uniformly over the example's tracked area from the
seed, kept where the true path of the whole run stays ``clearance_m`` from
hidden cells (as ``chip_smoke.oblique_points`` keeps its starts) and its
search boxes stay inside the frame; the truth's z is the DEM at the true xy.
"""
import dataclasses
import datetime
from typing import Optional

import numpy as np
import scipy.ndimage
import torch

from portbench.cells import Scene

#: The first frame's date; the motion's time unit is a day, a frame a day.
START = datetime.datetime(2020, 1, 1)
DAY = datetime.timedelta(days=1)


@dataclasses.dataclass
class ObliqueScene(Scene):
    """A :class:`Scene` with the tracking date's DEM and its sigma, raster
    fields (``array`` (H, W) float64, ``x0``, ``y0``, ``dx``, ``dy``) on one
    grid. ``truth`` is (T, N, 3): the true xy and the DEM's z there."""

    dem: Optional[dict] = None
    dem_sigma: Optional[dict] = None


def camera_vector(camera: dict) -> np.ndarray:
    """The (20,) camera vector (xyz, viewdir, imgsz, f, c, k, p) of an
    undistorted camera with its principal point at the image centre."""
    vector = np.zeros(20, np.float32)
    vector[0:3], vector[3:6], vector[6:8], vector[8:10] = (camera["xyz"], camera["viewdir"], camera["imgsz"],
                                                           (camera["f"], camera["f"]))
    return vector


def fields(raster) -> dict:
    """A host ``Raster``'s array and grid as raster fields."""
    return {"array": np.asarray(raster.array, np.float64), "x0": float(raster.xlim[0]),
            "y0": float(raster.ylim[0]), "dx": float(raster.d[0]), "dy": float(raster.d[1])}


def surveys(config: dict, rng):
    """(DEM, sigma) host ``Raster``s of the tracking date, interpolated
    between the two surveys, and the texture draped on the terrain."""
    from glimpse_tpu_torch import Raster
    from glimpse_tpu_torch.raster import RasterInterpolant

    grid = config["dem"]
    shape = tuple(grid["cells"])
    z = scipy.ndimage.gaussian_filter(rng.normal(size=shape), grid["smoothing_cells"]) * grid["scale"]
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=shape), config["texture"]["smoothing_cells"])
    texture = texture * config["texture"]["scale"]
    survey = config["surveys"]
    change = scipy.ndimage.gaussian_filter(rng.normal(size=shape), survey["change_smoothing_cells"])
    change = change * (survey["change_std_m"] / change.std())
    dates = [START + day * DAY for day in survey["days"]]
    means = [Raster(z, x=grid["x"], y=grid["y"], datetime=dates[0]),
             Raster(z + change, x=grid["x"], y=grid["y"], datetime=dates[1])]
    sigmas = [Raster(np.full(shape, survey["sigma_m"]), x=grid["x"], y=grid["y"]) for _ in dates]
    dem, sigma = RasterInterpolant(means, sigmas, x=dates)(START + config["tracking_day"] * DAY, return_sigma=True)
    return dem, sigma, texture


def render(config: dict, dem, texture: np.ndarray, n_frames: int, device) -> torch.Tensor:
    """(T, H, W) float32 frames on ``device``: the terrain's world xy under
    each pixel rendered once (``project_dem`` of the cells' centres, holes
    filled from the nearest rendered pixel), then each frame the texture
    read bilinearly there, shifted ``velocity`` a frame (clamped at its
    edges, as ``scipy.ndimage.shift(mode="nearest")`` shifts it)."""
    from glimpse_tpu_torch import Camera, render as project

    world = project.project_dem(Camera(**config["camera"]), dem, values=np.dstack([dem.X, dem.Y]),
                                scale_limits=config["render"]["scale_limits"], parallel=config["render"]["workers"])
    nearest = scipy.ndimage.distance_transform_edt(np.isnan(world[..., 0]), return_distances=False,
                                                   return_indices=True)
    world = torch.as_tensor(world[tuple(nearest)], dtype=torch.float64, device=device)
    values = torch.as_tensor(texture, dtype=torch.float64, device=device)
    H, W = values.shape
    vx, vy = config["velocity"]
    frames = []
    for t in range(n_frames):
        cols = ((world[..., 0] - vx * t - dem.xlim[0]) / dem.d[0] - 0.5).clamp(0, W - 1)
        rows = ((world[..., 1] - vy * t - dem.ylim[0]) / dem.d[1] - 0.5).clamp(0, H - 1)
        c0, r0 = cols.floor().clamp(max=W - 2), rows.floor().clamp(max=H - 2)
        fc, fr = cols - c0, rows - r0
        c0, r0 = c0.long(), r0.long()
        top = values[r0, c0] * (1 - fc) + values[r0, c0 + 1] * fc
        bottom = values[r0 + 1, c0] * (1 - fc) + values[r0 + 1, c0 + 1] * fc
        frames.append((top * (1 - fr) + bottom * fr).float())
    return torch.stack(frames)


def points(config: dict, traffic: dict, dem, viewshed: np.ndarray, rng):
    """(start points (N, 2), true paths (T, N, 3)) of the traffic's points."""
    from glimpse_tpu_torch import Camera

    n, n_frames = traffic["points"], config["images"]
    spec = config["points"]
    cells = abs(dem.d[0])
    hidden = viewshed <= 0
    # Distance of each cell's centre to the nearest hidden one, less a cell's diagonal.
    clearance = scipy.ndimage.distance_transform_edt(~hidden) * cells - cells * np.sqrt(2.0)
    H, W = hidden.shape
    candidates = rng.uniform(*spec["box"], size=(4 * n, 2))
    paths = candidates[:, None] + np.arange(n_frames)[None, :, None] * np.asarray(config["velocity"])
    cols = np.clip(np.floor((paths[..., 0] - dem.xlim[0]) / dem.d[0]).astype(int), 0, W - 1)
    rows = np.clip(np.floor((paths[..., 1] - dem.ylim[0]) / dem.d[1]).astype(int), 0, H - 1)
    kept = clearance[rows, cols].min(axis=1) >= spec["clearance_m"]
    z = dem.sample(paths.reshape(-1, 2)).reshape(paths.shape[:2])
    uv = Camera(**config["camera"]).xyz_to_uv(np.column_stack([paths.reshape(-1, 2), z.reshape(-1)]))
    uv = uv.reshape(*paths.shape[:2], 2)
    width, height = config["camera"]["imgsz"]
    reach = max(config["search_size"]) / 2 + spec["frame_margin_px"]
    inside = ((uv[..., 0] >= reach) & (uv[..., 0] <= width - reach)
              & (uv[..., 1] >= reach) & (uv[..., 1] <= height - reach)).all(axis=1)
    index = np.flatnonzero(kept & inside)
    if len(index) < n:
        raise AssertionError(f"only {len(index)} of {4 * n} candidate points keep clear of hidden cells and inside"
                             f" the frame, {n} wanted")
    index = index[:n]
    truth = np.concatenate([paths[index], z[index, :, None]], axis=-1)
    return candidates[index], truth.transpose(1, 0, 2)


def build(config: dict, traffic: dict, seed: int, device) -> ObliqueScene:
    rng = np.random.default_rng(seed)
    dem, sigma, texture = surveys(config, rng)
    visible = dem.viewshed(config["camera"]["xyz"], device=device).astype(np.float32)
    frames = render(config, dem, texture, config["images"], device)
    starts, truth = points(config, traffic, dem, visible, rng)
    viewshed = dict(fields(dem), array=visible)
    return ObliqueScene(
        cameras=camera_vector(config["camera"])[None], points_xy=starts,
        frames=frames[:, None].contiguous(), truth=truth, viewshed=viewshed,
        dem=fields(dem), dem_sigma=fields(sigma),
    )
