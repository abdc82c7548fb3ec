"""The nadir scene: one nadir camera over a canvas shifted by whole pixels.

``bench.py``'s scene, as the program's ``chip_smoke.make_scene`` builds it
(copied, so that the benchmark does not move when that script does), made
on the card: Gaussian-filtered noise (sigma 0.8 px, x100) from a generator
seeded with the run's seed, and frame t cut from it ``canvas_shift`` (rows,
cols) times t further, so the texture moves down and right by whole pixels
and frames are exact copies of the canvas. A nadir camera at 1 px per world
unit. Start points lie where the whole sequence's drift keeps every search
box inside the frame.
"""
import numpy as np
import torch
import torch.nn.functional as F

from portbench.cells import Scene

SIGMA = 0.8
RADIUS = 3  # scipy.ndimage.gaussian_filter's int(4 sigma + 0.5)


def gaussian_taps() -> torch.Tensor:
    x = np.arange(-RADIUS, RADIUS + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / SIGMA) ** 2)
    return torch.as_tensor(taps / taps.sum(), dtype=torch.float32)


def canvas(shape, seed: int, device) -> torch.Tensor:
    """(H, W) smooth texture on ``device`` from ``seed``: noise filtered by a
    separable Gaussian over valid windows (no edge handling)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((1, 1, shape[0] + 2 * RADIUS, shape[1] + 2 * RADIUS), generator=generator, device=device)
    taps = gaussian_taps().to(device)
    smooth = F.conv2d(F.conv2d(noise, taps.view(1, 1, -1, 1)), taps.view(1, 1, 1, -1))
    return smooth[0, 0] * 100


def margins(config: dict):
    """(first row and col, last row and col) a start point may take: its
    search box stays inside the frame through ``images - 1`` shifts."""
    h, w = config["frame_size"]
    dr, dc = config["canvas_shift"]
    reach = max(config["search_size"]) // 2 + 8
    n = config["images"] - 1
    return (reach, reach), (h - 1 - reach - dr * n, w - 1 - reach - dc * n)


def build(config: dict, traffic: dict, seed: int, device) -> Scene:
    h, w = config["frame_size"]
    dr, dc = config["canvas_shift"]
    n_frames = config["images"]
    span_r, span_c = dr * (n_frames - 1), dc * (n_frames - 1)
    texture = canvas((h + span_r, w + span_c), seed, device)
    frames = torch.stack([
        texture[span_r - dr * t: span_r - dr * t + h, span_c - dc * t: span_c - dc * t + w]
        for t in range(n_frames)
    ])[:, None].contiguous()
    camera = np.zeros((1, 20), np.float32)
    camera[0, 0:3] = (w / 2, h / 2, max(h, w))  # xyz
    camera[0, 3:6] = (0, -90, 0)  # viewdir: looking straight down
    camera[0, 6:8] = (w, h)  # imgsz
    camera[0, 8:10] = (max(h, w), max(h, w))  # f: 1 px per world unit on z = 0
    (r0, c0), (r1, c1) = margins(config)
    rng = np.random.default_rng(seed)
    rows = rng.uniform(r0, r1, size=traffic["points"])
    cols = rng.uniform(c0, c1, size=traffic["points"])
    # Pixel (col u, row v) is world (x, y) = (u, h - v) under this camera.
    starts = np.stack([cols, h - rows], axis=-1)
    truth = starts[None] + np.arange(n_frames)[:, None, None] * np.array([dc, -dr])
    return Scene(cameras=camera, points_xy=starts, frames=frames, truth=truth)
