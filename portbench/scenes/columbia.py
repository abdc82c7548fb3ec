"""The columbia scene: two nadir cameras over one drifting canvas.

``benchmarks/columbia_scale.py``'s two-observer recipe, as the program's
``chip_smoke.columbia_scene`` builds it on NumPy (copied, so that the
benchmark does not move when that script does): a smooth random canvas
(Gaussian-filtered noise) cropped bilinearly, moving ``canvas_velocity``
(px right, px down) a frame; each observer crops it ``crop_offset`` (rows,
cols) further and its principal point absorbs the offset, so both see the
same world track. Nadir cameras at 1 px per world unit; a viewshed raster
of all-visible cells over three times the canvas. Frames are made on the
host, as a campaign's sequence arrives.
"""
import numpy as np
import scipy.ndimage

from portbench.cells import Scene, late_masks


def canvas_and_crop(config: dict, n_frames: int, rng):
    """(canvas, crop(r0, c0) -> the frame-sized bilinear crop at that offset)."""
    h, w = config["frame_size"]
    vx, vy = config["canvas_velocity"]
    pad = int(np.ceil(max(abs(vx), abs(vy)) * n_frames)) + 8
    offset = max(max(abs(d) for d in o["crop_offset"]) for o in config["observers"])
    side = max(h, w) + pad + offset
    canvas = scipy.ndimage.gaussian_filter(rng.normal(size=(side, side)), 0.8).astype(np.float32) * 100

    def crop(r0: float, c0: float) -> np.ndarray:
        ri, ci = int(np.floor(r0)), int(np.floor(c0))
        fr, fc = np.float32(r0 - ri), np.float32(c0 - ci)
        win = canvas[ri: ri + h + 1, ci: ci + w + 1]
        top = win[:-1, :-1] * (1 - fc) + win[:-1, 1:] * fc
        bottom = win[1:, :-1] * (1 - fc) + win[1:, 1:] * fc
        return top * (1 - fr) + bottom * fr

    return canvas, crop


def build(config: dict, traffic: dict, seed: int, device) -> Scene:
    rng = np.random.default_rng(seed)
    n_frames = config["images"]
    h, w = config["frame_size"]
    vx, vy = config["canvas_velocity"]
    offsets = [o["crop_offset"] for o in config["observers"]]
    canvas, crop = canvas_and_crop(config, n_frames, rng)
    frames = np.stack([
        np.stack([crop(vy * t + dr, vx * t + dc) for dr, dc in offsets]) for t in range(n_frames)
    ]).astype(np.float32)
    cameras = np.zeros((len(offsets), 20), np.float32)
    for o, (dr, dc) in enumerate(offsets):
        cameras[o, 0:3] = (w / 2, h / 2, max(h, w))  # xyz
        cameras[o, 3:6] = (0, -90, 0)  # viewdir: looking straight down
        cameras[o, 6:8] = (w, h)  # imgsz
        cameras[o, 8:10] = (max(h, w), max(h, w))  # f: 1 px per world unit on z = 0
        cameras[o, 10:12] = (-dc, -dr)  # c
    starts = rng.uniform(h // 4, h - h // 4, size=(traffic["points"], 2))
    # The canvas moves +v in the crop, so features move -vx in world x and,
    # with image rows running against world y, +vy in y.
    truth = starts[None] + np.arange(n_frames)[:, None, None] * np.array([-vx, vy])
    masks, mask0 = late_masks(n_frames - 1, len(offsets), config["late_observer"])
    side = canvas.shape[0]
    cells_y, cells_x = config["viewshed"]["cells"]
    viewshed = {
        "array": np.ones((cells_y, cells_x), np.float32), "x0": float(-side), "y0": float(2 * side),
        "dx": 3 * side / cells_x, "dy": -3 * side / cells_y,
    }
    return Scene(cameras=cameras, points_xy=starts, frames=frames, truth=truth, masks=masks, mask0=mask0,
                 viewshed=viewshed)
