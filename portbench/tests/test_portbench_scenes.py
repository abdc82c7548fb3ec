"""The scenes are what their configurations state."""
import numpy as np
import pytest
import torch

from portbench import cells
from portbench.scenes import columbia, nadir


def scene_of(name: str, points: int, seed: int = 5):
    cell = cells.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], points=points)
    return cell, cells.build_scene(cell, seed, torch.device("cpu"))


def test_columbia_frame_is_the_canvas_at_the_truths_offset():
    cell, scene = scene_of("columbia-2obs.north-star", 16)
    config = cell["config"]
    vx, vy = config["canvas_velocity"]
    _, crop = columbia.canvas_and_crop(config, config["images"], np.random.default_rng(5))
    for t in (0, 1, 17, config["images"] - 1):
        for o, (dr, dc) in enumerate(o["crop_offset"] for o in config["observers"]):
            np.testing.assert_array_equal(scene.frames[t, o], crop(vy * t + dr, vx * t + dc))
    # The truth moves by the canvas's velocity, -vx in world x and +vy in world y.
    np.testing.assert_allclose(scene.truth[-1] - scene.truth[0], np.broadcast_to(
        np.array([-vx, vy]) * (config["images"] - 1), scene.truth[0].shape))
    # A whole-pixel drift shows as a whole-pixel shift of the frames.
    shifted = columbia.canvas_and_crop(dict(config, canvas_velocity=[1.0, 1.0]), 4, np.random.default_rng(5))[1]
    np.testing.assert_array_equal(shifted(3, 3)[:-3, :-3], shifted(0, 0)[3:, 3:])


def test_nadir_frame_is_the_canvas_at_the_truths_offset():
    cell, scene = scene_of("nadir-1obs.rung4", 64)
    config = cell["config"]
    dr, dc = config["canvas_shift"]
    frames = scene.frames[:, 0]
    for t in (1, 57, config["images"] - 1):
        # Frame t is frame 0 moved t * (dr, dc) down and right, pixel for pixel.
        torch.testing.assert_close(frames[t, dr * t:, dc * t:], frames[0, : frames.shape[1] - dr * t,
                                                                    : frames.shape[2] - dc * t], rtol=0, atol=0)
    np.testing.assert_allclose(scene.truth[-1] - scene.truth[0], np.broadcast_to(
        np.array([dc, -dr]) * (config["images"] - 1), scene.truth[0].shape))


def test_nadir_search_boxes_stay_inside_the_frames():
    cell, scene = scene_of("nadir-1obs.rung4", 4096)
    config = cell["config"]
    h, w = config["frame_size"]
    sh, sw = config["search_size"]
    u = scene.truth[..., 0]  # col = x under the nadir camera
    v = h - scene.truth[..., 1]  # row = h - y
    assert scene.truth.shape[0] == config["images"] == 201
    assert (u - sw / 2 >= 0).all() and (u + sw / 2 <= w).all()
    assert (v - sh / 2 >= 0).all() and (v + sh / 2 <= h).all()


def test_columbia_masks_are_as_stated():
    cell, scene = scene_of("columbia-2obs.north-star", 8)
    late = cell["config"]["late_observer"]
    assert late == {"observer": 1, "first": 10, "every": 7}
    np.testing.assert_array_equal(scene.mask0, [1.0, 0.0])
    masks = scene.masks
    assert masks.shape == (cell["config"]["images"] - 1, 2)
    assert (masks[:, 0] == 1).all()
    steps = np.arange(1, masks.shape[0] + 1)
    fires = (steps >= 10) & ~((steps > 10) & ((steps - 10) % 7 == 0))
    np.testing.assert_array_equal(masks[:, 1] > 0, fires)
    assert list(steps[(steps >= 10) & (masks[:, 1] == 0)][:3]) == [17, 24, 31]
    # The viewshed is all visible and holds every point.
    assert (scene.viewshed["array"] > 0).all()


@pytest.mark.parametrize("name", ["columbia-2obs.north-star", "nadir-1obs.rung4"])
def test_the_seed_makes_the_scene(name):
    _, a = scene_of(name, 8, seed=3)
    _, b = scene_of(name, 8, seed=3)
    _, c = scene_of(name, 8, seed=4)
    assert np.array_equal(np.asarray(a.frames[1]), np.asarray(b.frames[1]))
    assert not np.array_equal(np.asarray(a.frames[1]), np.asarray(c.frames[1]))
    np.testing.assert_array_equal(a.points_xy, b.points_xy)
