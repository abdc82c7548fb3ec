"""The plain reference against the program on the CPU: stage by stage on
random inputs, every step of both cells from the reference's carried state
with the same draws, and the reference's own free run against the scene's
truth."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import cells, program
from portbench.reference import filter as reference
from portbench.tests.conftest import SMALL


@pytest.fixture
def rng():
    return torch.Generator().manual_seed(11)


def test_median_highpass_is_the_programs(rng):
    from glimpse_tpu_torch.ops import imageproc

    tiles = torch.randn((6, 31, 27), generator=rng)
    tiles[0, 3, 4] = tiles[0, 3, 5]  # a tie
    for size in ((5, 5), (3, 7), (1, 1)):
        torch.testing.assert_close(reference.median_highpass(tiles, size), imageproc.highpass(tiles, size),
                                   rtol=0, atol=0)


def test_tile_pipeline_is_the_programs(rng):
    from glimpse_tpu_torch.track import batch

    templates = torch.randn((5, 15, 15), generator=rng)
    search = torch.randn((5, 31, 31), generator=rng) * 3 + 1
    hp, table = batch._prepare_template_tiles(templates, (5, 5), 256)
    normalized = reference.normalize(templates)
    torch.testing.assert_close(reference.quantile_table(normalized, 256), table, rtol=0, atol=0)
    torch.testing.assert_close(reference.median_highpass(normalized, (5, 5)), hp, rtol=0, atol=0)
    got = reference.median_highpass(reference.match_histograms(reference.normalize(search), table), (5, 5))
    torch.testing.assert_close(got, batch._prepare_search_tiles(search, table, (5, 5)), rtol=0, atol=0)


def test_sse_and_spline_are_the_programs(rng):
    from glimpse_tpu_torch.ops import ncc, sampling

    search = torch.randn((4, 31, 31), generator=rng)
    templates = torch.randn((4, 15, 15), generator=rng)
    sse = reference.sse_maps(search, templates)
    torch.testing.assert_close(sse, ncc.sse_map_batched(search, templates), rtol=1e-5, atol=1e-3)
    coeffs = reference.spline_coefficients(sse)
    torch.testing.assert_close(coeffs, sampling.bspline_prefilter_2d(sse), rtol=1e-5, atol=1e-4)
    rows = torch.rand((4, 300), generator=rng) * 16
    cols = torch.rand((4, 300), generator=rng) * 16
    rows[:, 0], cols[:, 0] = 0.0, 16.0  # on the edges, where the natural ghosts enter
    torch.testing.assert_close(reference.spline_read(coeffs, rows, cols), sampling.bspline_sample(coeffs, rows, cols),
                               rtol=1e-5, atol=1e-4)


def test_projection_is_the_programs(rng):
    from glimpse_tpu_torch.ops import projection

    camera = torch.tensor([100.0, -50.0, 400.0, 20.0, -35.0, 3.0, 640, 480, 500, 510, 3, -2,
                           0.1, -0.02, 0.001, 0.0, 0.0, 0.0, 1e-3, -2e-3])
    xyz = torch.rand((50, 3), generator=rng) * torch.tensor([400.0, 400.0, 30.0]) + torch.tensor([-100.0, 200.0, 0.0])
    u, v = reference.project(camera, xyz[:, 0], xyz[:, 1], xyz[:, 2])
    pu, pv = projection.project_planes(camera, xyz[:, 0], xyz[:, 1], xyz[:, 2])
    torch.testing.assert_close((u, v), (pu, pv), rtol=0, atol=0)
    uv = projection.project(camera, xyz)
    torch.testing.assert_close(torch.stack(reference.project_points(camera, xyz), dim=-1), uv, rtol=0, atol=0)
    forward = projection.rotation_matrix(camera[3:6])[2]
    behind = camera[0:3] - 10.0 * forward + 0.01 * xyz  # behind the camera plane
    assert torch.isnan(reference.project(camera, *behind.T)[0]).all()


class Given:
    """Draws handed over one step at a time, as the reference's :class:`Draws` gives them."""

    def __init__(self, normals, uniform=None):
        self.normals, self.u = list(normals), uniform

    def normal(self, width):
        return self.normals.pop(0)

    def uniform(self):
        return self.u


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_step_from_the_references_state(name):
    """The program's ``step`` from the reference's state with the same draws
    gives the reference's outputs: the free run parts once a rounding moves
    a resampling threshold, so each step is held from a carried state."""
    from glimpse_tpu_torch.track import batch

    sizes = SMALL[name]
    cell = cells.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], points=sizes["points"], particles=sizes["particles"])
    cell["config"] = dict(cell["config"], images=sizes["images"])
    cpu = torch.device("cpu")
    scene = cells.build_scene(cell, 7, cpu)
    tracker = program.build_tracker(cell["config"], cell["traffic"], scene, cpu)
    plain = reference.Tracker(program.problem(cell["config"], cell["traffic"], scene),
                              np.arange(sizes["points"]), cpu)
    frames = torch.as_tensor(np.asarray(scene.frames))
    draws = reference.Draws(5, sizes["points"], sizes["particles"], cpu, plain.rows)
    state = plain.initialize(draws, frames[0])
    plan = reference.late_templates(plain.problem, sizes["images"] - 1)
    worst = 0.0
    for t in range(1, sizes["images"]):
        a = draws.normal(3)
        u = draws.uniform()
        mask = None if scene.masks is None else scene.masks[t - 1]
        carried = batch.BatchState(
            particles=state["particles"], weights=state["weights"], generator=torch.Generator(),
            templates=state["templates"], template_table=state["tables"], template_duv=state["duv"], step=t - 1,
            valid=state["valid"],
        )
        _, got = tracker.step(carried, frames[t], torch.tensor(1.0), noise={"a": a, "resample_u": u},
                              obs_mask=None if mask is None else torch.as_tensor(mask),
                              init_template_for=tuple(plan.get(t, ())))
        state, want = plain.step(Given([a], u), state, frames[t], 1.0, mask, plan.get(t, ()))
        worst = max(worst, float((got["mean"] - want["mean"]).abs().max()))
        torch.testing.assert_close(got["valid"], want["valid"], rtol=0, atol=0)
    assert worst < 1e-3, worst  # a few float32 ulps of coordinates up to 1,024


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_reference_tracks_the_truth(name):
    sizes = SMALL[name]
    cell = cells.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], points=sizes["points"], particles=sizes["particles"])
    cell["config"] = dict(cell["config"], images=sizes["images"])
    scene = cells.build_scene(cell, 9, torch.device("cpu"))
    frames = torch.as_tensor(np.asarray(scene.frames))
    steps = sizes["images"] - 1
    out = reference.track(program.problem(cell["config"], cell["traffic"], scene), frames.__getitem__, steps, 3,
                          np.arange(sizes["points"]), "cpu")
    assert out["mean"].shape == (steps, sizes["points"], 6) and (out["valid"] == 1).all()
    error = (out["mean"][-1, :, 0:2].double() - torch.as_tensor(scene.truth[-1])).norm(dim=-1)
    assert float(error.median()) < 0.3, error


def test_draws_are_the_programs():
    """The reference's draws are the program's: a tracker's run from a
    generator equals a run with the reference's draws injected."""
    from glimpse_tpu_torch.track import batch  # noqa: F401

    name = "nadir-1obs.rung4"
    sizes = SMALL[name]
    cell = cells.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], points=8, particles=64)
    cell["config"] = dict(cell["config"], images=4)
    cpu = torch.device("cpu")
    scene = cells.build_scene(cell, 7, cpu)
    tracker = program.build_tracker(cell["config"], cell["traffic"], scene, cpu)
    _, free = program.tracking_run(tracker, cell["traffic"], scene, 21, 3)
    draws = reference.Draws(21, 8, 64, cpu, torch.arange(8))
    noise = {"init": {"xy": draws.normal(2), "v": draws.normal(3)}}
    a, u = [], []
    for _ in range(3):
        a.append(draws.normal(3))
        u.append(draws.uniform())
    noise.update(a=torch.stack(a), resample_u=torch.stack(u))
    _, injected = tracker.track(torch.Generator(), scene.frames[:4], np.ones(3, np.float32), noise=noise)
    torch.testing.assert_close(free["mean"], injected["mean"], rtol=0, atol=0)
    assert sizes  # the cell's small size is defined
