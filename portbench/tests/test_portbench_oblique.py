"""The oblique-3d cell on the CPU at a small size: its scene, its program
module and its plain reference (``scenes/oblique.py``, ``programs/oblique.py``,
``reference/oblique.py``), a run of the harness, and faults of the 3-D
model planted in the program that the check has to see."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import calibrate, cells, harness
from portbench.tests import test_portbench_imports

NAME = "oblique-3d.north-star"
SEED = 2 ** 31 + 1531
CPU = torch.device("cpu")


def small() -> dict:
    """The cell cut to seconds on the CPU: a 64 x 64 DEM over the same
    ground (its smoothing scaled with the cells, so the relief is the
    same), 96 x 96 frames at the same field of view, 16 points x 256
    particles, 6 steps."""
    cell = cells.load_cell(NAME)
    config, traffic = cell["config"], cell["traffic"]
    return {
        "traffic": {"points": 16, "particles": 256, "warmup_steps": 2, "check": dict(traffic["check"], points=16)},
        "config": {
            "images": 7, "dem": dict(config["dem"], cells=[64, 64], smoothing_cells=2.4, scale=12.0),
            "surveys": dict(config["surveys"], change_smoothing_cells=4.8),
            "camera": dict(config["camera"], imgsz=[96, 96], f=96), "render": dict(config["render"], workers=1),
        },
    }


@pytest.fixture(scope="module")
def cell():
    return cells.load_cell(NAME, small())


@pytest.fixture(scope="module")
def scene(cell):
    return cells.build_scene(cell, harness.derived_seed(SEED, harness.SCENE), CPU)


def run():
    return harness.run(NAME, SEED, 0.0, False, "cpu", overrides=small())


def test_the_configuration_names_its_own_files(cell):
    parts = cells.parts(cell["config"])
    assert parts.program.__name__ == "portbench.programs.oblique"
    assert parts.reference.__name__ == "portbench.reference.oblique"
    assert parts.numbers is parts.reference.numbers


def test_the_walk_finds_the_new_files():
    found = {p.relative_to(test_portbench_imports.ROOT).as_posix() for p in test_portbench_imports.RUN}
    assert {"programs/oblique.py", "reference/oblique.py", "scenes/oblique.py", "metrics/step.prior_ms.py"} <= found


def test_the_camera_vector_is_the_programs(cell, scene):
    from glimpse_tpu_torch import Camera

    np.testing.assert_array_equal(scene.cameras[0], Camera(**cell["config"]["camera"]).to_array().astype(np.float32))


def test_the_sigma_raster_varies_as_the_interpolant_says(cell, scene):
    """The tracking date's sigma is the surveys' variances propagated plus
    a third of the change scaled by the nearer survey's distance
    (``RasterInterpolant``): above the surveys' 0.5 m everywhere and
    different from cell to cell."""
    survey = cell["config"]["surveys"]
    sigma = scene.dem_sigma["array"]
    assert sigma.shape == scene.dem["array"].shape == (64, 64)
    first, last = survey["days"]
    w = (cell["config"]["tracking_day"] - first) / (last - first)
    floor = np.sqrt(survey["sigma_m"] ** 2 * (1 + 2 * w * w))
    assert sigma.min() >= floor - 1e-12 and sigma.std() > 0.05 and sigma.max() > floor + 0.3
    # The change the second survey added, rebuilt from sigma: its root mean
    # square is its standard deviation (3 m) and the square of its mean.
    change = np.sqrt(sigma ** 2 - floor ** 2) * 3 / min(w, 1 - w)
    assert survey["change_std_m"] - 1e-6 <= np.sqrt((change ** 2).mean()) <= 1.5 * survey["change_std_m"]


def test_the_truth_lies_on_the_dem(scene):
    from glimpse_tpu_torch.track.batch import DeviceRaster
    from portbench.programs.oblique import _raster

    dem = DeviceRaster.from_raster(_raster(scene.dem), device="cpu")
    truth = torch.as_tensor(scene.truth)
    torch.testing.assert_close(dem.sample(truth[..., 0:2].float()).double(), truth[..., 2], rtol=0, atol=1e-4)
    assert scene.frames.shape == (7, 1, 96, 96) and torch.isfinite(scene.frames).all()


def test_the_references_raster_read_is_the_programs(scene):
    """Bilinear between cell centres, extrapolated from the edge cells beyond
    them, bit for bit."""
    from glimpse_tpu_torch.track.batch import DeviceRaster
    from portbench.programs.oblique import _raster
    from portbench.reference import oblique

    xy = torch.rand((500, 2), generator=torch.Generator().manual_seed(3)) * 840 - torch.tensor([220.0, 220.0])
    for fields in (scene.dem, scene.dem_sigma):
        got = oblique.bilinear({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in fields.items()}, xy)
        torch.testing.assert_close(got, DeviceRaster.from_raster(_raster(fields), device="cpu").sample(xy), rtol=0,
                                   atol=0)


def test_the_means_match_the_reference_at_step_one(cell, scene):
    """Before any resampling the program's weighted means equal the
    reference's to float32 rounding: within 1e-3 m in x, y and z (an ulp
    of a coordinate of 256-512 m is 3.1e-5 m; the prior, the projection and
    the moments each round)."""
    parts = cells.parts(cell["config"])
    tracker = parts.program.build_tracker(cell["config"], cell["traffic"], scene, CPU)
    _, out = parts.program.tracking_run(tracker, cell["traffic"], scene, 77, 1)
    rows = np.arange(len(scene.points_xy))
    want = harness.reference_run(cell, scene, 77, 1, rows, CPU)
    gap = (out["mean"][0, :, 0:3] - want["mean"][0, :, 0:3]).abs().amax(dim=0)
    assert (gap <= 1e-3).all(), gap
    # The z the prior holds the particles to: the means lie near the DEM, not at 0.
    assert (out["mean"][0, :, 2] - torch.as_tensor(scene.truth[1, :, 2], dtype=torch.float32)).abs().max() < 3.0


def test_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 16 * 6
    assert set(result["checks"]) == {"start_gap_m", "early_gap_m", "error_ratio", "z_error_ratio", "lost_point_steps"}


def _prior_left_out(monkeypatch):
    """The weights carry the observers' likelihood alone."""
    from glimpse_tpu_torch.track import batch

    monkeypatch.setattr(batch.BatchMotion, "log_likelihoods",
                        lambda self, particles: torch.zeros(particles.shape[:2], dtype=particles.dtype))


def _z_without_sigma(monkeypatch):
    """z starts on the DEM: the draw is made, its sigma read as 0."""
    from glimpse_tpu_torch.track import batch

    initialize = batch.BatchMotion.initialize

    def flat(self, *args, **kwargs):
        zero = batch.DeviceRaster.constant(0.0, device=self.xy.device)
        return initialize(dataclasses.replace(self, dem_sigma=zero), *args, **kwargs)

    monkeypatch.setattr(batch.BatchMotion, "initialize", flat)


def _constant_sigma(monkeypatch):
    """The sigma raster's mean in its place, in the draw and in the prior."""
    from glimpse_tpu_torch.track import batch

    from_motions = batch.BatchMotion.from_motions.__func__

    def constant(cls, motions, device="cuda"):
        motion = from_motions(cls, motions, device)
        mean = float(motion.dem_sigma.array.mean())
        return dataclasses.replace(motion, dem_sigma=batch.DeviceRaster.constant(mean, device=device))

    monkeypatch.setattr(batch.BatchMotion, "from_motions", classmethod(constant))


FAULTS = {"prior_left_out": _prior_left_out, "z_without_sigma": _z_without_sigma, "constant_sigma": _constant_sigma}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [1, 2])
def test_bfloat16_control_fails_on_the_cpu(seed):
    cell = cells.load_cell(NAME, small())
    readings = calibrate.control_readings(cell, seed, ["bfloat16"], CPU)["bfloat16"]
    limits = cell["traffic"]["check"]["limits"]
    assert [k for k, limit in limits.items() if not readings[k] <= limit], readings


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct(card):
    result = harness.run(NAME, 5, 0.0, False, card, overrides=small())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
