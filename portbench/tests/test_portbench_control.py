"""The control comes out not correct: the reference computed in a lower
precision, put in the program's place, fails one of the cell's numbers.

At a size a test run holds, on the CPU and on a card. At the cells' own
sizes on the card the readings come from ``portbench/calibrate.py
--controls bfloat16``."""
import numpy as np
import pytest
import torch

from portbench import calibrate, cells, harness
from portbench.tests.conftest import SMALL, small


def control_readings(name, precision, device, seed):
    """``portbench/calibrate.py``'s readings of the control at the cell's small size."""
    cell = cells.load_cell(name, small(name))
    return calibrate.control_readings(cell, seed, [precision], device)[precision], cell["traffic"]["check"]["limits"]


def failed(readings, limits):
    return [k for k, limit in limits.items() if not readings[k] <= limit]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_bfloat16_control_fails_on_the_cpu(name, seed):
    readings, limits = control_readings(name, "bfloat16", torch.device("cpu"), seed)
    assert failed(readings, limits), readings
    # The float32 reference against itself reads 0 on every number but the ratio.
    same, _ = control_readings(name, "float32", torch.device("cpu"), seed)
    assert same["start_gap_px"] == same["early_gap_px"] == 0.0 and same["error_ratio"] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_bfloat16_control_fails_on_the_card(name, card):
    for seed in (1, 2, 3):
        readings, limits = control_readings(name, "bfloat16", card, seed)
        assert failed(readings, limits), (seed, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_small_run_on_the_card_is_correct(name, card):
    result = harness.run(name, 5, 0.0, False, card, overrides=small(name))
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    assert np.isfinite(result["metrics"]["point_steps_per_s"]["value"])
