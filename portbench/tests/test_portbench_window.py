"""The window keeps each finished tracking run's ``mean`` and ``valid`` on
the host and nothing else of it, so ``peak_mem_gib`` reads one run's own
peak, whatever the number of runs the window completes."""
import types
import weakref

import pytest
import torch

from portbench import cells, harness
from portbench.reference import compare
from portbench.tests.conftest import small

NAME = "nadir-1obs.rung4"
SEED = 2 ** 31 + 4099


def tensors(*objects):
    """The tensors among the attributes or values of ``objects``."""
    found = []
    for obj in objects:
        values = obj.values() if isinstance(obj, dict) else vars(obj).values()
        found += [v for v in values if isinstance(v, torch.Tensor)]
    return found


def test_window_keeps_host_outputs_alone(monkeypatch):
    """Three runs, by a clock that ticks once a reading: each run starts
    with every tensor of the run before it freed but the kept ``mean`` and
    ``valid``; those are host tensors, and ``lost`` and ``check`` take them."""
    device = torch.device("cpu")
    cell = cells.load_cell(NAME, small(NAME))
    program = cells.parts(cell["config"]).program
    scene = cells.build_scene(cell, harness.derived_seed(SEED, harness.SCENE), device)
    tracker = program.build_tracker(cell["config"], cell["traffic"], scene, device)
    run = program.tracking_run
    held = []

    def tracking_run(*args, **kwargs):
        alive = sum(ref() is not None for ref in held)
        assert alive == 0, f"{alive} tensors of the run before are still held"
        state, out = run(*args, **kwargs)
        held[:] = [weakref.ref(t) for t in tensors(state, {k: v for k, v in out.items() if k not in ("mean", "valid")})]
        return state, out

    ticks = iter(range(100))
    monkeypatch.setattr(program, "tracking_run", tracking_run)
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    seeds, outputs, _ = harness.window(tracker, cell, scene, SEED, 3.0, device)

    assert len(seeds) == len(outputs) == 3 and held
    steps, points = cell["config"]["images"] - 1, cell["traffic"]["points"]
    for out in outputs:
        assert set(out) == {"mean", "valid"}
        assert out["mean"].device.type == out["valid"].device.type == "cpu"
        assert out["mean"].shape[:2] == (steps, points)
    assert harness.lost(outputs) == 0
    readings = harness.check(cell, scene, SEED, outputs, seeds, device)
    assert compare.verdict(readings, cell["traffic"]["check"]["limits"]), readings


@pytest.mark.cuda
def test_peak_is_one_runs_own_on_the_card(card):
    """A window of one tracking run and one of many peak alike."""
    one = harness.run(NAME, SEED, 0.0, False, card, overrides=small(NAME))
    many = harness.run(NAME, SEED, 2.0, False, card, overrides=small(NAME))
    assert one["correct"] and many["correct"], (one["checks"], many["checks"])
    sizes = small(NAME)
    call = sizes["traffic"]["points"] * (sizes["config"]["images"] - 1)
    assert one["attempted"] == call and many["attempted"] >= 4 * call
    assert many["device"]["memory_peak_bytes"] == one["device"]["memory_peak_bytes"] > 0
