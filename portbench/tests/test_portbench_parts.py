"""A configuration's own program module and plain reference, named by its
keys ``"program"`` and ``"reference"``: the lookup, and a run, its check and
the calibration going through the files it names. The files here forward to
the default ones and record their calls; they are written to a temporary
directory that the lookup is pointed at."""
import pytest
import torch

import portbench.program
import portbench.reference.filter
from portbench import calibrate, cells, harness
from portbench.reference import compare
from portbench.tests.conftest import SMALL, small

NAME = "nadir-1obs.rung4"
SEED = 2 ** 31 + 4099
CPU = torch.device("cpu")

PROGRAM = '''
from portbench import program

CALLS = []


def problem(*args, **kwargs):
    CALLS.append("problem")
    return program.problem(*args, **kwargs)


def build_tracker(*args, **kwargs):
    CALLS.append("build_tracker")
    return program.build_tracker(*args, **kwargs)


def tracking_run(*args, **kwargs):
    CALLS.append("tracking_run")
    return program.tracking_run(*args, **kwargs)
'''

# Relative, as a reference under ``reference/`` imports its neighbours.
REFERENCE = '''
from . import compare, filter

CALLS = []


def track(*args, **kwargs):
    CALLS.append("track")
    return filter.track(*args, **kwargs)


def numbers(*args, **kwargs):
    CALLS.append("numbers")
    return compare.numbers(*args, **kwargs)
'''


@pytest.fixture
def wrapped(tmp_path, monkeypatch):
    """Overrides that cut the cell to its small size and name the recording
    program and reference ``wrap``."""
    for directory, source in (("programs", PROGRAM), ("reference", REFERENCE)):
        (tmp_path / directory).mkdir()
        (tmp_path / directory / "wrap.py").write_text(source)
    monkeypatch.setattr(cells, "PROGRAMS", tmp_path / "programs")
    monkeypatch.setattr(cells, "REFERENCES", tmp_path / "reference")
    overrides = small(NAME)
    overrides["config"] = dict(overrides["config"], program="wrap", reference="wrap")
    return overrides


def calls(config: dict) -> set:
    parts = cells.parts(config)
    return set(parts.program.CALLS) | set(parts.reference.CALLS)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_default_lookup_is_the_imported_modules(name):
    parts = cells.parts(cells.load_cell(name)["config"])
    assert parts.program is portbench.program
    assert parts.reference is portbench.reference.filter
    assert parts.numbers is compare.numbers


def test_a_named_file_is_loaded_once(wrapped):
    first, second = cells.parts(wrapped["config"]), cells.parts(dict(wrapped["config"]))
    assert first.program is second.program and first.reference is second.reference
    assert first.program is not portbench.program and first.numbers is first.reference.numbers


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_a_run_goes_through_the_named_files(wrapped, trace):
    plain = harness.run(NAME, SEED, 0.0, trace, "cpu", overrides=small(NAME))
    named = harness.run(NAME, SEED, 0.0, trace, "cpu", overrides=wrapped)
    assert named["checks"] == plain["checks"] and named["correct"] == plain["correct"]
    assert named["correct"], named["checks"]
    assert calls(wrapped["config"]) == {"problem", "build_tracker", "tracking_run", "track", "numbers"}


def test_calibrate_goes_through_the_named_files(wrapped):
    plain_cell, named_cell = cells.load_cell(NAME, small(NAME)), cells.load_cell(NAME, wrapped)
    want = calibrate.program_reading(plain_cell, SEED, CPU)
    got = calibrate.program_reading(named_cell, SEED, CPU)
    assert {k: v for k, v in got.items() if k != "seconds"} == {k: v for k, v in want.items() if k != "seconds"}
    assert calls(named_cell["config"]) == {"problem", "build_tracker", "tracking_run", "track", "numbers"}
    parts = cells.parts(named_cell["config"])
    parts.program.CALLS.clear()
    parts.reference.CALLS.clear()
    controls = calibrate.control_readings(named_cell, SEED, ["bfloat16"], CPU)
    assert controls == calibrate.control_readings(plain_cell, SEED, ["bfloat16"], CPU)
    assert calls(named_cell["config"]) == {"problem", "track", "numbers"}


@pytest.mark.parametrize("key", ["program", "reference"])
def test_an_unknown_name_raises_before_the_scene(key, monkeypatch):
    def no_scene(*args, **kwargs):
        raise AssertionError("the scene was built")

    monkeypatch.setattr(cells, "build_scene", no_scene)
    overrides = small(NAME)
    overrides["config"] = dict(overrides["config"], **{key: "no-such-file"})
    with pytest.raises(FileNotFoundError, match="no-such-file.py"):
        harness.run(NAME, SEED, 0.0, False, "cpu", overrides=overrides)
