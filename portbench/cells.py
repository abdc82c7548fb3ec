"""A cell of the benchmark, found by name: its traffic mix, its configuration,
its scene, its program module and its plain reference, each a file of its own.

``workloads/<cell>.json`` is the traffic mix (points, particles, the entry
point and how frames reach it, the warm-up, the check's sample and limits);
it names its configuration, ``configs/<config>.json``, which names its
scene builder, ``scenes/<scene>.py``. A later cell adds files and edits none.

A configuration may also name, by two optional keys, the files that drive
the program and that compute the plain reference (:func:`parts`):

- ``"program": "<name>"``, ``programs/<name>.py``, or :mod:`portbench.program`
  without the key. It provides ``problem(config, traffic, scene)`` (the
  problem as its reference takes it), ``build_tracker(config, traffic,
  scene, device)`` and ``tracking_run(tracker, traffic, scene, seed,
  n_steps)``, which returns (final state, {"mean", "sigma", "valid"} with a
  leading time axis of ``n_steps``);
- ``"reference": "<name>"``, ``reference/<name>.py``, or
  :mod:`portbench.reference.filter` without the key. It provides
  ``track(problem, frame, n_steps, seed, rows, device, precision)`` and may
  provide ``numbers(program, reference, truth, early_steps, quantile)``, the
  compared numbers of one run (:func:`portbench.reference.compare.numbers`
  where it does not). A reference imports nothing of the program; it may
  import its neighbours relatively (``from . import filter``).

``compare.worst``, ``compare.verdict``, the limits of the workload's check and
``lost_point_steps`` are shared by every configuration. A named file is loaded
once a process, when a run's set-up first looks it up; a name with no file
behind it raises before the scene is built.
"""
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
#: Where a configuration's ``"program"`` and ``"reference"`` files lie.
PROGRAMS = ROOT / "programs"
REFERENCES = ROOT / "reference"


@dataclasses.dataclass
class Scene:
    """What a scene builder makes from the seed, handed alike to the program
    and to the reference.

    ``frames`` (T, O, H, W) float32: a host array for a streamed cell, a
    tensor on the card for one held in device memory. ``truth`` (T, N, 2)
    world positions of the tracked features. ``masks`` (T - 1, O) and
    ``mask0`` (O,) observer flags, or None; ``viewshed`` raster fields
    (``array``, ``x0``, ``y0``, ``dx``, ``dy``), or None.

    A scene builder whose program and reference need more (a DEM and its
    sigma, say) returns a dataclass subclass of this one, defined in its
    own file; fields are not added here.
    """

    cameras: np.ndarray
    points_xy: np.ndarray
    frames: object
    truth: np.ndarray
    masks: Optional[np.ndarray] = None
    mask0: Optional[np.ndarray] = None
    viewshed: Optional[dict] = None


def load_module(path: Path, prefix: str = "portbench_"):
    """A Python file of the benchmark, loaded by its path (names may hold
    dots) as the module ``prefix`` + its stem: a prefix that is a package's
    name and a dot resolves the file's relative imports in that package."""
    spec = importlib.util.spec_from_file_location(f"{prefix}{path.stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Parts(NamedTuple):
    """The modules and function a configuration is run and checked by."""

    program: ModuleType
    reference: ModuleType
    numbers: Callable


@functools.cache
def _named(directory: Path, name: str, package: str) -> ModuleType:
    """``<directory>/<name>.py`` as a module of ``package``, loaded once a
    process."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the configuration names {path}, which does not exist")
    return load_module(path, f"{package}.")


def parts(config: dict) -> Parts:
    """The program module, the plain reference and the compared numbers of a
    configuration: the files its ``"program"`` and ``"reference"`` name, or
    :mod:`portbench.program`, :mod:`portbench.reference.filter` and
    :func:`portbench.reference.compare.numbers`."""
    from portbench import program
    from portbench.reference import compare, filter as reference

    if "program" in config:
        program = _named(PROGRAMS, config["program"], "portbench.programs")
    if "reference" in config:
        reference = _named(REFERENCES, config["reference"], "portbench.reference")
    return Parts(program, reference, getattr(reference, "numbers", compare.numbers))


def load_cell(name: str, overrides: Optional[dict] = None) -> dict:
    """{"name", "traffic", "config"} of the cell ``name``, with the keys of
    ``overrides`` ({"traffic": {...}, "config": {...}}) replaced."""
    traffic = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / "configs" / f"{traffic['config']}.json").read_text())
    cell = {"name": name, "traffic": traffic, "config": config}
    for part, values in (overrides or {}).items():
        cell[part] = {**cell[part], **values}
    return cell


def build_scene(cell: dict, seed: int, device) -> Scene:
    """The cell's scene from ``seed``, by its configuration's scene builder."""
    builder = load_module(ROOT / "scenes" / f"{cell['config']['scene']}.py")
    return builder.build(cell["config"], cell["traffic"], seed, device)


def late_masks(n_steps: int, n_observers: int, late: Optional[dict]):
    """(masks (n_steps, O), mask0 (O,)) of a configuration's late observer
    (``{"observer", "first", "every"}``): absent from the template frame, it
    fires first at step ``first`` (1-based) and misses every ``every``-th
    step after that; (None, None) without one."""
    if late is None:
        return None, None
    o = late["observer"]
    masks = np.ones((n_steps, n_observers), np.float32)
    masks[: late["first"] - 1, o] = 0.0
    masks[late["first"] - 1 + late["every"]:: late["every"], o] = 0.0
    mask0 = np.ones(n_observers, np.float32)
    mask0[o] = 0.0
    return masks, mask0
