"""A cell of the benchmark, found by name: its traffic mix, its configuration
and its scene, each a file of its own.

``workloads/<cell>.json`` is the traffic mix (points, particles, the entry
point and how frames reach it, the warm-up, the check's sample and limits);
it names its configuration, ``configs/<config>.json``, which names its
scene builder, ``scenes/<scene>.py``. A later cell adds files and edits none.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass
class Scene:
    """What a scene builder makes from the seed, handed alike to the program
    and to the reference.

    ``frames`` (T, O, H, W) float32: a host array for a streamed cell, a
    tensor on the card for one held in device memory. ``truth`` (T, N, 2)
    world positions of the tracked features. ``masks`` (T - 1, O) and
    ``mask0`` (O,) observer flags, or None; ``viewshed`` raster fields
    (``array``, ``x0``, ``y0``, ``dx``, ``dy``), or None.
    """

    cameras: np.ndarray
    points_xy: np.ndarray
    frames: object
    truth: np.ndarray
    masks: Optional[np.ndarray] = None
    mask0: Optional[np.ndarray] = None
    viewshed: Optional[dict] = None


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str) -> dict:
    """{"name", "traffic", "config"} of the cell ``name``."""
    traffic = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / "configs" / f"{traffic['config']}.json").read_text())
    return {"name": name, "traffic": traffic, "config": config}


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
