"""Bytes the two hand-written kernels must move, and the card's peaks.

Each input is read once and each output written once, whatever a kernel
reads again; neither kernel has arithmetic worth a compute bound (the
high-pass does min/max selections, for which no peak is published; the
resample copies rows), so bytes over the card's memory bandwidth bound both.
"""
import json
from pathlib import Path
from typing import Optional

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def peak(device_kind: str, key: str) -> Optional[float]:
    """A published peak of the card named ``device_kind`` (``peaks.json``), or None."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    return table.get(device_kind, {}).get(key)


def highpass_bytes(n: int, h: int, w: int, dtype: str = "float32") -> int:
    """The median high-pass of a stack (n, h, w): each tile read and written once."""
    return 2 * n * h * w * ITEMSIZE[dtype]


def resample_bytes(n_points: int, n_particles: int, dtype: str = "float32") -> int:
    """Systematic resampling of (N, P): the float32 threshold table read, the
    particles (6 values) and weights read and written: 60 B a particle in float32."""
    return n_points * n_particles * (4 + 2 * 7 * ITEMSIZE[dtype])


def highpass_launches(cell: dict, steps: int):
    """[(n, h, w), ...] of the high-pass launches one tracking run of ``steps``
    makes: each observer's templates once (a late observer's at its first
    step, if the run reaches it), then every step all observers' search tiles
    stacked in one launch."""
    config, traffic = cell["config"], cell["traffic"]
    n, n_obs = traffic["points"], len(config["observers"])
    late = config.get("late_observer")
    templates = n_obs - (1 if late is not None and late["first"] > steps else 0)
    return [(n, *config["template_size"])] * templates + [(n_obs * n, *config["search_size"])] * steps
