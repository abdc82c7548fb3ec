"""Shared pieces of the benchmark's tests: small cells on the CPU."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: Each cell cut to a size the CPU runs in seconds: as many steps as the
#: check's early steps and two more, so a late observer's first steps are in.
SMALL = {
    "columbia-2obs.north-star": {"points": 32, "particles": 512, "images": 15},
    "nadir-1obs.rung4": {"points": 32, "particles": 512, "images": 13},
}


def small(name: str, check_points: int = 32) -> dict:
    """Overrides that cut the cell ``name`` to its :data:`SMALL` size."""
    from portbench import cells

    sizes = SMALL[name]
    traffic = cells.load_cell(name)["traffic"]
    return {
        "traffic": {"points": sizes["points"], "particles": sizes["particles"], "warmup_steps": 2,
                    "check": dict(traffic["check"], points=check_points, runs=1)},
        "config": {"images": sizes["images"]},
    }


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
