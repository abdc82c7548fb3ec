"""kernel.project.roofline_pct on synthetic traces, and the bytes it counts."""
import pytest

from portbench import cells
from portbench.metrics import _reader

H100 = "NVIDIA H100 80GB HBM3"
KERNEL = "void (anonymous namespace)::project_extract_kernel<float>((anonymous namespace)::Args)"
project = cells.load_module(cells.ROOT / "metrics" / "kernel.project.roofline_pct.py")


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


@pytest.fixture
def cell():
    cell = cells.load_cell("columbia-2obs.north-star")
    cell["traffic"] = dict(cell["traffic"], points=10240, particles=2048)
    return cell


def test_project_bytes_in_each_cell(cell):
    # The north star's front end: x, y, z and the weight (16 B a particle),
    # both observers' cols and rows (8 B a particle each), their 31 x 31
    # float32 tiles and 512 x 512 frames: 751.9 MB, 0.224 ms at 3.35 TB/s.
    moved = 10240 * 2048 * 16 + 2 * 10240 * 2048 * 8 + 2 * 10240 * 31 * 31 * 4 + 2 * 512 * 512 * 4
    assert project.project_bytes(cell) == moved == 751_910_912
    assert moved / 3.35e12 * 1e3 == pytest.approx(0.2245, abs=5e-5)
    # One oblique camera: the frame's shape from its imgsz; rung4's frame_size.
    oblique, rung4 = cells.load_cell("oblique-3d.north-star"), cells.load_cell("nadir-1obs.rung4")
    assert project.frame_shape(oblique["config"]) == (512, 512)
    assert project.project_bytes(rung4) == 1024 * 2048 * (16 + 8) + 1024 * 41 * 41 * 4 + 1024 * 1024 * 4


def test_project_roofline_reads_one_launch_a_step(cell):
    bound = project.project_bytes(cell) / 3.35e12 * 1e6
    events = [
        event("user_annotation", _reader.WINDOW, 0, 1e4),
        event("kernel", KERNEL, 10, 4 * bound),
        event("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 2000, 100),
        event("kernel", KERNEL, 3000, 4 * bound),
    ]
    assert project.read(_reader.read_chrome(events, 2, cell, H100)) == pytest.approx(25.0, rel=1e-6)
    # A launch more or fewer than one a step, another card, or a program
    # without the kernel (the parent's): nothing is read.
    assert project.read(_reader.read_chrome(events, 3, cell, H100)) is None
    assert project.read(_reader.read_chrome(events, 2, cell, "another card")) is None
    assert project.read(_reader.read_chrome([events[0], events[2]], 2, cell, H100)) is None
