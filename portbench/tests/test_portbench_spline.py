"""kernel.spline.roofline_pct on synthetic traces, and the bytes it counts."""
import pytest

from portbench import cells
from portbench.metrics import _reader

H100 = "NVIDIA H100 80GB HBM3"
KERNEL = "void (anonymous namespace)::spline_sample_kernel<float, float, true>(float const*, float const*)"
spline = cells.load_module(cells.ROOT / "metrics" / "kernel.spline.roofline_pct.py")


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


@pytest.fixture
def cell():
    cell = cells.load_cell("columbia-2obs.north-star")
    cell["traffic"] = dict(cell["traffic"], points=10240, particles=2048)
    return cell


def test_spline_bytes_at_the_north_star(cell):
    # 20,480 surfaces of 17 x 17 float32 coefficients at 2,048 particles:
    # 12 B a particle and 4 B a coefficient, 527 MB, 0.157 ms at 3.35 TB/s.
    assert spline.spline_bytes(cell) == 20480 * 2048 * 12 + 20480 * 17 * 17 * 4 == 526_991_360
    assert spline.spline_bytes(cell) / 3.35e12 * 1e3 == pytest.approx(0.1573, abs=5e-5)
    # bfloat16: 2-byte coefficients read at float32 coordinates, a float32
    # output; float64: 8 bytes each.
    cell["config"] = dict(cell["config"], dtype="bfloat16")
    assert spline.spline_bytes(cell) == 20480 * 2048 * 12 + 20480 * 17 * 17 * 2
    cell["config"] = dict(cell["config"], dtype="float64")
    assert spline.spline_bytes(cell) == 20480 * 2048 * 24 + 20480 * 17 * 17 * 8
    rung4 = cells.load_cell("nadir-1obs.rung4")
    assert spline.spline_bytes(rung4) == 1024 * 2048 * 12 + 1024 * 27 * 27 * 4


def test_spline_roofline_reads_one_launch_a_step(cell):
    # Two steps, each spline read at twice its bound, and another kernel.
    bound = spline.spline_bytes(cell) / 3.35e12 * 1e6
    events = [
        event("user_annotation", _reader.WINDOW, 0, 1e4),
        event("kernel", KERNEL, 10, 2 * bound),
        event("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 500, 100),
        event("kernel", KERNEL, 1000, 2 * bound),
    ]
    assert spline.read(_reader.read_chrome(events, 2, cell, H100)) == pytest.approx(50.0, rel=1e-6)
    assert _reader.kernel_label(KERNEL) == "spline_sample<float, float, true>"
    # A launch more or fewer than one a step, another card, or a program
    # without the kernel (the parent's): nothing is read.
    assert spline.read(_reader.read_chrome(events, 3, cell, H100)) is None
    assert spline.read(_reader.read_chrome(events, 2, cell, "another card")) is None
    assert spline.read(_reader.read_chrome([events[0], events[2]], 2, cell, H100)) is None
