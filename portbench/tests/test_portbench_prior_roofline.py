"""kernel.prior.roofline_pct on synthetic traces, and the bytes it counts."""
import pytest

from portbench import cells
from portbench.metrics import _reader

H100 = "NVIDIA H100 80GB HBM3"
KERNEL = "void (anonymous namespace)::dem_prior_kernel<float>((anonymous namespace)::Args)"
prior = cells.load_module(cells.ROOT / "metrics" / "kernel.prior.roofline_pct.py")


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


@pytest.fixture
def cell():
    return cells.load_cell("oblique-3d.north-star")


def test_prior_bytes_at_oblique_3d(cell):
    # x, y and z read (12 B a particle) and the prior written (4 B) for
    # 10,240 x 2,048 particles, both 640 x 640 float32 rasters read once:
    # 338.8 MB, 0.101 ms at 3.35 TB/s.
    moved = 10240 * 2048 * 16 + 2 * 640 * 640 * 4
    assert prior.prior_bytes(cell) == moved == 338_821_120
    assert moved / 3.35e12 * 1e3 == pytest.approx(0.1011, abs=5e-5)
    # 16-bit particles keep a float32 prior; float64 particles a float64 one.
    for dtype, per_particle in (("bfloat16", 10), ("float16", 10), ("float64", 32)):
        wide = dict(cell, config=dict(cell["config"], dtype=dtype))
        assert prior.prior_bytes(wide) == 10240 * 2048 * per_particle + 2 * 640 * 640 * 4


def test_prior_roofline_reads_one_launch_a_step(cell):
    bound = prior.prior_bytes(cell) / 3.35e12 * 1e6
    events = [
        event("user_annotation", _reader.WINDOW, 0, 1e4),
        event("kernel", KERNEL, 10, 2 * bound),
        event("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 2000, 100),
        event("kernel", KERNEL, 3000, 2 * bound),
    ]
    assert prior.read(_reader.read_chrome(events, 2, cell, H100)) == pytest.approx(50.0, rel=1e-6)
    # A launch more or fewer than one a step, another card, or a program
    # without the kernel (the parent's, whose prior is plain ops): nothing is read.
    assert prior.read(_reader.read_chrome(events, 3, cell, H100)) is None
    assert prior.read(_reader.read_chrome(events, 1, cell, H100)) is None
    assert prior.read(_reader.read_chrome(events, 2, cell, "another card")) is None
    assert prior.read(_reader.read_chrome([events[0], events[2]], 2, cell, H100)) is None
