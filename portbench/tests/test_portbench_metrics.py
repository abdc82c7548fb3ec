"""The trace reader and the per-layer metrics on synthetic traces, and the
kernels' byte counts against the figures PERF.md's kernel table holds."""
import json
from pathlib import Path

import pytest

from portbench import cells
from portbench.metrics import _bounds, _reader

H100 = "NVIDIA H100 80GB HBM3"


def metric(name: str):
    return cells.load_module(cells.ROOT / "metrics" / f"{name}.py").read


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def synthetic(cell, steps=2):
    """Two steps inside a 100 us window: one eager step of two kernels, each
    launched from the host, the second overlapping a side stream's kernel;
    then one graph replay of three kernels, two of them overlapping."""
    return [
        event("user_annotation", _reader.WINDOW, 0, 100),
        event("cpu_op", "aten::add", 1, 4),
        event("cuda_runtime", "cudaLaunchKernel", 2, 1),
        event("cuda_runtime", "cudaLaunchKernel", 8, 1),
        event("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 5, 10),  # 5-15
        event("kernel", "void systematic_resample_kernel<float>(float const*)", 10, 10),  # 10-20 overlaps
        event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 25, 5),  # 25-30
        event("cuda_runtime", "cudaGraphLaunch", 40, 2),
        event("cpu_op", "aten::copy_", 45, 30),
        event("kernel", "void separable_kernel<5, 5, 8, float>(float const*, float*, int)", 50, 10),  # 50-60
        event("kernel", "void separable_kernel<5, 5, 8, float>(float const*, float*, int)", 55, 10),  # 55-65
        event("kernel", "void systematic_resample_kernel<float>(float const*)", 70, 10),  # 70-80
        event("kernel", "outside the window", 150, 10),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 2, "id": 1},
    ]


@pytest.fixture
def cell():
    cell = cells.load_cell("columbia-2obs.north-star")
    cell["traffic"] = dict(cell["traffic"], points=1, particles=1)
    return cell


def test_busy_time_is_the_union_of_device_intervals(cell):
    trace = _reader.read_chrome(synthetic(cell), 2, cell, H100)
    assert trace.window == pytest.approx((0.0, 100e-6))
    assert len(trace.kernels) == 5  # the kernel after the window is left out
    # 5-20, 25-30, 50-65, 70-80: 45 us, where the durations sum to 55.
    assert _reader.busy_s(trace.device_ops) == pytest.approx(45e-6)
    assert sum(e - s for _, s, e in trace.device_ops) == pytest.approx(55e-6)
    assert metric("step.device_ms")(trace) == pytest.approx(45e-3 / 2)
    assert metric("device.idle_pct")(trace) == pytest.approx(55.0)
    assert metric("step.kernels")(trace) == pytest.approx(2.5)
    # Two kernels launched alone and one replayed graph.
    assert metric("entry.launch_calls")(trace) == pytest.approx(1.5)
    assert metric("feeder.h2d_ms")(trace) == pytest.approx(5e-3 / 2)


def test_breakdown_names_kernels_and_what_the_host_did_in_each_gap(cell):
    trace = _reader.read_chrome(synthetic(cell), 2, cell, H100)
    gaps = _reader.idle_gaps(trace)
    assert [(round(s * 1e6), round(e * 1e6)) for s, e in gaps] == [(0, 5), (20, 25), (30, 50), (65, 70), (80, 100)]
    found = _reader.breakdown(trace)
    ops = dict(found["device_ops"])
    assert ops["separable<5, 5, 8, float>"] == pytest.approx(20e-6)
    assert ops["systematic_resample<float>"] == pytest.approx(20e-6)
    assert sum(ops.values()) == pytest.approx(55e-6)
    idle = dict(found["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(5e-6)  # 65-70: the copy runs 45-75
    assert idle["host idle"] == pytest.approx(5e-6 + 20e-6)  # 20-25 and 80-100
    assert idle["cudaGraphLaunch"] == pytest.approx(20e-6)  # 30-50: its middle inside the graph launch (40-42)
    assert idle["cudaLaunchKernel"] == pytest.approx(5e-6)  # 0-5: its middle, 2.5 us, inside the launch, not the add
    assert len(found["device_ops"]) <= 10 and len(found["idle_gaps"]) <= 10


def test_metrics_find_nothing_in_an_empty_trace(cell):
    trace = _reader.read_chrome([event("user_annotation", _reader.WINDOW, 0, 10)], 2, cell, H100)
    for name in ("entry.launch_calls", "step.kernels", "step.device_ms", "feeder.h2d_ms", "device.idle_pct",
                 "kernel.highpass.roofline_pct", "kernel.resample.roofline_pct"):
        assert metric(name)(trace) is None, name


def test_byte_counts_match_the_kernel_table():
    # PERF.md: 60 B a particle, 1.258 GB at 10,240 x 2,048; (20,480, 31, 31) 5x5: 157.45 MB.
    assert _bounds.resample_bytes(10240, 2048) == 10240 * 2048 * 60 == 1_258_291_200
    assert _bounds.highpass_bytes(20480, 31, 31) == 157_450_240
    assert _bounds.highpass_bytes(10240, 41, 41) == 137_707_520
    assert _bounds.peak(H100, "hbm_bytes_per_s") == 3.35e12
    assert _bounds.peak("another card", "hbm_bytes_per_s") is None
    # The bound times PERF.md gives: 0.3756 ms and 0.0470 ms.
    assert _bounds.resample_bytes(10240, 2048) / 3.35e12 * 1e3 == pytest.approx(0.3756, abs=5e-5)
    assert _bounds.highpass_bytes(20480, 31, 31) / 3.35e12 * 1e3 == pytest.approx(0.0470, abs=5e-5)


def test_kernel_rooflines(cell):
    # One step at the cell's width: the search stack's launch at exactly its
    # bound time, the templates' (observer 1 only: the late one starts at
    # step 10) at twice theirs, the resample at twice its bound.
    cell["traffic"] = dict(cell["traffic"], points=10240, particles=2048)
    launches = _bounds.highpass_launches(cell, 1)
    assert launches == [(10240, 15, 15), (20480, 31, 31)]
    assert _bounds.highpass_launches(cell, 10) == [(10240, 15, 15)] * 2 + [(20480, 31, 31)] * 10
    bound = [_bounds.highpass_bytes(*s) / 3.35e12 * 1e6 for s in launches]
    resample = _bounds.resample_bytes(10240, 2048) / 3.35e12 * 1e6
    name = "void separable_kernel<5, 5, 8, float>(float const*, float*, int)"
    events = [
        event("user_annotation", _reader.WINDOW, 0, 1e4),
        event("kernel", name, 10, 2 * bound[0]),
        event("kernel", name, 100, bound[1]),
        event("kernel", "void systematic_resample_kernel<float>(float const*)", 1000, 2 * resample),
    ]
    trace = _reader.read_chrome(events, 1, cell, H100)
    expected = 100 * (bound[0] + bound[1]) / (2 * bound[0] + bound[1])
    assert metric("kernel.highpass.roofline_pct")(trace) == pytest.approx(expected, rel=1e-6)
    assert metric("kernel.resample.roofline_pct")(trace) == pytest.approx(50.0, rel=1e-6)
    # Launches other than a run's make: the bytes are unknown, nothing is read.
    trace.kernels.append((name, 2e-3, 3e-3))
    assert metric("kernel.highpass.roofline_pct")(trace) is None
    # Another card: no peak, nothing is read.
    trace = _reader.read_chrome(events, 1, cell, "another card")
    assert metric("kernel.resample.roofline_pct")(trace) is None


def test_every_per_layer_metric_has_a_reader():
    spec = json.loads((Path(cells.ROOT).parent / "BENCHMARK.json").read_text())
    for entry in spec["per_layer"]:
        assert (cells.ROOT / "metrics" / f"{entry['name']}.py").exists(), entry["name"]
