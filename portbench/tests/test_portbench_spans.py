"""The per-layer metrics that read the program's spans, on synthetic traces
and a synthetic ``profiling.report()``."""
import pytest

from portbench import cells
from portbench.metrics import _reader

H100 = "NVIDIA H100 80GB HBM3"
SPAN_METRICS = ("ops.spline_read_ms", "ops.tiles_ms", "step.replay_ms", "entry.capture_ms", "entry.fixed_idle_pct")


def metric(name: str):
    return cells.load_module(cells.ROOT / "metrics" / f"{name}.py").read


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


@pytest.fixture
def cell():
    return cells.load_cell("nadir-1obs.rung4")


def spanned(cell):
    """One call in a 100 us window: its initialization (0-11, the device
    idle 0-10), an eager step (11-25, its kernel 10-20), the graph's
    capture (25-40; the device idle 20-40), two replays (their kernels 40-60
    and 62-80; the gap between, 60-62, under the second replay's host
    call), the release (80-85) and the host outside every span (85-100;
    the device idle 80-100)."""
    return [
        event("user_annotation", _reader.WINDOW, 0, 100),
        event("user_annotation", "entry.call", 0, 85),
        event("user_annotation", "entry.initialize", 0, 11),
        event("user_annotation", "entry.eager_step", 11, 14),
        event("user_annotation", "step", 11, 14),
        event("user_annotation", "ops.sse", 19, 3),  # 20-22: inside the eager step all the same
        event("kernel", "void elementwise_kernel<128, 2>(int)", 10, 10),  # 10-20
        event("user_annotation", "graph.capture", 25, 15),
        event("user_annotation", "step", 26, 10),  # captured: still once a call
        event("user_annotation", "entry.replay", 40, 3),
        event("kernel", "void elementwise_kernel<128, 2>(int)", 40, 20),  # 40-60
        event("user_annotation", "entry.replay", 58, 4),
        event("cuda_runtime", "cudaGraphLaunch", 59, 2),
        event("kernel", "void elementwise_kernel<128, 2>(int)", 62, 18),  # 62-80
        event("user_annotation", "entry.release", 80, 5),
    ]


def test_fixed_idle_counts_gaps_under_once_a_call_spans(cell):
    trace = _reader.read_chrome(spanned(cell), 1, cell, H100)
    gaps = [(round(s * 1e6), round(e * 1e6)) for s, e in _reader.idle_gaps(trace)]
    assert gaps == [(0, 10), (20, 40), (60, 62), (80, 100)]
    # Once a call: 0-10 (initialize), 20-40 (its middle, 30, in the
    # capture), 80-100 (its middle, 90, outside every span: not counted).
    # 60-62 lies under a replay's host call.
    assert metric("entry.fixed_idle_pct")(trace) == pytest.approx(30.0)
    assert metric("device.idle_pct")(trace) == pytest.approx(10 + 20 + 2 + 20)


def test_fixed_idle_splits_a_gap_by_its_middle(cell):
    events = spanned(cell)
    # The release begins later: the last gap's middle (90) now lies in it.
    events[-1] = event("user_annotation", "entry.release", 80, 15)
    trace = _reader.read_chrome(events, 1, cell, H100)
    assert metric("entry.fixed_idle_pct")(trace) == pytest.approx(50.0)


def test_capture_ms_is_capture_time_over_calls(cell):
    events = spanned(cell) + [event("user_annotation", "entry.call", 86, 10),
                              event("user_annotation", "graph.capture", 88, 5)]
    trace = _reader.read_chrome(events, 1, cell, H100)
    assert metric("entry.capture_ms")(trace) == pytest.approx((15 + 5) * 1e-3 / 2)


def test_span_metrics_read_nothing_without_spans(cell, monkeypatch):
    from glimpse_tpu_torch import profiling

    events = [e for e in spanned(cell) if e["cat"] != "user_annotation" or e["name"] == _reader.WINDOW]
    trace = _reader.read_chrome(events, 1, cell, H100)
    monkeypatch.setattr(profiling, "report", lambda: {"spans": {}, "counters": {}})
    for name in SPAN_METRICS:
        assert metric(name)(trace) is None, name
    # A program without a registry (before spans existed) reads nothing either.
    monkeypatch.delattr(profiling, "report")
    for name in SPAN_METRICS:
        assert metric(name)(trace) is None, name


def test_replayed_ms_reads_one_replayed_step_of_the_report(cell, monkeypatch):
    from glimpse_tpu_torch import profiling

    def entry(replay_s, samples, eager_s=0.5):
        return {"calls": 9, "host_s": 1.0, "parent": "step", "call": 2, "programs": [],
                "replay_device_s": replay_s, "replay_samples": samples, "eager_device_s": eager_s}

    spans = {
        "step": entry(0.018, 2, 0.1), "ops.spline_read": entry(0.012, 2), "ops.histogram_match": entry(0.002, 2),
        "ops.highpass": entry(0.001, 2), "ops.sse": entry(0.0006, 2), "ops.prefilter": entry(0.0004, 2),
        "step.template": entry(0.0, 0, 0.2),
    }
    monkeypatch.setattr(profiling, "report", lambda: {"spans": spans, "counters": {}})
    trace = _reader.read_chrome(spanned(cell), 1, cell, H100)
    assert metric("step.replay_ms")(trace) == pytest.approx(9.0)
    assert metric("ops.spline_read_ms")(trace) == pytest.approx(6.0)
    assert metric("ops.tiles_ms")(trace) == pytest.approx(2.0)
    # Eager time alone is no replayed step.
    spans = {"step.template": entry(0.0, 0, 0.2), "step": entry(0.0, 0, 0.3)}
    assert metric("step.replay_ms")(trace) is None
