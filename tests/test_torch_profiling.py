"""``glimpse_tpu_torch.profiling`` against ``glimpse_tpu.profiling``, on the CPU.

Timings differ run to run, so the reference's ``report`` and ``as_dict``
are held on the same recorded totals; ``Progress`` writes the same text
when both read the same clock.
"""
import io
import json

import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu import profiling as ref_profiling
from glimpse_tpu_torch import profiling


def test_timer_accumulates_on_the_host_clock() -> None:
    timer = profiling.Timer()
    x = torch.ones(4)
    for _ in range(3):
        with timer("step", sync_value=x):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    with timer("decode"):
        pass
    assert timer.counts == {"step": 3, "decode": 1}
    assert all(v >= 0 for v in timer.totals.values())
    assert json.loads(json.dumps(timer.as_dict()))["step"]["calls"] == 3


def test_report_and_as_dict_match_the_reference() -> None:
    timer, ref_timer = profiling.Timer(), ref_profiling.Timer()
    for t in (timer, ref_timer):
        t.totals = {"decode": 0.25, "step": 1.5, "write": 0.125}
        t.counts = {"decode": 2, "step": 3, "write": 1}
    assert timer.report() == ref_timer.report()
    assert timer.as_dict() == ref_timer.as_dict()


def test_sync_passes_host_values_through() -> None:
    x = torch.arange(3)
    assert profiling.sync(x) is x
    assert profiling.sync({"a": [x]})["a"][0] is x
    assert profiling.sync(3.0) == 3.0


def test_progress_text_matches_the_reference(monkeypatch) -> None:
    texts = []
    for module in (profiling, ref_profiling):
        clock = iter([10.0, 12.0, 14.0])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        stream = io.StringIO()
        progress = module.Progress(5, label="frames", stream=stream)
        progress.next()
        progress.next(2)
        progress.finish()
        texts.append(stream.getvalue())
    assert texts[0] == texts[1] == "\rframes 1/5 (0.5/s, 2s)\rframes 3/5 (0.8/s, 4s)\n"


def test_device_trace_writes_a_chrome_trace(tmp_path) -> None:
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


# ---- The program's spans and counters ---- #

#: Every span the tracker records on the CPU, with the span it runs inside.
#: The card adds ``graph.capture`` (inside ``entry.call``) and, when nvcc
#: runs, ``kernels.build``.
CPU_SPANS = {
    "entry.call": None, "entry.initialize": "entry.call", "entry.eager_step": "entry.call",
    "entry.replay": "entry.call", "entry.collect": "entry.call", "entry.release": "entry.call",
    "feeder.upload": "entry.call", "step": ("entry.eager_step", "entry.replay"), "step.evolve": "step",
    "step.validity": "step", "step.template": "step", "step.weights": "step", "step.resample": "step",
    "ops.project_extract": "step", "ops.histogram_match": "step", "ops.highpass": "step", "ops.sse": "step",
    "ops.prefilter": "step", "ops.spline_read": "step",
}


def _two_observer_run(device="cpu", n: int = 8, p: int = 64, T: int = 5, size: int = 96, prior: bool = False):
    """A tracker of ``n`` points x ``p`` particles and two observers, the
    second late (masked at steps 1-2, its template cut at step 3), and a
    function that runs ``track`` and then ``track_stream`` (frame by frame)
    from one seed: (outputs of both, in order). On a flat DEM, or with
    ``prior`` on an 8 x 8 DEM of a few units' relief with a sigma raster,
    which the steps' weights then carry."""
    import numpy as np
    import scipy.ndimage

    from glimpse_tpu_torch.track import batch, convert

    rng = np.random.default_rng(13)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(size + 32, size + 32)), 0.8) * 100
    frames = np.stack([[base[i:i + size, i:i + size], base[i + 2:i + 2 + size, i:i + size]]
                       for i in range(T)]).astype(np.float32)
    cam = np.zeros(20, np.float32)
    cam[0:3], cam[3:6], cam[6:10] = (size / 2, size / 2, size), (0, -90, 0), size
    flat = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    dem = dem_sigma = flat
    if prior:
        grid = {"x0": 0.0, "y0": float(size), "dx": size / 8, "dy": -size / 8}
        dem = dict(grid, array=rng.normal(size=(8, 8)))
        dem_sigma = dict(grid, array=rng.uniform(0.3, 0.8, size=(8, 8)))
    motion = convert.motion_from_numpy({
        "kind": "cartesian", "xy": rng.uniform(36, 60, size=(n, 2)), "xy_sigma": np.ones((n, 2)),
        "v_mean": np.zeros((n, 3)), "v_sigma": np.tile([1.0, 1.0, 0.0], (n, 1)), "a_mean": np.zeros((n, 3)),
        "a_sigma": np.tile([0.1, 0.1, 0.0], (n, 1)), "slope_sigma": np.zeros(n), "dem": dem, "dem_sigma": dem_sigma,
        "use_dem_sigma": prior}, device)
    config = batch.BatchConfig(n_particles=p, template_size=(11, 11), search_size=(25, 25))
    tracker = batch.BatchTracker(np.stack([cam, cam]), [None] * 2, [0.3] * 2, motion, config, device=device)
    masks = np.ones((T - 1, 2), np.float32)
    masks[0:2, 1] = 0.0
    mask0 = np.array([1.0, 0.0])

    def run():
        _, out = tracker.track(torch.Generator(device).manual_seed(5), frames, np.ones(T - 1), obs_masks=masks,
                               obs_mask0=mask0)
        _, streamed = tracker.track_stream(torch.Generator(device).manual_seed(5), frames[0], iter(frames[1:]),
                                           np.ones(T - 1), obs_masks=masks, obs_mask0=mask0)
        return [out, *streamed]

    return run, frames


def _annotations(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_spans_are_off_by_default(tmp_path) -> None:
    profiling.reset()
    assert not profiling.enabled()
    assert profiling.span("step") is profiling.span("entry.call") is profiling._NULL
    run, _ = _two_observer_run()
    with profiling.tracing(False), profiling.device_trace(tmp_path) as prof:
        assert not profiling.enabled()
        run()
    assert prof is not None
    names = {e["name"] for e in _annotations(tmp_path / "trace.json")}
    assert not names & set(CPU_SPANS)
    assert profiling.report()["spans"] == {}
    assert not any(k.startswith(("entry.", "feeder.", "graph.")) for k in profiling.report()["counters"])


def test_tracing_records_every_span_nested_under_its_parent(tmp_path) -> None:
    profiling.reset()
    run, frames = _two_observer_run()
    with profiling.device_trace(tmp_path):
        assert profiling.enabled()
        run()
    assert not profiling.enabled()
    report = profiling.report()
    spans = report["spans"]
    assert set(spans) == set(CPU_SPANS)
    for name, parent in CPU_SPANS.items():
        assert spans[name]["parent"] in (parent if isinstance(parent, tuple) else (parent,)), name
        # track_stream, frame by frame, gathers nothing: the last collect was track's.
        assert spans[name]["host_s"] >= 0 and spans[name]["call"] == (1 if name == "entry.collect" else 2), name
    # Each annotation of the trace lies inside one of its parent's.
    marks = _annotations(tmp_path / "trace.json")
    by_name: dict = {}
    for e in marks:
        by_name.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert set(by_name) == set(CPU_SPANS)
    for name, parent in CPU_SPANS.items():
        for start, end in by_name[name]:
            assert parent is None or any(s <= start and end <= e for p in (
                parent if isinstance(parent, tuple) else (parent,)) for s, e in by_name[p]), name
    # Two calls of 4 steps: in each the key's first step and the late
    # observer's template step (step 3) run eagerly, steps 2 and 4 through
    # the step program; one front end projects both observers every step.
    counters = report["counters"]
    assert counters["entry.calls"] == 2 and spans["entry.call"]["calls"] == 2
    assert counters["entry.eager_steps"] == 4 == spans["entry.eager_step"]["calls"]
    assert counters["entry.replays"] == 4 == spans["entry.replay"]["calls"]
    assert spans["step"]["calls"] == 8 and spans["ops.project_extract"]["calls"] == 8
    assert spans["step.template"]["calls"] == 2 and spans["entry.collect"]["calls"] == 1
    assert counters["feeder.uploads"] == 5 == spans["feeder.upload"]["calls"]
    assert counters["feeder.bytes"] == frames.nbytes
    assert "graph.captures" not in counters  # no graph on the CPU
    for key in ("kernel.highpass.launches", "kernel.highpass.captured", "kernel.resample.launches",
                "kernel.resample.captured", "kernel.spline.launches", "kernel.spline.captured",
                "kernel.project.launches", "kernel.project.captured", "kernel.prior.launches", "kernel.prior.captured"):
        assert key in counters
    # Nothing ran on a card: no device time.
    assert all(s["replay_samples"] == 0 and s["eager_device_s"] == 0 for s in spans.values())
    profiling.reset()
    assert profiling.report()["spans"] == {} and "entry.calls" not in profiling.report()["counters"]


@pytest.mark.parametrize("prior", [True, False], ids=["dem_sigma", "flat"])
def test_the_dem_prior_is_a_span_and_a_counter_only_where_it_weighs(tmp_path, prior) -> None:
    """With a DEM sigma, each step's prior is the span ``step.prior`` inside
    ``step``, in eager steps and in the step program's alike, and each
    tracking call counts in ``motion.informative_calls``; on a flat DEM
    neither appears, so the step records what it recorded before."""
    profiling.reset()
    run, _ = _two_observer_run(prior=prior)
    with profiling.device_trace(tmp_path):
        run()
    report = profiling.report()
    spans, counters = report["spans"], report["counters"]
    assert set(spans) == set(CPU_SPANS) | ({"step.prior"} if prior else set())
    if not prior:
        assert "motion.informative_calls" not in counters
        return
    assert counters["motion.informative_calls"] == 2 == counters["entry.calls"]
    assert spans["step.prior"]["parent"] == "step" and spans["step.prior"]["calls"] == spans["step"]["calls"] == 8
    marks: dict = {}
    for e in _annotations(tmp_path / "trace.json"):
        marks.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(name, parent):
        return [any(s <= start and end <= e for s, e in marks[parent]) for start, end in marks[name]]

    assert all(inside("step.prior", "step"))
    # Four steps of the eight run eagerly, four through the step program.
    assert sum(inside("step.prior", "entry.eager_step")) == 4 == sum(inside("step.prior", "entry.replay"))
    profiling.reset()


def test_tracing_leaves_the_outputs_bit_equal() -> None:
    run, _ = _two_observer_run()
    with profiling.tracing(False):
        off = run()
    with profiling.tracing(True):
        on = run()
    profiling.reset()
    assert len(on) == len(off) == 5
    for a, b in zip(on, off):
        for key in b:
            assert torch.equal(a[key], b[key]), key


class _FakeEvent:
    """A recorded timing event: its time in ms, and whether the card has reached it."""

    def __init__(self, ms: float, reached: bool = True) -> None:
        self.ms, self.reached = ms, reached

    def query(self) -> bool:
        return self.reached

    def synchronize(self) -> None:
        self.reached = True

    def elapsed_time(self, end) -> float:
        assert self.reached and end.reached
        return end.ms - self.ms


class _FakeGraph:
    def __init__(self, spans, replays: int = 1) -> None:
        self.spans, self.replays = spans, replays


def test_device_spans_are_read_without_waiting_until_the_report() -> None:
    """A released graph's pairs are one sample of its last replay, a name
    held twice summed; a read that may not wait takes only what the card has
    reached, and the report waits for the rest. A graph never replayed gives
    nothing."""
    profiling.reset()
    pair = lambda name, a, b, reached=True: (name, _FakeEvent(a), _FakeEvent(b, reached))  # noqa: E731
    ahead = _FakeGraph([pair("step", 0, 10), pair("ops.sse", 1, 3), pair("ops.sse", 5, 6, reached=False)])
    done = _FakeGraph([pair("step", 20, 28), pair("ops.sse", 21, 22)])
    profiling._REGISTRY.eager = [pair("step", 0, 40), pair("step", 50, 95, reached=False)]
    profiling.read_device_spans([ahead, done, _FakeGraph([pair("step", 0, 1)], replays=0)], wait=False)
    device = profiling._REGISTRY.device
    assert device["step"] == [pytest.approx(8e-3), 1, pytest.approx(40e-3)]
    assert device["ops.sse"] == [pytest.approx(1e-3), 1, 0.0]
    assert len(profiling._REGISTRY.replayed) == 1 and len(profiling._REGISTRY.eager) == 1
    with profiling.tracing(True), profiling.span("step"), profiling.span("ops.sse"):
        pass
    spans = profiling.report()["spans"]
    assert spans["step"]["replay_device_s"] == pytest.approx(18e-3) and spans["step"]["replay_samples"] == 2
    assert spans["step"]["eager_device_s"] == pytest.approx(85e-3)
    assert spans["ops.sse"]["replay_device_s"] == pytest.approx(1e-3 + 3e-3)
    assert profiling._REGISTRY.replayed == [] and profiling._REGISTRY.eager == []
    profiling.reset()
