"""One run of one cell: set-up, the measured window or the traced run, the
check against the plain reference, and the result line.

Set-up builds the scene from the seed, the program's tracker, and runs one
short tracking run at the cell's shapes (the kernels' builds and loads,
library handles, allocator and graph pools). The window then performs whole
tracking runs back to back, each one ``track`` or ``track_stream`` call with
a generator of its own drawn from the seed, until ``seconds`` have passed,
the last one completed. A traced run profiles one whole tracking run
instead. Afterwards the reference tracks a sample of the runs and points,
drawn from the seed, and :mod:`portbench.reference.compare` decides. The
program module, the reference and the compared numbers are the cell
configuration's (:func:`portbench.cells.parts`).
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import cells
from portbench.metrics import _reader
from portbench.reference import compare

ROOT = Path(__file__).resolve().parent
#: Modules that may not be loaded in a run, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "glimpse_tpu")
#: Purposes of the seeds drawn from a run's seed.
SCENE, WARM_UP, CHECK = 0, 1, 2


def derived_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    words = np.random.SeedSequence([seed % 2 ** 64, *purpose]).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def benchmark_entry(key: str, cell: str) -> list:
    """The entries of ``BENCHMARK.json``'s ``key`` that apply to ``cell``:
    those whose ``workloads`` name it or that have no ``workloads``."""
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return [m for m in spec[key] if cell in m.get("workloads", [cell])]


def loaded(names=FORBIDDEN) -> list:
    """The loaded modules whose top-level name is one of ``names``."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in names})


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lost(outputs) -> int:
    """Point-steps whose mean is not finite or whose point is marked invalid."""
    return sum(int((~torch.isfinite(o["mean"]).all(dim=-1) | (o["valid"] <= 0)).sum()) for o in outputs)


def sample(spec: dict, n_runs: int, n_points: int, seed: int):
    """(runs, points) the check compares, drawn from the run's seed: at most
    ``spec["runs"]`` of the window's ``n_runs`` tracking runs and
    ``spec["points"]`` of its ``n_points`` points, in order."""
    rng = np.random.default_rng(derived_seed(seed, CHECK))
    runs = sorted(rng.choice(n_runs, size=min(spec["runs"], n_runs), replace=False))
    return runs, np.sort(rng.choice(n_points, size=min(spec["points"], n_points), replace=False))


def reference_run(cell: dict, scene, run_seed: int, steps: int, rows, device, precision: str = "float32") -> dict:
    """The plain reference's outputs at the points ``rows`` of one tracking
    run whose generator the program seeded with ``run_seed``."""
    frames = scene.frames
    if isinstance(frames, np.ndarray):
        frame = lambda t: torch.as_tensor(frames[t], device=device)  # noqa: E731
    else:
        frame = frames.__getitem__
    parts = cells.parts(cell["config"])
    problem = parts.program.problem(cell["config"], cell["traffic"], scene)
    return parts.reference.track(problem, frame, steps, run_seed, rows, device, precision)


def check(cell: dict, scene, seed: int, outputs: list, seeds: list, device) -> dict:
    """The compared numbers over the runs and points the check samples from
    ``seed``: ``outputs[k]`` came from a generator seeded ``seeds[k]``, on
    the host or on ``device``; the sampled points' means go to ``device``."""
    spec = cell["traffic"]["check"]
    numbers = cells.parts(cell["config"]).numbers
    runs, rows = sample(spec, len(outputs), len(scene.points_xy), seed)
    readings = []
    for k in runs:
        steps = outputs[k]["mean"].shape[0]
        want = reference_run(cell, scene, seeds[k], steps, rows, device)
        mean = outputs[k]["mean"]
        got = {"mean": mean[:, torch.as_tensor(rows, device=mean.device)].to(device)}
        readings.append(numbers(got, want, scene.truth[1: steps + 1, rows], spec["early_steps"], spec["quantile"]))
    return compare.worst(readings)


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def window(tracker, cell: dict, scene, seed: int, seconds: float, device):
    """Whole tracking runs back to back until ``seconds`` have passed, the
    last one completed: (generator seeds, outputs, end-to-end values).

    Each finished run's ``mean`` and ``valid`` are copied to host memory,
    inside the window, and nothing else of it is kept, so each run starts on
    a card that holds the scene and the tracker alone: the peak is one run's
    own, however many runs the window completes."""
    steps = cell["config"]["images"] - 1
    program = cells.parts(cell["config"]).program
    seeds, outputs = [], []
    start = time.perf_counter()
    while not outputs or time.perf_counter() - start < seconds:
        seeds.append(derived_seed(seed, 3, len(seeds)))
        out = program.tracking_run(tracker, cell["traffic"], scene, seeds[-1], steps)[1]
        synchronize(device)
        outputs.append({"mean": out["mean"].cpu(), "valid": out["valid"].cpu()})
        del out
    point_steps = len(outputs) * cell["traffic"]["points"] * steps
    return seeds, outputs, {"point_steps_per_s": point_steps / (time.perf_counter() - start)}


def traced(tracker, cell: dict, scene, seed: int, device):
    """One tracking run under ``torch.profiler``, its Chrome trace read back:
    (generator seeds, outputs, the :class:`_reader.Trace`, its wall seconds)."""
    steps = cell["config"]["images"] - 1
    program = cells.parts(cell["config"]).program
    seeds = [derived_seed(seed, 3, 0)]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(_reader.WINDOW):
                start = time.perf_counter()
                _, out = program.tracking_run(tracker, cell["traffic"], scene, seeds[0], steps)
                synchronize(device)
                window_s = time.perf_counter() - start
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = _reader.load_chrome(path, steps, cell, device_kind(device))
    return seeds, [{"mean": out["mean"], "valid": out["valid"]}], trace, window_s


def run(name: str, seed: int, seconds: float, trace: bool, device, chips: int = 1, overrides=None,
        started: float = None) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``overrides`` ({"traffic": {...}, "config": {...}}) resize a cell for a
    test; ``started`` is the host clock (``time.perf_counter``) at the
    process's start."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    cell = cells.load_cell(name, overrides)
    traffic = cell["traffic"]
    program = cells.parts(cell["config"]).program
    scene = cells.build_scene(cell, derived_seed(seed, SCENE), device)
    tracker = program.build_tracker(cell["config"], traffic, scene, device)
    program.tracking_run(tracker, traffic, scene, derived_seed(seed, WARM_UP), traffic["warmup_steps"])
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started
    extra = {}
    if trace:
        seeds, outputs, traced_run, window_s = traced(tracker, cell, scene, seed, device)
        values = {}
        for metric in benchmark_entry("per_layer", name):
            value = cells.load_module(ROOT / "metrics" / f"{metric['name']}.py").read(traced_run)
            if value is not None:
                values[metric["name"]] = value
        device_extra = {"busy_s": _reader.busy_s(traced_run.device_ops), "window_s": window_s}
        extra = {"breakdown": _reader.breakdown(traced_run)}
    else:
        seeds, outputs, values = window(tracker, cell, scene, seed, seconds, device)
        values["setup_s"] = setup_s
        device_extra = {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    values["peak_mem_gib"] = peak / 2 ** 30
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in benchmark_entry("per_layer" if trace else "end_to_end", name) if m["name"] in values}
    n_lost = lost(outputs)
    del tracker
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(cell, scene, seed, outputs, seeds, device)
    limits = dict(traffic["check"]["limits"])
    readings["lost_point_steps"], limits["lost_point_steps"] = n_lost, 0
    for key in limits:
        print(f"check {key}: {readings[key]!r} (limit {limits[key]!r})", file=sys.stderr)
    return {
        "correct": compare.verdict(readings, limits),
        "attempted": sum(o["mean"].shape[0] * o["mean"].shape[1] for o in outputs), "failed": n_lost,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": device_kind(device),
                   "count": chips, "memory_peak_bytes": peak, **device_extra},
        **extra,
        "checks": {key: {"value": readings[key], "limit": limits[key]} for key in limits},
    }
