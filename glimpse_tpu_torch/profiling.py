"""Observability: phase timers, device tracing, the program's spans and
counters, and progress reporting.

The counterpart of :mod:`glimpse_tpu.profiling`: :class:`Timer` accumulates
named phase times (CUDA events around work on a card, the host clock
otherwise), :func:`device_trace` captures a ``torch.profiler`` trace, and
:class:`Progress` reports host loops on the console.

The tracker records spans and counters at the boundaries of its layers
(entry, graphs, feeder, step, ops, kernels) while a ``torch.profiler``
records, and at no other time: :func:`enabled` is one attribute read, and
off, :func:`span` returns a shared null context and :func:`count` returns
at once. Each span enters ``torch.profiler.record_function``, so it sits in
the Chrome trace as a ``user_annotation`` on the kernels' clock, and adds
its host seconds to a registry. A span given a card (``device=``) also
records a pair of timing events on that card's current stream; under a
CUDA graph capture the pair becomes two event-record nodes of the graph,
which every replay records again. Nothing on the tracking path
synchronizes: a tracking call hands its programs' pairs (the last replay's
times) to the registry when it releases them, and :func:`report` reads
what the card has not recorded yet by waiting for it.

To see where a tracking run spends its time::

    from glimpse_tpu_torch import profiling

    with profiling.device_trace("trace_dir"):
        state, outputs = tracker.track(generator, frames, dts)
    report = profiling.report()

Open ``trace_dir/trace.json`` in Perfetto: each span is a slice named
``entry.call``, ``step``, ``ops.spline_read`` and so on, over the kernels it
launched (a replayed step's kernels sit under the ``entry.replay`` span that
launched the graph). ``report()["spans"][name]`` holds the span's entries
(``calls``), host seconds (``host_s``), the span it ran inside
(``parent``), the tracking call it last ran in (``call``, the
``entry.calls`` count), and for a span timed on the card the device
seconds of one replayed step summed over the calls (``replay_device_s``,
one sample a call and program in ``replay_samples``) and of its eager runs
(``eager_device_s``, launch gaps included). ``report()["counters"]`` holds
the counters and the kernel wrappers' own ``launches`` and ``captured``.
A tracker whose motion carries a DEM prior (a DEM sigma, cartesian or
cylindrical motion) also times the prior in each step, the span
``step.prior``, and counts its tracking calls in
``motion.informative_calls``; without a DEM sigma neither appears.
:func:`reset` clears the registry; :func:`tracing` turns the records on or
off whatever the profiler does.
"""
import contextlib
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler


def _cuda_device(value: Any):
    """The CUDA device of a tensor (or of the first tensor in a list, tuple
    or dict of them), else None."""
    if isinstance(value, torch.Tensor):
        return value.device if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for item in value:
            device = _cuda_device(item)
            if device is not None:
                return device
    return None


def sync(value: Any) -> Any:
    """Wait for the card's work behind ``value`` (a tensor, or a list,
    tuple or dict of them): ``torch.cuda.synchronize`` on its device. A
    no-op for CPU tensors and host values."""
    device = _cuda_device(value)
    if device is not None:
        torch.cuda.synchronize(device)
    return value


class Timer:
    """Named phase timers accumulating elapsed time and call counts.

    A phase given a ``sync_value`` on a card is timed by CUDA events
    recorded on the current stream at its start and end, so the time is
    the card's, whatever the host did meanwhile; any other phase by the
    host clock.

    Example:
        timer = Timer()
        with timer("decode"):
            ...
        with timer("step", sync_value=outputs["mean"]):
            ...
        print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync_value: Any = None):
        device = _cuda_device(sync_value)
        if device is not None:
            start_event = torch.cuda.Event(enable_timing=True)
            end_event = torch.cuda.Event(enable_timing=True)
            start_event.record(torch.cuda.current_stream(device))
        start = time.perf_counter()
        try:
            yield
        finally:
            if device is not None:
                end_event.record(torch.cuda.current_stream(device))
                end_event.synchronize()
                elapsed = start_event.elapsed_time(end_event) / 1e3
            else:
                elapsed = time.perf_counter() - start
            self.add(name, elapsed)

    def add(self, name: str, seconds: float) -> None:
        """Add one call of ``seconds`` to phase ``name``."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """Human-readable per-phase totals."""
        lines = []
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"{name:30s} {total:9.3f} s  ({count} calls, "
                f"{total / count * 1e3:8.2f} ms/call)"
            )
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """Totals and counts as a JSON-serializable dict."""
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: Union[str, Path]):
    """Profile the enclosed work with ``torch.profiler`` (the CPU, and the
    card where CUDA is available) and write a Chrome trace,
    ``<log_dir>/trace.json``, viewable in Perfetto. Yields the profiler, so
    callers can read ``key_averages()`` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


# ---- The program's spans and counters ---- #

#: None, or what :func:`tracing` set: records on or off, whatever the profiler does.
_OVERRIDE: Optional[bool] = None
#: What :func:`span` returns while nothing records.
_NULL = contextlib.nullcontext()


class _Registry:
    """What the spans and counters recorded since the last :func:`reset`."""

    def __init__(self) -> None:
        self.host = Timer()  # host seconds and entries a span
        self.parents: Dict[str, Optional[str]] = {}  # the span each first ran inside
        self.ordinals: Dict[str, int] = {}  # the entry.calls count each last ran under
        self.programs: Dict[str, set] = {}  # span -> the programs it worked on
        self.device: Dict[str, list] = {}  # span -> [replay s, replay samples, eager s]
        self.counters: Dict[str, int] = {}
        self.eager: list = []  # (name, start, end) events of device spans run eagerly, not read yet
        self.replayed: list = []  # a graph's (name, start, end) events a list, its last replay not read yet
        self.local = threading.local()  # .stack: open spans; .capture: a capture's device spans


_REGISTRY = _Registry()


def enabled() -> bool:
    """Whether spans and counters record: while a ``torch.profiler`` (or
    :func:`device_trace`) records, unless :func:`tracing` says otherwise."""
    return _autograd_profiler._is_profiler_enabled if _OVERRIDE is None else _OVERRIDE


@contextlib.contextmanager
def tracing(on: bool):
    """Record spans and counters (``on``) or not, whatever the profiler does."""
    global _OVERRIDE
    before, _OVERRIDE = _OVERRIDE, bool(on)
    try:
        yield
    finally:
        _OVERRIDE = before


def _stack() -> list:
    local = _REGISTRY.local
    if not hasattr(local, "stack"):
        local.stack = []
    return local.stack


def span(name: str, device=None, program: Optional[str] = None):
    """A context that records the span ``name`` while :func:`enabled`, and
    is a shared null context otherwise. ``device``, a card (a
    ``torch.device`` of type ``cuda``), also times the span on that card's
    current stream; ``program`` names the program the span works on (a
    capture's), which the registry keeps."""
    return _span(name, device, program) if enabled() else _NULL


def _event(device) -> "torch.cuda.Event":
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record(torch.cuda.current_stream(device))
    return event


@contextlib.contextmanager
def _span(name: str, device, program: Optional[str]):
    registry, stack = _REGISTRY, _stack()
    registry.parents.setdefault(name, stack[-1] if stack else None)
    registry.ordinals[name] = registry.counters.get("entry.calls", 0)
    if program is not None:
        registry.programs.setdefault(name, set()).add(program)
    timed = device is not None and torch.device(device).type == "cuda"
    stack.append(name)
    start = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            begin = _event(device) if timed else None
            yield
            # Not on an exception: a failed capture records nothing more.
            if timed:
                capture = getattr(registry.local, "capture", None)
                (registry.eager if capture is None else capture).append((name, begin, _event(device)))
    finally:
        stack.pop()
        registry.host.add(name, time.perf_counter() - start)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while :func:`enabled`."""
    if enabled():
        _REGISTRY.counters[name] = _REGISTRY.counters.get(name, 0) + n


@contextlib.contextmanager
def capturing():
    """Collect the device spans recorded in this thread meanwhile: a CUDA
    graph's capture, whose event pairs every replay records again. Yields
    the list of (name, start event, end event) they go to."""
    local = _REGISTRY.local
    before, local.capture = getattr(local, "capture", None), []
    try:
        yield local.capture
    finally:
        local.capture = before


def _seconds(begin, end) -> float:
    end.synchronize()
    return begin.elapsed_time(end) / 1e3


def read_device_spans(graphs: Iterable = (), wait: bool = True) -> None:
    """Take each of ``graphs``' (``graphs.Graph``) device spans as one
    sample of its last replay (a name a graph holds twice is summed), then
    read the samples and the eagerly run spans whose events the card has
    recorded, and with ``wait`` the others too, waiting for them. Without
    ``wait`` nothing synchronizes: what the card has not reached stays for a
    later read. A graph's events outlive the graph."""
    registry = _REGISTRY
    registry.replayed.extend(graph.spans for graph in graphs if graph.replays and graph.spans)

    def ready(pairs) -> bool:
        return wait or all(end.query() for _, _, end in pairs)

    pending = []
    for pair in registry.eager:
        if ready([pair]):
            registry.device.setdefault(pair[0], [0.0, 0, 0.0])[2] += _seconds(*pair[1:])
        else:
            pending.append(pair)
    registry.eager = pending
    pending = []
    for pairs in registry.replayed:
        if not ready(pairs):
            pending.append(pairs)
            continue
        totals: Dict[str, float] = {}
        for name, begin, end in pairs:
            totals[name] = totals.get(name, 0.0) + _seconds(begin, end)
        for name, seconds in totals.items():
            entry = registry.device.setdefault(name, [0.0, 0, 0.0])
            entry[0] += seconds
            entry[1] += 1
    registry.replayed = pending


def report() -> dict:
    """{"spans": {name: {"calls", "host_s", "parent", "call", "programs",
    "replay_device_s", "replay_samples", "eager_device_s"}}, "counters":
    {name: n}}: what was recorded since the last :func:`reset`, the device
    spans not read yet read first, waiting for the card. Each registered
    kernel's wrapper's own counts (``kernels._build.KERNELS``) come in as
    ``kernel.<label>.launches`` and ``kernel.<label>.captured``: labels
    ``highpass``, ``resample``, ``spline`` and ``project``."""
    from .kernels import _build

    read_device_spans()
    registry = _REGISTRY
    spans = {}
    for name, entry in registry.host.as_dict().items():
        replay_s, samples, eager_s = registry.device.get(name, (0.0, 0, 0.0))
        spans[name] = {
            "calls": entry["calls"], "host_s": entry["total_s"], "parent": registry.parents.get(name),
            "call": registry.ordinals.get(name, 0), "programs": sorted(registry.programs.get(name, ())),
            "replay_device_s": replay_s, "replay_samples": samples, "eager_device_s": eager_s,
        }
    counters = dict(registry.counters)
    for label, kernel in _build.KERNELS.items():
        counters[f"kernel.{label}.launches"] = kernel.wrapper.launches
        counters[f"kernel.{label}.captured"] = kernel.wrapper.captured
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the registry (not the kernel wrappers' own counts)."""
    global _REGISTRY
    _REGISTRY = _Registry()


class Progress:
    """Minimal in-place console progress reporter (host loops)."""

    def __init__(self, total: int, label: str = "", stream=None) -> None:
        self.total = total
        self.label = label
        self.count = 0
        self.start = time.perf_counter()
        self.stream = stream or sys.stdout

    def next(self, n: int = 1) -> None:
        self.count += n
        elapsed = time.perf_counter() - self.start
        rate = self.count / elapsed if elapsed > 0 else 0
        self.stream.write(
            f"\r{self.label} {self.count}/{self.total} "
            f"({rate:.1f}/s, {elapsed:.0f}s)"
        )
        self.stream.flush()

    def finish(self) -> None:
        self.stream.write("\n")
        self.stream.flush()
