"""The trace reader: a profiler trace reduced to what the per-layer metrics read.

A traced run records one whole tracking run under ``torch.profiler`` (CPU
and CUDA activities) inside a ``record_function`` named :data:`WINDOW`, and
exports it as a Chrome trace. :func:`read_chrome` keeps its complete events:
device operations (kernels, memory copies and sets) and host events (CPU
operators, CUDA runtime and driver calls, annotations), in seconds.

The device is busy over the union of its operations' intervals, never the
sum of their durations: kernels of a graph's branches and of a side stream
overlap, and a sum would count that time twice.
"""
import dataclasses
import heapq
import json
import re
from typing import List, Optional, Tuple

#: The annotation around the traced tracking run.
WINDOW = "portbench.tracking_run"
#: Host calls that launch one kernel, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
#: The host call that launches a whole captured graph.
GRAPH_LAUNCH = "cudaGraphLaunch"
DEVICE_CATEGORIES = {"kernel": "kernels", "gpu_memcpy": "copies", "gpu_memset": "sets"}
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")

Interval = Tuple[str, float, float]  # (name, start s, end s)


@dataclasses.dataclass
class Trace:
    """One traced tracking run: device operations and host events inside
    ``window`` (start, end in seconds), and what the run was: ``steps``, the
    cell (``traffic`` and ``config``) and the card's name."""

    kernels: List[Interval]
    copies: List[Interval]
    sets: List[Interval]
    host: List[Tuple[str, str, float, float]]  # (category, name, start, end)
    window: Tuple[float, float]
    steps: int
    cell: dict
    device_kind: str

    @property
    def device_ops(self) -> List[Interval]:
        return self.kernels + self.copies + self.sets

    def host_calls(self, names) -> int:
        """How many host events of the CUDA runtime or driver have one of ``names``."""
        return sum(1 for cat, name, _, _ in self.host if cat in ("cuda_runtime", "cuda_driver") and name in names)


def read_chrome(events: list, steps: int, cell: dict, device_kind: str, window_name: str = WINDOW) -> Trace:
    """A :class:`Trace` of the complete events (``"ph": "X"``, times in
    microseconds) of a Chrome trace, clipped to the annotation
    ``window_name``; without that annotation, to the span of all events."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]

    def span(e):
        start = float(e["ts"]) * 1e-6
        return start, start + float(e["dur"]) * 1e-6

    marks = [span(e) for e in complete if e.get("cat") == "user_annotation" and e.get("name") == window_name]
    if marks:
        window = (min(s for s, _ in marks), max(e for _, e in marks))
    else:
        spans = [span(e) for e in complete]
        window = (min(s for s, _ in spans), max(e for _, e in spans)) if spans else (0.0, 0.0)
    lists = {name: [] for name in DEVICE_CATEGORIES.values()}
    host = []
    for e in complete:
        start, end = span(e)
        start, end = max(start, window[0]), min(end, window[1])
        if end <= start and float(e["dur"]) > 0:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            lists[DEVICE_CATEGORIES[cat]].append((e.get("name", ""), start, end))
        elif cat in HOST_CATEGORIES and e.get("name") != window_name:
            host.append((cat, e.get("name", ""), start, end))
    return Trace(window=window, steps=steps, cell=cell, device_kind=device_kind, host=host, **lists)


def load_chrome(path, steps: int, cell: dict, device_kind: str) -> Trace:
    """:func:`read_chrome` of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return read_chrome(events, steps, cell, device_kind)


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (name, start, end) intervals as disjoint (start, end), in order."""
    out: List[List[float]] = []
    for _, start, end in sorted(intervals, key=lambda i: i[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def busy_s(intervals) -> float:
    """Seconds covered by at least one of the intervals."""
    return sum(e - s for s, e in merged(intervals))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation running, in order."""
    gaps, cursor = [], trace.window[0]
    for start, end in merged(trace.device_ops):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if trace.window[1] > cursor:
        gaps.append((cursor, trace.window[1]))
    return gaps


def host_labels(trace: Trace, moments) -> List[str]:
    """What the host was doing at each of ``moments`` (ascending): the
    innermost (shortest) host event that covers it, or "host idle". One
    sweep over the host events, so a trace of 10^5 gaps reads in seconds."""
    events = sorted(trace.host, key=lambda e: e[2])
    active: list = []  # heap of (duration, end, name) of events begun by now
    labels, i = [], 0
    for moment in moments:
        while i < len(events) and events[i][2] <= moment:
            _, name, start, end = events[i]
            heapq.heappush(active, (end - start, end, name))
            i += 1
        # An event over by now stays over for every later moment.
        while active and active[0][1] < moment:
            heapq.heappop(active)
        labels.append(active[0][2] if active else "host idle")
    return labels


def kernel_label(name: str) -> str:
    """A CUDA kernel's name cut to what tells kernels apart: PyTorch's
    elementwise kernels by their operation and element type, others by the
    function that launched them and its template arguments."""
    found = re.search(r"binary_internal::(\w+)Functor<(\w+)>", name) or re.search(r"CUDAFunctor_(\w+)<(\w+)>", name)
    if found:
        return f"{found.group(1).lower()}<{found.group(2)}>"
    found = re.search(r"(\w+?)_kernel<([^<>()]+)>\(", name)
    if found:
        return f"{found.group(1)}<{found.group(2)}>"
    found = re.search(r"(\w+?)_kernel_impl\(|_cuda_(\w+?)_internal_kernel", name)
    if found:
        return found.group(1) or found.group(2)
    return name[:60]


def _top(totals: dict, n: int = 10) -> list:
    return [[name, seconds] for name, seconds in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, by label, and the longest
    idle stretches, by what the host was doing in their middle: at most 10
    of each, [name, seconds]."""
    ops: dict = {}
    for name, start, end in trace.device_ops:
        label = kernel_label(name)
        ops[label] = ops.get(label, 0.0) + (end - start)
    gaps: dict = {}
    stretches = idle_gaps(trace)
    for (start, end), label in zip(stretches, host_labels(trace, [0.5 * (s + e) for s, e in stretches])):
        gaps[label] = gaps.get(label, 0.0) + (end - start)
    return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def launches_of(trace: Trace, pattern: str) -> Optional[List[Interval]]:
    """The kernels whose names match ``pattern``, or None if there are none."""
    found = [k for k in trace.kernels if re.search(pattern, k[0])]
    return found or None
