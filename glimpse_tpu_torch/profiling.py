"""Observability: phase timers, device tracing, and progress reporting.

The counterpart of :mod:`glimpse_tpu.profiling`: :class:`Timer` accumulates
named phase times (CUDA events around work on a card, the host clock
otherwise), :func:`device_trace` captures a ``torch.profiler`` trace, and
:class:`Progress` reports host loops on the console.
"""
import contextlib
import sys
import time
from pathlib import Path
from typing import Any, Dict, Union

import torch


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
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
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
