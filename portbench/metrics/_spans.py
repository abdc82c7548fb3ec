"""The program's own spans, as the per-layer metrics of the entry, step and
ops layers read them.

``glimpse_tpu_torch.profiling`` records spans while a ``torch.profiler``
records, so the traced run has them: each as a ``user_annotation`` host
event of the Chrome trace, and in the registry that
``profiling.report()`` reads, where a span timed on the card holds the
device seconds of one replayed step a tracking call (``replay_device_s``
over ``replay_samples``). A program that records no spans gives nothing to
read, and every reader then returns None.
"""
import dataclasses
from typing import List, Optional

from portbench.metrics._reader import Interval, Trace, host_labels, idle_gaps

#: Spans a tracking call runs once (or once a late observer): its set-up,
#: its eager steps, its graph's capture, the gathering of its outputs and
#: the release of its programs.
ONCE_A_CALL = ("entry.initialize", "entry.eager_step", "graph.capture", "entry.collect", "entry.release")
#: The span of a replayed step's host call: buffer copies, the graph's launch, output clones.
REPLAY = "entry.replay"


def replayed_ms(names) -> Optional[float]:
    """Milliseconds of one replayed step's device time in the spans
    ``names`` together, from ``glimpse_tpu_torch.profiling.report()``;
    None where the program recorded none of them in a replayed step."""
    try:
        from glimpse_tpu_torch import profiling
    except ImportError:
        return None
    report = getattr(profiling, "report", None)
    if report is None:
        return None
    spans = report().get("spans", {})
    found = [spans[name] for name in names if spans.get(name, {}).get("replay_samples")]
    return sum(s["replay_device_s"] / s["replay_samples"] for s in found) * 1e3 if found else None


def annotations(trace: Trace, names) -> List[Interval]:
    """The trace's spans named one of ``names``: (name, start s, end s)."""
    return [(name, start, end) for cat, name, start, end in trace.host if cat == "user_annotation" and name in names]


def idle_under_once_a_call_s(trace: Trace) -> Optional[float]:
    """Seconds of the window's idle gaps whose middle lies, of the spans
    :data:`ONCE_A_CALL` and :data:`REPLAY`, innermost in a once-a-call one;
    None without device operations or without any of those spans."""
    spans = annotations(trace, ONCE_A_CALL + (REPLAY,))
    if not spans or not trace.device_ops:
        return None
    gaps = idle_gaps(trace)
    only = dataclasses.replace(trace, host=[("user_annotation", *span) for span in spans])
    labels = host_labels(only, [0.5 * (start + end) for start, end in gaps])
    return sum(end - start for (start, end), label in zip(gaps, labels) if label in ONCE_A_CALL)
