"""entry.capture_ms (ms/call): host time of capturing the step's CUDA graph
(the program's span ``graph.capture``, ``graphs.Graph``) over the tracking
calls in the traced run (its spans ``entry.call``): what each call pays
once because it captures its programs anew. Layer: the entry."""
from portbench.metrics._spans import annotations


def read(trace):
    calls = annotations(trace, ("entry.call",))
    captures = annotations(trace, ("graph.capture",))
    if not calls or not captures:
        return None
    return sum(end - start for _, start, end in captures) * 1e3 / len(calls)
