"""ops.spline_read_ms (ms/step): device time of the spline read of the SSE
surfaces at every particle in one replayed step: the program's span
``ops.spline_read`` (``track/batch.py``: ``_sample_sse_surface``, whichever
``sse_sample_mode``), timed by event nodes inside the step's graph. Layer:
the ops."""
from portbench.metrics._spans import replayed_ms


def read(trace):
    return replayed_ms(("ops.spline_read",))
