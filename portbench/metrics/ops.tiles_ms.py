"""ops.tiles_ms (ms/step): device time of the search-tile pipeline in one
replayed step: the program's spans ``ops.histogram_match`` (normalize,
sort, table taps, scatter), ``ops.highpass`` (the median high-pass),
``ops.sse`` (the SSE map) and ``ops.prefilter`` (the spline prefilter of
the SSE surfaces), together. Layer: the ops."""
from portbench.metrics._spans import replayed_ms


def read(trace):
    return replayed_ms(("ops.histogram_match", "ops.highpass", "ops.sse", "ops.prefilter"))
