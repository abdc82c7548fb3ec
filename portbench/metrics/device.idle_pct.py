"""device.idle_pct (%): the share of the traced tracking run's wall time in
which no device operation ran: 1 - (union of kernel, copy and set intervals)
/ window. Layer: the device (one H100)."""
from portbench.metrics._reader import busy_s


def read(trace):
    window = trace.window[1] - trace.window[0]
    return 100.0 * (1.0 - busy_s(trace.device_ops) / window) if trace.device_ops and window > 0 else None
