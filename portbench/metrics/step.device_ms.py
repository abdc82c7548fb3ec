"""step.device_ms (ms/step): the union of the device's operation intervals
(kernels, memory copies and sets) a step. Layer: the step."""
from portbench.metrics._reader import busy_s


def read(trace):
    return busy_s(trace.device_ops) * 1e3 / trace.steps if trace.device_ops and trace.steps else None
