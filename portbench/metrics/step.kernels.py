"""step.kernels (kernels/step): kernels the device ran a step, in the trace,
replayed graphs' nodes included. Layer: the step (``BatchTracker.step`` as a
replayed graph)."""


def read(trace):
    return len(trace.kernels) / trace.steps if trace.kernels and trace.steps else None
