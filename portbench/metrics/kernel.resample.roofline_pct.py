"""kernel.resample.roofline_pct (%): the systematic resample kernel's byte
bound over its time in the trace, summed over its launches, one a step
(``kernels/resample.py`` over ``csrc/resample.cu``): 60 B a float32
particle (threshold read, particle and weight read and written) at the
card's memory bandwidth."""
from portbench.metrics._bounds import peak, resample_bytes
from portbench.metrics._reader import launches_of

PATTERN = r"systematic_resample_kernel"


def read(trace):
    found = launches_of(trace, PATTERN)
    bandwidth = peak(trace.device_kind, "hbm_bytes_per_s")
    if not found or bandwidth is None or len(found) != trace.steps:
        return None
    traffic = trace.cell["traffic"]
    bound = trace.steps * resample_bytes(traffic["points"], traffic["particles"], trace.cell["config"]["dtype"])
    return 100.0 * bound / bandwidth / sum(end - start for _, start, end in found)
