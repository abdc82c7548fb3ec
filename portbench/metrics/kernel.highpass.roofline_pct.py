"""kernel.highpass.roofline_pct (%): the median high-pass kernel's byte bound
over its time in the trace, summed over its launches in the tracking run
(``kernels/highpass.py`` over ``csrc/highpass.cu``). The bound is every tile
read and written once at the card's memory bandwidth; min/max selection has
no published peak. Nothing is read when the launches in the trace are not
the ones a run makes (their bytes would be unknown)."""
from portbench.metrics._bounds import highpass_bytes, highpass_launches, peak
from portbench.metrics._reader import launches_of

PATTERN = r"\b(separable|generic)\w*_kernel\b"


def read(trace):
    found = launches_of(trace, PATTERN)
    bandwidth = peak(trace.device_kind, "hbm_bytes_per_s")
    expected = highpass_launches(trace.cell, trace.steps)
    if not found or bandwidth is None or len(found) != len(expected):
        return None
    dtype = trace.cell["config"]["dtype"]
    bound = sum(highpass_bytes(*shape, dtype) for shape in expected) / bandwidth
    return 100.0 * bound / sum(end - start for _, start, end in found)
