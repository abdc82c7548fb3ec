"""kernel.spline.roofline_pct (%): the spline read kernel's byte bound over
its time in the trace, summed over its launches, one a step
(``kernels/spline.py`` over ``csrc/spline.cu``). Each step reads every
observer's SSE surface (oh x ow coefficients) at each of its particles: the
bound is the rows and cols read once and the output written once, B x P x 3
elements (B = observers x points) of 4 bytes, 8 in float64 (the coordinates
are the float32 cameras' projections, float64 with float64 particles, and
the output takes their type), and each coefficient read once, B x oh x ow
of the configuration's type, at the card's memory bandwidth. Its arithmetic, some 60 float32 operations a
particle, would take about a quarter of that time at the float32 peak, so
bytes bound it. Nothing is read on a program without the kernel, or when
the launches in the trace are not one a step."""
from portbench.metrics._bounds import ITEMSIZE, peak
from portbench.metrics._reader import launches_of

PATTERN = r"\bspline_sample_kernel\b"


def spline_bytes(cell: dict) -> int:
    """The bytes one step's spline read must move."""
    config, traffic = cell["config"], cell["traffic"]
    surfaces = len(config["observers"]) * traffic["points"]
    oh = config["search_size"][0] - config["template_size"][0] + 1
    ow = config["search_size"][1] - config["template_size"][1] + 1
    coord = 8 if config["dtype"] == "float64" else 4
    return surfaces * traffic["particles"] * 3 * coord + surfaces * oh * ow * ITEMSIZE[config["dtype"]]


def read(trace):
    found = launches_of(trace, PATTERN)
    bandwidth = peak(trace.device_kind, "hbm_bytes_per_s")
    if not found or bandwidth is None or len(found) != trace.steps:
        return None
    bound = trace.steps * spline_bytes(trace.cell) / bandwidth
    return 100.0 * bound / sum(end - start for _, start, end in found)
