"""kernel.prior.roofline_pct (%): the DEM prior kernel's byte bound over its
time in the trace, summed over its launches, one a step (``kernels/prior.py``
over ``csrc/prior.cu``). Each step reads every particle's x, y and z (3
elements of the configuration's type), writes its prior once (4 bytes, 8 in
float64: the type the particles and the float32 rasters promote to) and
reads the DEM and its sigma raster once (the configuration's ``dem`` cells,
4 bytes each), at the card's memory bandwidth. Its arithmetic, some 150
float32 instructions a particle, would take about 0.1 ms an oblique-3d step
at the card's issue rate against the bytes' 0.101, so bytes bound it.
Nothing is read on a program without the kernel (the prior by plain ops), or
when the launches in the trace are not one a step."""
from portbench.metrics._bounds import ITEMSIZE, peak
from portbench.metrics._reader import launches_of

PATTERN = r"\bdem_prior_kernel\b"


def prior_bytes(cell: dict) -> int:
    """The bytes one step's DEM prior must move."""
    config, traffic = cell["config"], cell["traffic"]
    item = ITEMSIZE[config["dtype"]]
    coord = 8 if config["dtype"] == "float64" else 4
    h, w = config["dem"]["cells"]
    return traffic["points"] * traffic["particles"] * (3 * item + coord) + 2 * h * w * 4


def read(trace):
    found = launches_of(trace, PATTERN)
    bandwidth = peak(trace.device_kind, "hbm_bytes_per_s")
    if not found or bandwidth is None or len(found) != trace.steps:
        return None
    bound = trace.steps * prior_bytes(trace.cell) / bandwidth
    return 100.0 * bound / sum(end - start for _, start, end in found)
