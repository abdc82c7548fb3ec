"""kernel.project.roofline_pct (%): the observer front-end kernel's byte bound
over its time in the trace, summed over its launches, one a step
(``kernels/project.py`` over ``csrc/project.cu``). Each step projects every
point's particles through every observer's camera, cuts each point's search
tile and writes each particle's SSE-surface indices: the bound is x, y, z and
the weight read once (4 elements a particle of the configuration's type),
cols and rows written once for each observer (4 bytes each, 8 in float64:
they take the type the particles and the float32 cameras promote to), each
observer's tiles (search size, of the configuration's type) written once and
each observer's frame read once, at the card's memory bandwidth. Its
arithmetic, some 100 float32 instructions a particle and observer, would
take about 0.13 ms a north-star step at the card's issue rate against the
bytes' 0.22, so bytes bound it. Nothing is read on a program without the
kernel, or when the launches in the trace are not one a step."""
from portbench.metrics._bounds import ITEMSIZE, peak
from portbench.metrics._reader import launches_of

PATTERN = r"\bproject_extract_kernel\b"


def frame_shape(config: dict):
    """(H, W) of the configuration's frames: ``frame_size``, or its camera's
    ``imgsz`` (W, H)."""
    if "frame_size" in config:
        return tuple(config["frame_size"])
    width, height = config["camera"]["imgsz"]
    return height, width


def project_bytes(cell: dict) -> int:
    """The bytes one step's front end must move."""
    config, traffic = cell["config"], cell["traffic"]
    observers, points, particles = len(config["observers"]), traffic["points"], traffic["particles"]
    item = ITEMSIZE[config["dtype"]]
    coord = 8 if config["dtype"] == "float64" else 4
    sh, sw = config["search_size"]
    h, w = frame_shape(config)
    return (points * particles * 4 * item + observers * points * particles * 2 * coord
            + observers * points * sh * sw * item + observers * h * w * item)


def read(trace):
    found = launches_of(trace, PATTERN)
    bandwidth = peak(trace.device_kind, "hbm_bytes_per_s")
    if not found or bandwidth is None or len(found) != trace.steps:
        return None
    bound = trace.steps * project_bytes(trace.cell) / bandwidth
    return 100.0 * bound / sum(end - start for _, start, end in found)
