"""feeder.h2d_ms (ms/step): device time of host-to-device copies a step: the
frames ``track_stream`` uploads chunk by chunk (``_upload``). Layer: the
feeder."""


def read(trace):
    copies = [end - start for name, start, end in trace.copies if "HtoD" in name]
    return sum(copies) * 1e3 / trace.steps if copies and trace.steps else None
