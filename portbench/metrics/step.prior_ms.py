"""step.prior_ms (ms/step): device time of the DEM prior in one replayed step,
the program's span ``step.prior`` (the motion's two bilinear reads a
particle, of the DEM and of its sigma, and the prior's arithmetic), recorded
only where the motion carries a DEM sigma. Layer: the step."""
from portbench.metrics._spans import replayed_ms


def read(trace):
    return replayed_ms(("step.prior",))
