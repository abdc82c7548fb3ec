"""step.replay_ms (ms/step): device time of one replayed step, from the
event node at the graph's start of ``BatchTracker.step`` to the one at its
end (the program's span ``step``): kernels and the gaps between the graph's
nodes. Beside ``step.device_ms`` (the union of device intervals), the
difference is the gaps inside the graph. Layer: the step."""
from portbench.metrics._spans import replayed_ms


def read(trace):
    return replayed_ms(("step",))
