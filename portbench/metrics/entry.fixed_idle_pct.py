"""entry.fixed_idle_pct (%): the share of the traced tracking run's wall
time in which the device was idle while the host was in work a call does
once: the innermost of the program's spans ``entry.initialize``,
``entry.eager_step``, ``graph.capture``, ``entry.collect``,
``entry.release`` and ``entry.replay`` over a gap's middle is one of the
first five. ``device.idle_pct`` less this is the idle under a replay's host
call or outside those spans. Layer: the entry."""
from portbench.metrics._spans import idle_under_once_a_call_s


def read(trace):
    seconds = idle_under_once_a_call_s(trace)
    window = trace.window[1] - trace.window[0]
    return None if seconds is None or window <= 0 else 100.0 * seconds / window
