"""entry.launch_calls (calls/step): host calls that launch device work a step,
one for each kernel launched on its own (``cudaLaunchKernel`` and kin) and one
for each replayed graph (``cudaGraphLaunch``). Layer: the entry
(``track/batch.py``: ``track``, ``track_stream``, ``StepProgram``)."""
from portbench.metrics._reader import GRAPH_LAUNCH, LAUNCH_CALLS


def read(trace):
    calls = trace.host_calls(LAUNCH_CALLS + (GRAPH_LAUNCH,))
    return calls / trace.steps if calls and trace.steps else None
