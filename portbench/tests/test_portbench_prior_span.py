"""``step.prior_ms``, the reader of the program's span ``step.prior``, on a
synthetic ``profiling.report()``: one replayed step's device time, and None
on a program that records no such span."""
import pytest

from portbench import cells
from portbench.metrics import _reader

H100 = "NVIDIA H100 80GB HBM3"


def read(trace):
    return cells.load_module(cells.ROOT / "metrics" / "step.prior_ms.py").read(trace)


def entry(replay_s, samples, eager_s=0.0):
    return {"calls": 9, "host_s": 1.0, "parent": "step", "call": 2, "programs": [], "replay_device_s": replay_s,
            "replay_samples": samples, "eager_device_s": eager_s}


@pytest.fixture
def trace():
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10, "pid": 0, "tid": 0}]
    return _reader.read_chrome(events, 1, cells.load_cell("oblique-3d.north-star"), H100)


def test_reads_one_replayed_step_of_the_span(trace, monkeypatch):
    from glimpse_tpu_torch import profiling

    spans = {"step": entry(0.05, 2), "step.prior": entry(0.008, 2, 0.3), "step.weights": entry(0.004, 2)}
    monkeypatch.setattr(profiling, "report", lambda: {"spans": spans, "counters": {}})
    assert read(trace) == pytest.approx(4.0)


@pytest.mark.parametrize("spans", [{}, {"step": entry(0.05, 2)}, {"step.prior": entry(0.0, 0, 0.3)}],
                         ids=["no_spans", "no_prior", "eager_only"])
def test_reads_nothing_without_a_replayed_prior(trace, monkeypatch, spans):
    from glimpse_tpu_torch import profiling

    monkeypatch.setattr(profiling, "report", lambda: {"spans": spans, "counters": {}})
    assert read(trace) is None


def test_reads_nothing_from_a_program_without_a_registry(trace, monkeypatch):
    from glimpse_tpu_torch import profiling

    monkeypatch.delattr(profiling, "report")
    assert read(trace) is None
