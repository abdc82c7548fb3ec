"""``glimpse_tpu_torch.profiling`` against ``glimpse_tpu.profiling``, on the CPU.

Timings differ run to run, so the reference's ``report`` and ``as_dict``
are held on the same recorded totals; ``Progress`` writes the same text
when both read the same clock.
"""
import io
import json

import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu import profiling as ref_profiling
from glimpse_tpu_torch import profiling


def test_timer_accumulates_on_the_host_clock() -> None:
    timer = profiling.Timer()
    x = torch.ones(4)
    for _ in range(3):
        with timer("step", sync_value=x):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    with timer("decode"):
        pass
    assert timer.counts == {"step": 3, "decode": 1}
    assert all(v >= 0 for v in timer.totals.values())
    assert json.loads(json.dumps(timer.as_dict()))["step"]["calls"] == 3


def test_report_and_as_dict_match_the_reference() -> None:
    timer, ref_timer = profiling.Timer(), ref_profiling.Timer()
    for t in (timer, ref_timer):
        t.totals = {"decode": 0.25, "step": 1.5, "write": 0.125}
        t.counts = {"decode": 2, "step": 3, "write": 1}
    assert timer.report() == ref_timer.report()
    assert timer.as_dict() == ref_timer.as_dict()


def test_sync_passes_host_values_through() -> None:
    x = torch.arange(3)
    assert profiling.sync(x) is x
    assert profiling.sync({"a": [x]})["a"][0] is x
    assert profiling.sync(3.0) == 3.0


def test_progress_text_matches_the_reference(monkeypatch) -> None:
    texts = []
    for module in (profiling, ref_profiling):
        clock = iter([10.0, 12.0, 14.0])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        stream = io.StringIO()
        progress = module.Progress(5, label="frames", stream=stream)
        progress.next()
        progress.next(2)
        progress.finish()
        texts.append(stream.getvalue())
    assert texts[0] == texts[1] == "\rframes 1/5 (0.5/s, 2s)\rframes 3/5 (0.8/s, 4s)\n"


def test_device_trace_writes_a_chrome_trace(tmp_path) -> None:
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()
