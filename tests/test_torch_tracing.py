"""The port's ``utils/tracing``: ``device_trace`` writes a torch.profiler
Chrome trace of its block into ``log_dir`` and is a no-op without one;
``StageTimer`` spans and counts."""

import json
import os

import torch

from clearconverse_tpu_torch.utils.tracing import StageTimer, device_trace

torch.set_num_threads(1)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n for n in names), names
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_device_trace_without_a_directory_is_a_no_op(tmp_path):
    for log_dir in (None, ""):
        with device_trace(log_dir) as prof:
            torch.ones(2) + 1
        assert prof is None
    assert os.listdir(tmp_path) == []


def test_stage_timer_spans_and_counts():
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("a"):
        with timer.stage("b"):
            pass
    timer.count("steps", 3)
    timer.count("steps")
    assert set(timer.as_dict()) == {"a", "b"}
    assert [name for name, _ in timer.spans] == ["a", "b", "a"]
    assert timer.counts == {"steps": 4}
    totals = StageTimer(totals_only=True)
    with totals.stage("x"):
        pass
    assert totals.spans == [] and list(totals.as_dict()) == ["x"]
