"""Twins of the agent-side cases of ``tests/test_diagnosis_utils.py``
(stack, log and step-time collectors) and of
``tests/test_deep_diagnosis.py`` (hang flight data, the hang watchdog,
the step-phase collector), for the port's ``agent/diagnosis.py``.

One case more: the chip-metrics collector never makes a CUDA context
(a context takes memory on the training card); without one in the
process it answers the reference's "unavailable" line.  The
``hang_evidence`` events are held to the reference's own event schema
(``dlrover_tpu/telemetry/schema.py``, which the port's copy
``dlrover_tpu_torch/telemetry/schema.py`` extends).  Numbers are held to 1e-6 relative (``pytest.approx``).
"""

import json
import os

import pytest

from dlrover_tpu.telemetry.schema import validate_event
from dlrover_tpu_torch.agent.diagnosis import (
    ChipMetricsCollector,
    DiagnosisMonitor,
    HangWatchdog,
    LogCollector,
    StackCollector,
    StepPhaseCollector,
    StepTimeCollector,
    capture_hang_evidence,
)
from dlrover_tpu_torch.telemetry.events import EVENT_LOG_ENV, read_events


@pytest.fixture
def event_log(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(EVENT_LOG_ENV, str(path))
    return path


class _FakeClient:
    def __init__(self):
        self.reports = []

    def report_diagnosis_data(self, data_type, content):
        self.reports.append((data_type, content))
        return True


def test_stack_collector_includes_threads():
    content = StackCollector().collect()
    assert "Thread" in content or "File" in content


def test_log_collector_tails(tmp_path):
    path = tmp_path / "train.log"
    path.write_text("line1\n" * 100 + "THE_END\n")
    content = LogCollector(str(path), tail_bytes=64).collect()
    assert "THE_END" in content
    assert len(content) <= 64


def test_step_time_collector_reports_delta(tmp_path):
    path = tmp_path / "metrics.json"
    col = StepTimeCollector(str(path))
    assert col.collect() == ""  # no file yet
    path.write_text(json.dumps({"global_step": 10, "timestamp": 1000.0}))
    assert col.collect() == ""  # first observation: no delta yet
    path.write_text(json.dumps({"global_step": 14, "timestamp": 1006.0}))
    assert col.collect() == "1.5000"  # 6s over 4 steps
    assert col.collect() == ""  # no progress since


def test_chip_metrics_collector_makes_no_cuda_context():
    import torch

    before = torch.cuda.is_initialized()
    content = ChipMetricsCollector().collect()
    assert torch.cuda.is_initialized() == before
    if not before:
        assert content.startswith("chip metrics unavailable")
    monitor = DiagnosisMonitor(
        collectors=[ChipMetricsCollector()], client=_FakeClient()
    )
    monitor.report_once()
    assert torch.cuda.is_initialized() == before


def test_capture_hang_evidence_has_stacks_and_worker_tree():
    ev = capture_hang_evidence([os.getpid()])
    assert "File" in ev["stacks"] or "Thread" in ev["stacks"]
    assert f"pid {os.getpid()}" in ev["workers"]
    assert "state=" in ev["workers"]


def test_hang_watchdog_lifecycle(event_log, tmp_path):
    path = tmp_path / "metrics.json"
    now = [1000.0]
    client = _FakeClient()
    wd = HangWatchdog(
        metrics_path=str(path),
        worker_pids_fn=lambda: [os.getpid()],
        threshold=5.0,
        interval=3600,
        client=client,
        clock=lambda: now[0],
    )
    # startup: no metrics file, arbitrarily long wait — NOT a hang
    now[0] += 500
    assert wd.poll_once() is None

    # first progress arms the watchdog
    path.write_text(json.dumps({"global_step": 3, "timestamp": 1.0}))
    assert wd.poll_once() is None

    # stall past the threshold: capture fires with flight data
    now[0] += 6
    payload = wd.poll_once()
    assert payload is not None
    assert payload["stall_s"] >= 5.0
    assert payload["last_step"] == 3
    assert payload["stacks"]
    assert f"pid {os.getpid()}" in payload["workers"]
    assert client.reports and client.reports[0][0] == "hang_evidence"

    # rate limit: same window, no re-capture
    now[0] += 1
    assert wd.poll_once() is None
    # next window: re-capture with the larger stall
    now[0] += 6
    second = wd.poll_once()
    assert second is not None and second["stall_s"] > payload["stall_s"]

    # progress resets everything
    path.write_text(json.dumps({"global_step": 4, "timestamp": 2.0}))
    assert wd.poll_once() is None
    now[0] += 3
    assert wd.poll_once() is None  # below threshold again

    # reset() disarms until fresh progress (post-restart recovery)
    wd.reset()
    now[0] += 500
    assert wd.poll_once() is None

    events = [e for e in read_events(str(event_log))
              if e["type"] == "hang_evidence"]
    assert len(events) == 2
    assert validate_event(events[0]) == []


def test_step_phase_collector_reports_rolling_mean(tmp_path):
    path = tmp_path / "metrics.json"
    col = StepPhaseCollector(str(path), window=4)
    assert col.collect() == ""  # no file
    path.write_text(json.dumps({
        "global_step": 5,
        "phases": {"data_wait": 0.4, "compute": 0.1, "total_s": 0.6},
    }))
    out = json.loads(col.collect())
    assert out["data_wait"] == pytest.approx(0.4)
    assert out["n"] == 1
    assert col.collect() == ""  # same step: nothing new
    path.write_text(json.dumps({
        "global_step": 6,
        "phases": {"data_wait": 0.2, "compute": 0.1, "total_s": 0.4},
    }))
    out = json.loads(col.collect())
    assert out["data_wait"] == pytest.approx(0.3)
    assert out["n"] == 2
