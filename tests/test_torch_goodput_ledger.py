"""Twin of ``tests/test_goodput_ledger.py``, against the port (:mod:`dlrover_tpu_torch`).

Goodput ledger (telemetry/goodput.py + master/goodput_ledger.py):
per-incarnation wall-clock partition, the conservation invariant, the
SpeedMonitor cross-check, and the CLI reporter's determinism.

The harness case (``GoodputConservation`` on a synthetic kill) comes
with slice 3b.2's chaos harness.
"""

import json
import os
import subprocess
import sys

import pytest

from dlrover_tpu_torch.master.goodput_ledger import GoodputLedgerService
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.telemetry import goodput
from dlrover_tpu_torch.telemetry.metrics import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(
    REPO, "tests", "fixtures",
    "master_kill_restart_midround_events.jsonl",
)
GOLDEN = os.path.join(
    REPO, "tests", "fixtures", "goodput_report_golden.txt"
)


def _ev(type_, ts, **fields):
    return {"type": type_, "ts": ts, **fields}


def _steps(t0, n, dt=0.1, node=0, rc=0, first=1):
    return [
        _ev(
            "train_step", t0 + i * dt, step=first + i,
            restart_count=rc, node_rank=node,
        )
        for i in range(n)
    ]


def _worker_kill_events():
    """A worker-kill run in miniature: 5 steps, a kill injection, the
    witnessed respawn with measured recovery phases, then recovery."""
    t0 = 1000.0
    ev = _steps(t0, 5)
    kill_ts = t0 + 0.45
    ev.append(_ev(
        "chaos_inject", kill_ts, scenario="kill-worker-midstep",
        seed=1, seq=1, point="worker.step", rule="kill", action="kill",
        step=5, node_rank=0,
    ))
    ev.append(_ev(
        "worker_restart", kill_ts + 0.8, node_rank=0,
        restart_count=1, reason="exit(137)",
    ))
    ev.append(_ev(
        "recovery_phase", kill_ts + 1.3, phase="spawn", seconds=0.5,
        restart_count=1, node_rank=0,
    ))
    ev.append(_ev(
        "recovery_phase", kill_ts + 1.9, phase="import", seconds=0.6,
        restart_count=1, node_rank=0,
    ))
    ev.append(_ev(
        "rendezvous_complete", kill_ts + 2.3,
        rdzv="elastic-training", round=2, nodes=[0], wait_s=0.4,
    ))
    ev.append(_ev(
        "checkpoint_restore", kill_ts + 2.9, step=4, tier="shm",
        rank=0, total_s=0.6,
    ))
    ev.append(_ev(
        "recovery_phase", kill_ts + 2.9, phase="restore",
        seconds=0.6, restart_count=1, node_rank=0,
    ))
    ev.append(_ev(
        "recovery_phase", kill_ts + 3.5, phase="retrace",
        seconds=0.6, restart_count=1, node_rank=0,
    ))
    ev.extend(_steps(kill_ts + 3.6, 5, rc=1, first=5))
    return ev


def test_uninterrupted_run_agrees_with_speed_monitor_within_1pct():
    t0 = 2000.0
    events = _steps(t0, 60, dt=0.2)
    sm = SpeedMonitor(registry=MetricsRegistry())
    for e in events:
        sm.collect_global_step(e["step"], e["ts"])
    ledger = goodput.build_ledger(events)
    assert ledger.conservation_errors() == []
    assert abs(ledger.goodput() - sm.legacy_goodput()) <= 0.01, (
        ledger.goodput(), sm.legacy_goodput(),
    )


def test_worker_kill_partition_closes_and_names_the_loss():
    ledger = goodput.build_ledger(_worker_kill_events())
    assert ledger.conservation_errors() == []
    incs = {
        (i.node, i.incarnation): i for i in ledger.incarnations
    }
    assert set(incs) == {(0, 0), (0, 1)}
    # the respawn's window opens at the death witness, not the
    # agent's later restart record
    assert incs[(0, 1)].witnessed
    assert incs[(0, 1)].start == pytest.approx(1000.45)
    # every recovery phase left its category, and >=90% of the
    # non-productive time is NAMED (the worker-kill acceptance bar)
    for cat in (
        goodput.RESPAWN, goodput.RESTORE, goodput.COMPILE,
        goodput.RENDEZVOUS,
    ):
        assert ledger.totals[cat] > 0, (cat, ledger.totals)
    loss = ledger.loss_totals()
    nonprod = sum(loss.values())
    named = nonprod - loss[goodput.IDLE]
    assert nonprod > 1.0
    assert named / nonprod >= 0.9, loss
    assert ledger.top_loss_causes(3)[0][0] != goodput.IDLE


def test_conservation_violation_is_reported():
    inc = goodput.IncarnationLedger(
        node=0, incarnation=0, start=0.0, end=10.0,
        seconds={goodput.PRODUCTIVE: 5.0},
    )
    ledger = goodput.GoodputLedger(incarnations=[inc])
    errors = ledger.conservation_errors()
    assert len(errors) == 1 and "residual" in errors[0]


def test_overlapping_resize_incarnations_both_close():
    """Old world draining while the new world rendezvouses: node 0's
    respawn window overlaps node 1's still-open incarnation; both
    partitions must close and the drain must be booked."""
    t0 = 3000.0
    ev = _steps(t0, 20, node=0) + _steps(t0, 40, node=1)
    ev.append(_ev(
        "resize_decision", t0 + 2.3, target=1, from_world=2,
        reason="node-lost", round=2, detected_ts=t0 + 2.0,
    ))
    ev.append(_ev(
        "worker_restart", t0 + 2.8, node_rank=0, restart_count=1,
        reason="resize",
    ))
    ev.append(_ev(
        "rendezvous_complete", t0 + 3.1, rdzv="elastic-training",
        round=2, nodes=[1], wait_s=0.3,
    ))
    ev.extend(_steps(t0 + 3.3, 10, node=0, rc=1, first=21))
    ledger = goodput.build_ledger(ev)
    assert ledger.conservation_errors() == []
    nodes = {(i.node, i.incarnation) for i in ledger.incarnations}
    assert nodes == {(0, 0), (0, 1), (1, 0)}
    by_key = {(i.node, i.incarnation): i for i in ledger.incarnations}
    # genuinely overlapping wall-clock windows
    assert by_key[(0, 1)].start < by_key[(1, 0)].end
    assert ledger.totals[goodput.DRAIN] > 0, ledger.totals


def test_master_kill_silent_gap_lands_in_idle_unattributed():
    """A master-kill gap has NO process alive to emit: the silence
    must land in idle_unattributed — never crash, never break
    conservation."""
    t0 = 4000.0
    ev = _steps(t0, 10)
    ev.extend(_steps(t0 + 31.0, 10, first=11))
    ledger = goodput.build_ledger(ev)
    assert ledger.conservation_errors() == []
    assert len(ledger.incarnations) == 1
    assert ledger.totals[goodput.IDLE] > 25.0, ledger.totals
    assert ledger.goodput() < 0.2


def test_ledger_service_publishes_counters_and_divergence(
    tmp_path, monkeypatch
):
    src = tmp_path / "events.jsonl"
    t0 = 5000.0
    ev = _steps(t0, 10)
    ev.extend(_steps(t0 + 31.0, 10, first=11))
    src.write_text(
        "".join(json.dumps(e) + "\n" for e in ev)
    )
    out = tmp_path / "service_out.jsonl"
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(out))
    monkeypatch.delenv("DLROVER_EVENTS_AGGREGATE_GLOB", raising=False)
    reg = MetricsRegistry()
    sm = SpeedMonitor(registry=reg)
    # the monitor only saw the fast steps (an agent outage hid the
    # gap from it): legacy ~1.0, the ledger knows better
    for e in ev[:10]:
        sm.collect_global_step(e["step"], e["ts"])
    svc = GoodputLedgerService(
        speed_monitor=sm, sources=[str(src)], interval=0.0,
        registry=reg,
    )
    assert svc.tick()
    assert sm.goodput() == pytest.approx(
        goodput.build_ledger(ev).goodput()
    )
    emitted = [
        json.loads(line)
        for line in out.read_text().splitlines()
    ]
    types = [e["type"] for e in emitted]
    assert "goodput_ledger" in types
    assert "goodput_divergence" in types
    # counters are monotone across re-assembly
    before = dict(svc._last_seconds)
    assert svc.tick()
    for cat, val in before.items():
        assert svc._last_seconds[cat] >= val


def _run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.telemetry.goodput"]
        + args,
        capture_output=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


@pytest.mark.slow
def test_cli_replay_is_deterministic_and_matches_golden(tmp_path):
    first = _run_cli([FIXTURE])
    second = _run_cli([FIXTURE])
    assert first.returncode == 0, first.stderr
    assert first.stdout == second.stdout
    with open(GOLDEN, "rb") as f:
        assert first.stdout == f.read()


def test_report_is_deterministic_in_process():
    events = list(goodput.collect_events([FIXTURE]))
    one = goodput.to_report(goodput.build_ledger(events))
    two = goodput.to_report(goodput.build_ledger(list(events)))
    assert one == two
    with open(GOLDEN, "r") as f:
        assert one == f.read()


def test_timeline_report_embeds_goodput_section():
    from dlrover_tpu_torch.telemetry import timeline

    events = list(goodput.collect_events([FIXTURE]))
    tl = timeline.assemble(events)
    report = timeline.to_report(tl)
    assert "=== goodput ledger ===" in report
    assert "conservation: max residual" in report
    trace = timeline.to_chrome_trace(tl)
    goodput_rows = [
        t for t in trace["traceEvents"] if t.get("cat") == "goodput"
    ]
    assert goodput_rows, "no goodput track in the chrome trace"
