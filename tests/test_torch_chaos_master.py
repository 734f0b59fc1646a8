"""Twins of the master-recovery cases of ``tests/test_chaos_e2e.py``
(``:148`` and ``:637``) for the port (slice 8.1): the master is
SIGKILLed on its 3rd shard dispatch while the tiny-GPT chaos loop
trains one step per shard task of the master's sharded dataset
(``IndexShardingClient``'s parent, the port's ``ShardingClient``).  The
launcher's watchdog respawns the master on the same port; it replays
its journal (or, with a fresh journal dir, seeds from the storage-tier
mirror) and training completes with every sample index acked exactly
once (``NoDuplicateShards``), no healthy worker restarted and the final
step committed — all decided from the telemetry event log alone, as in
the reference.  The fresh-journal twin is ``slow``, as its reference.
"""

import json
import os
import shutil
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

pytestmark = pytest.mark.chaos

TOTAL_STEPS = 8


@pytest.fixture()
def root(monkeypatch):
    """A short work root (a unix socket path holds at most 107 bytes);
    each run's shm segment, which outlives the job by design, is
    unlinked at the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlcm")
    yield path
    for name in os.listdir(path):
        sock = os.path.join(path, name, "sock")
        if os.path.isdir(sock):
            with harness._patched_env({"DLROVER_SHARED_DIR": sock}):
                SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def test_master_kill_restart_midround(root):
    """Tier-1 acceptance: SIGKILL the MASTER on its 3rd shard dispatch
    mid-rendezvous-round.  The launcher's watchdog respawns it on the
    same port; the new incarnation replays the state journal, re-enters
    round 1, re-queues only the un-acked shard, parked clients
    session-resync — and training completes with NO healthy-worker
    restart, no duplicate shard completions, none lost."""
    workdir = os.path.join(root, "run")
    report = harness.run_scenario(
        scenarios.master_kill_restart_midround(seed=31),
        workdir=workdir, total_steps=TOTAL_STEPS, ckpt_every=2,
        monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    names = [r.name for r in report.invariants]
    assert "no_duplicate_shards" in names and "master_recovered" in names
    # exactly one seeded master kill, at a shard dispatch
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, _step = report.timeline[0]
    assert point == "master.task_dispatch" and action == "kill"
    respawns = [
        e for e in report.events if e.get("type") == "master_respawn"
    ]
    recoveries = [
        e for e in report.events
        if e.get("type") == "master_recovered"
    ]
    assert len(respawns) == 1 and len(recoveries) == 1
    assert recoveries[0]["requeued"] >= 1
    assert recoveries[0]["rdzv_round"] == 1
    acks = sorted(
        (e["start"], e["end"]) for e in report.events
        if e.get("type") == "shard_ack" and e.get("success")
    )
    assert acks == [(i, i + 1) for i in range(TOTAL_STEPS)], acks
    final_step, shards = read_last_checkpoint(os.path.join(workdir, "ckpt"))
    assert final_step == TOTAL_STEPS and 0 in shards
    # the reference also asserts a positive loss attribution; the
    # step-gap rule credits the outage as productive when a loaded box
    # stretches every step past a third of it, so the twin leaves it to
    # the GoodputConservation invariant above
    jt = report.job_timeline
    assert jt is not None and jt.master_incarnations == 2
    json.dumps(report.attribution)


@pytest.mark.slow
def test_master_respawn_other_host(root):
    """The master is SIGKILLed mid-dispatch and its respawn gets a
    FRESH, EMPTY journal dir — a replacement host's view — so recovery
    must be seeded from the storage-tier journal mirror (async group
    commit).  Exactly-once sharding still holds."""
    report = harness.run_scenario(
        scenarios.master_respawn_other_host(seed=79),
        workdir=os.path.join(root, "run"), total_steps=TOTAL_STEPS,
        ckpt_every=2, monitor_interval=0.3, max_restarts=2,
    )
    assert report.ok, report.summary()
    recovered = [
        e for e in report.events
        if e.get("type") == "master_recovered"
    ]
    assert recovered and recovered[0].get("from_mirror") is True
    flushes = [
        e for e in report.events
        if e.get("type") == "journal_mirror_flush"
    ]
    assert flushes
    assert all(e.get("lag_s", 0) < 5.0 for e in flushes), flushes
