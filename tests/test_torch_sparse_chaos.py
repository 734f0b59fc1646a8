"""Twins of the sparse chaos tests of ``tests/test_chaos_e2e.py``
(``test_sparse_kill_restore``, ``test_sparse_spill_io_error_graceful``,
``test_sparse_streaming_reshard_kill``, tier-1 as in the reference, and
the ``slow`` ``test_sparse_resize_churn``) for the port: the real
supervision tree (``dlrover_tpu_torch.run``'s launcher in-process, a
local master child) over the port's sparse loops of
``chaos/scenarios.py`` on the CPU, SIGKILLs and spill-disk faults from
the scenarios, and the invariants deciding from the event log: the
losses equal the uninterrupted control's (``LossTrajectoryMatches``,
rtol 1e-3 / atol 1e-5) and the ``kv_checkpoint`` digests prove rows,
frequencies and optimizer slots bit-identical through the cycle
(``KvStateRoundTrip``), the spill breaker tripped
(``SpillBreakerTripped``), the streaming reshard replayed exactly once
against the seeder's digests (``KvStreamingReshardReplayed``), and the
resize redistributed the hash table exactly once
(``KvReshardExactlyOnce``).
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

pytestmark = pytest.mark.chaos


@pytest.fixture()
def root(monkeypatch):
    """A short work root (a unix socket path holds at most 107 bytes);
    every run's shm segment, named after its socket dir, is unlinked at
    the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlsc")
    yield path
    for dirpath, dirnames, _ in os.walk(path):
        for d in dirnames:
            if d.startswith("sock"):
                with harness._patched_env(
                        {"DLROVER_SHARED_DIR": os.path.join(dirpath, d)}):
                    SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def _kv(report, stage):
    return [e for e in report.events
            if e.get("type") == "kv_checkpoint" and e.get("stage") == stage]


def test_the_sparse_control_is_deterministic():
    """The loss invariant compares a run with an in-process control:
    the loop's control gives the same losses twice, bit for bit, and
    trains."""
    a = scenarios.sparse_reference_losses(6)
    b = scenarios.sparse_reference_losses(6)
    assert a == b and all(np.isfinite(a))


def test_sparse_kill_restore(root):
    report = harness.run_scenario(
        scenarios.sparse_kill_restore(seed=61),
        workdir=os.path.join(root, "run"), monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    names = {r.name for r in report.invariants}
    assert {"kv_state_round_trip",
            "loss_trajectory_matches_control"} <= names
    # exactly one seeded kill, mid-step, in the window
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, step = report.timeline[0]
    assert point == "trainer.step" and action == "kill"
    assert 5 <= step <= 7
    # the spill tier was really active at export time
    exports = _kv(report, "export")
    assert exports and any(e["spilled_rows"] > 0 for e in exports)
    # same-world restore: this rank's own shard, never a reshard
    restores = _kv(report, "restore")
    assert restores and all(not e.get("resharded") for e in restores)
    total = scenarios.RUN_OPTIONS["sparse-kill-restore"]["total_steps"]
    final_step, shards = read_last_checkpoint(
        os.path.join(root, "run", "ckpt"))
    assert final_step == total and 0 in shards


def test_sparse_spill_io_error_graceful(root):
    report = harness.run_scenario(
        scenarios.sparse_spill_io_error(seed=67),
        workdir=os.path.join(root, "run"), monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    assert sorted(t[3] for t in report.timeline) == ["io_error", "kill"]
    exports = _kv(report, "export")
    assert any(e.get("lost_rows", 0) > 0 for e in exports), exports
    assert any(e.get("spill_disabled") for e in exports), exports


def test_sparse_streaming_reshard_kill(root):
    report = harness.run_scenario(
        scenarios.sparse_streaming_reshard_kill(seed=79),
        workdir=os.path.join(root, "run"), monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, _step = report.timeline[0]
    assert point == "kv.reshard_chunk" and action == "kill"
    chunks = [e for e in report.events
              if e.get("type") == "kv_reshard_chunk"]
    assert chunks, "no kv_reshard_chunk events recorded"
    restores = [e for e in _kv(report, "restore") if e.get("streamed")]
    assert restores and restores[-1]["chunks"] > 1


@pytest.mark.slow
def test_sparse_resize_churn(root):
    """2 -> 1 -> 2 with the hash-partitioned table: both cross-world
    restores reshard the tables from committed storage exactly once,
    the dense FSDP2 leg keeps the control's losses."""
    report = harness.run_elastic_resize_scenario(
        scenarios.sparse_resize_churn(seed=71),
        workdir=os.path.join(root, "run"),
    )
    assert report.ok, report.summary()
    resharded = [e for e in _kv(report, "restore") if e.get("resharded")]
    assert {e["world_size"] for e in resharded} == {1, 2}
    restores = [e for e in report.events
                if e.get("type") == "checkpoint_restore"]
    assert restores and all(e.get("tier") == "storage" for e in restores)
