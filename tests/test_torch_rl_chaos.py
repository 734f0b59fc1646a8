"""Twin of ``tests/test_chaos_e2e.py::test_rl_rollout_worker_kill`` for
the port (slice 7), not ``slow``, as in the reference: the elastic PPO
loop (``chaos/scenarios.py``'s ``RL_TRAIN_SCRIPT``, the tiny GPT's four
roles on the CPU) under the port's launcher, a SIGKILL of the rollout
worker on lease 2's ``rl.rollout`` hook, after the experience batch is
generated but before it is buffered, flash-checkpointed or acked.  The
master requeues the lease off the dead worker; the replacement restores
the four-role state, the partial buffer and the cursor from the
post-lease-1 flash snapshot, replays the interrupted iteration's PPO
steps, regenerates the lost lease bit-identically and finishes the
budget.  The scenario's invariants decide it from the event log: the
losses equal the uninterrupted control's (``LossTrajectoryMatches``,
rtol 1e-3 / atol 1e-5), each lease acked exactly once
(``NoDuplicateShards`` on ``rl-rollouts``) and the recovery loss
attributed at 0.5 or more (``GoodputLossAttributed``).  The run has a
file of its own so that it runs beside ``test_torch_chaos_e2e.py``.
"""

import os
import shutil
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.telemetry.timeline import CAT_RL

pytestmark = pytest.mark.chaos


@pytest.fixture()
def root(monkeypatch):
    """A short work root (a unix socket path holds at most 107 bytes);
    the run's shm segment, named after its socket dir, is unlinked at
    the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlrc")
    yield path
    sock = os.path.join(path, "run", "sock")
    if os.path.isdir(sock):
        with harness._patched_env({"DLROVER_SHARED_DIR": sock}):
            SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def test_rl_rollout_worker_kill(root):
    workdir = os.path.join(root, "run")
    report = harness.run_scenario(
        scenarios.rl_rollout_worker_kill(seed=97), workdir=workdir,
        monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    names = {r.name for r in report.invariants}
    assert {"loss_trajectory_matches_control", "no_duplicate_shards",
            "goodput_loss_attributed"} <= names
    # exactly one seeded kill, on the rollout hook of lease 2
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, step = report.timeline[0]
    assert point == "rl.rollout" and action == "kill"
    assert step == 2
    # the RL plane reported its iteration anatomy, across BOTH
    # incarnations (the replay re-trains the restored buffer)
    iters = [e for e in report.events if e.get("type") == "rl_iteration"]
    assert iters, "no rl_iteration events"
    assert {e["restart_count"] for e in iters} == {0, 1}, iters
    assert all(e["rollout_s"] >= 0 and e["train_s"] > 0 for e in iters), iters
    # the restore went through the adapter: the four-role state, the
    # two buffered leases, from the shm tier
    restores = [e for e in report.events
                if e.get("type") == "checkpoint_restore"
                and e.get("rl_roles") is not None]
    assert restores and restores[0]["rl_roles"] == 2
    assert restores[0]["kv_rows"] == 16 and restores[0]["tier"] == "shm"
    # RL phase slices landed on the assembled timeline
    assert report.job_timeline is not None
    assert report.job_timeline.slices_by_cat(CAT_RL)
    # the run really finished: the final PPO update committed durably
    steps = scenarios.RUN_OPTIONS["rl-rollout-worker-kill"]["total_steps"]
    final_step, shards = read_last_checkpoint(os.path.join(workdir, "ckpt"))
    assert final_step == steps and 0 in shards
