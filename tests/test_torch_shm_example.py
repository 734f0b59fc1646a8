"""The twin of ``examples/train_with_shm_loader.py``
(``dlrover_tpu_torch/examples/train_with_shm_loader.py``) on the CPU, at
its ``--smoke`` size (a tiny GPT, seq 128, batch 4):

- its smoke run ends and reports its loader's stats;
- under ``python -m dlrover_tpu_torch.run`` (in-process, as the chaos
  harness drives it) the plain ``ElasticDataLoader`` over the master's
  sharding and the ``ShmDataLoader`` over the same indices give the
  same losses, bit for bit;
- fed by ``IndexShardingClient`` with its dataset position in the flash
  checkpoint, the worker SIGKILLed at step 4 (``kill_worker_midstep``,
  step window [4, 4], warm restarts) is respawned, restores step 2 and
  its dataset position from shm, and every sample index is acked
  exactly once (``NoDuplicateShards``) while every loss equals the
  shm control's, bit for bit; no process or shm segment of the run is
  left.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

pytestmark = pytest.mark.chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "dlrover_tpu_torch", "examples",
                       "train_with_shm_loader.py")
STEPS, BATCH = 8, 4


@pytest.fixture()
def root(monkeypatch):
    """A short work root (unix socket paths hold 107 bytes); each run's
    checkpoint segment is unlinked at the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlsx")
    yield path
    for name in os.listdir(path):
        sock = os.path.join(path, name, "sock")
        if os.path.isdir(sock):
            with harness._patched_env({"DLROVER_SHARED_DIR": sock}):
                SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def _losses(record_dir):
    out = {}
    for name in sorted(os.listdir(record_dir)):
        with open(os.path.join(record_dir, name)) as f:
            rec = json.load(f)
        out[rec["restart_count"]] = rec
    return out


def _launch(root, name, loader, scenario=None, ckpt=False):
    workdir = os.path.join(root, name)
    record = os.path.join(workdir, "record")
    control = scenario or scenarios.Scenario.from_dict(
        {"name": "control", "seed": 0, "rules": []})
    env, event_log = harness.scenario_env(control, workdir, STEPS, 2)
    argv = [EXAMPLE, "--smoke", "--device", "cpu", "--steps", str(STEPS),
            "--loader", loader, "--record", record]
    if ckpt:
        argv += ["--ckpt-dir", os.path.join(workdir, "ckpt")]
    rc = harness.launch(scenario, env, argv, max_restarts=1,
                        monitor_interval=0.3, warm_restart=True)
    return rc, workdir, event_log, _losses(record)


def _shm_segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("shmloader_")}


def test_example_smoke_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m",
         "dlrover_tpu_torch.examples.train_with_shm_loader", "--smoke",
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: {'input_wait_s'" in proc.stdout
    assert "'batches': 5" in proc.stdout


def test_loaders_agree_and_the_killed_worker_resumes_its_shards(root):
    before = _shm_segments()
    losses = {}
    for loader in ("plain", "shm"):
        rc, _, _, rec = _launch(root, loader, loader)
        assert rc == 0 and list(rec) == [0] and rec[0]["done"]
        losses[loader] = [s["loss"] for s in rec[0]["steps"]]
        assert [s["step"] for s in rec[0]["steps"]] == list(
            range(1, STEPS + 1))
    assert losses["plain"] == losses["shm"]

    scenario = scenarios.kill_worker_midstep(seed=42)
    scenario.rules[0].step_window = [4, 4]
    rc, workdir, event_log, rec = _launch(root, "kill", "sharded",
                                          scenario, ckpt=True)
    report = harness._build_report(scenario, rc, workdir, event_log)
    harness.check_invariants(report, [
        harness.WorkerRestarted(),
        harness.RestoredFromTier("shm"),
        harness.NoDuplicateShards(dataset_size=STEPS * BATCH,
                                  dataset="shm-example"),
        harness.TrainingCompleted(total_steps=STEPS),
        harness.LossTrajectoryMatches(losses["shm"]),
        harness.NoOrphanProcesses(marker=workdir),
    ])
    assert rc == 0 and report.ok, report.summary()
    assert sorted(rec) == [0, 1] and rec[1]["start_step"] == 2
    first = [s["loss"] for s in rec[0]["steps"]]
    assert len(first) == 4 and first == losses["shm"][:4]
    assert [s["loss"] for s in rec[1]["steps"]] == losses["shm"][2:]
    acks = sorted((e["start"], e["end"]) for e in report.events
                  if e.get("type") == "shard_ack")
    assert acks == [(i, i + BATCH) for i in range(0, STEPS * BATCH, BATCH)]
    assert _shm_segments() <= before
