"""The port's control plane end to end on the CPU: the master as a child
process (``python -m dlrover_tpu_torch.master.main``), a port
``MasterClient`` joining its rendezvous, the ``TrainingMonitor``
feeding it from a ``Trainer``'s metrics file, and a SIGKILL of the
master with a restart on the same journal directory.  The same path
that ``chip_smoke.py`` phase 7 drives on the card, at a tiny model.

Every server binds a free port, every wait and socket has a timeout,
and every child is killed in a ``finally``.
"""

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import HeartbeatReporter, TrainingMonitor
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import MessageClient, find_free_port
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

ROOT = Path(__file__).resolve().parent.parent
SERVE_TIMEOUT_S = 30.0


def _metrics(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines()
            if line and not line.startswith("#") and "{" not in line}


def _spawn_master(port, metrics_port, journal, log):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DLROVER_MASTER_JOURNAL_DIR=journal,
               DLROVER_METRICS_PORT=str(metrics_port))
    with open(log, "a") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.master.main",
             "--port", str(port), "--node_num", "1", "--job_name", "cp"],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    probe = MessageClient(f"127.0.0.1:{port}", timeout=2.0, retries=1)
    t0 = time.monotonic()
    try:
        while True:
            assert proc.poll() is None, open(log).read()
            try:
                probe.get(msg.NumNodesWaitingRequest(
                    rdzv_name="elastic-training"))
                return proc
            except (ConnectionError, OSError):
                assert time.monotonic() - t0 < SERVE_TIMEOUT_S, \
                    open(log).read()
                time.sleep(0.02)
    finally:
        probe.close()


def _kill(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
    if proc is not None:
        proc.wait(timeout=30)


def test_master_main_serves_restarts_and_replays(tmp_path):
    port, metrics_port = find_free_port(), find_free_port()
    journal, log = str(tmp_path / "journal"), str(tmp_path / "master.log")
    first = second = client = None
    try:
        first = _spawn_master(port, metrics_port, journal, log)
        client = MasterClient(f"127.0.0.1:{port}", node_id=0,
                              node_type="worker", node_rank=0,
                              local_world_size=1)
        client.report_node_event("added", "running")
        client.join_rendezvous(0, 1, "elastic-training", "127.0.0.1")
        world = client.get_comm_world("elastic-training", 0)
        assert world[0] == 1 and world[2] == {0: 1}
        assert world[3].startswith("127.0.0.1:")
        for step in range(1, 6):
            client.report_global_step(step, 1000.0 + 0.5 * step)
        values = _metrics(metrics_port)
        assert values["dlrover_global_step"] == 5
        assert values["dlrover_steps_per_second"] == pytest.approx(2.0)

        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
        second = _spawn_master(port, metrics_port, journal, log)
        # the first attempt meets the dead connection; the retry reaches
        # the new master and replays the session resync (the last step)
        client.report_global_step(5, 1003.0)
        # the round and world replay; the coordinator's port is picked
        # anew by each master process, as in the reference
        assert client.get_comm_world("elastic-training", 0)[:3] == world[:3]
        assert client.num_nodes_waiting("elastic-training") == 0
        assert _metrics(metrics_port)["dlrover_global_step"] == 5
        assert "recovered from journal" in open(log).read()
    finally:
        if client is not None:
            client.close()
        _kill(first)
        _kill(second)
    assert first.poll() is not None and second.poll() is not None


@pytest.fixture()
def checkpoint_scope(monkeypatch, tmp_path):
    """A shm namespace, socket directory, metrics file and event log of
    the test's own."""
    sockets = tempfile.mkdtemp(prefix="dlc")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"test-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    monkeypatch.setenv("DLROVER_METRICS_FILE", str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(tmp_path / "events.jsonl"))
    yield
    AsyncCheckpointSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def test_training_monitor_feeds_the_master_from_a_trainer(
        tmp_path, checkpoint_scope):
    """A tiny GPT trains on the CPU through ``Trainer``; the monitor
    tails its metrics file and the master's speed monitor ends on the
    trainer's last step, at the speed of the trainer's own clock."""
    steps = 5
    master = JobMaster(port=0, node_num=1, job_name="cp")
    master.prepare()
    client = monitor = beat = None
    try:
        client = MasterClient(f"127.0.0.1:{master.port}", node_id=0,
                              node_type="worker", node_rank=0,
                              local_world_size=1)
        client.join_rendezvous(0, 1, "elastic-training", "127.0.0.1")
        sent = []
        report = client.report_global_step

        def recorded(step, timestamp=0.0):
            sent.append((step, timestamp))
            return report(step, timestamp)

        client.report_global_step = recorded
        monitor = TrainingMonitor(os.environ["DLROVER_METRICS_FILE"],
                                  interval=0.005, client=client)
        beat = HeartbeatReporter(interval=0.05, client=client)
        monitor.start()
        beat.start()
        data = np.random.default_rng(0).integers(0, 256, (8, 65),
                                                 dtype=np.int32)
        model = port_gpt.GPT(port_gpt.GPTConfig.tiny(dtype=torch.float32),
                             device="cpu", seed=0)
        args = TrainingArguments(
            output_dir=str(tmp_path / "ckpt"), resume_from_checkpoint=False,
            max_steps=steps, global_batch_size=8, micro_batch_size=4)
        trainer = Trainer(
            model, args, [{"x": data[:, :-1], "y": data[:, 1:]}],
            lambda m, b: port_gpt.cross_entropy_loss(m(b["x"]), b["y"]),
            device="cpu")
        result = trainer.train()
        monitor.stop()
        monitor._thread.join(timeout=30)
        beat.stop()
        beat._thread.join(timeout=30)
        sm = master.speed_monitor
        assert sm.completed_global_step == steps == result["steps"]
        first, last = sent[0], sent[-1]
        assert last[0] == steps
        # the master's speed is the trainer's, on the trainer's clock
        assert sm.running_speed() == pytest.approx(
            (last[0] - first[0]) / (last[1] - first[1]))
        assert 0 in sm.running_workers
    finally:
        for m in (monitor, beat):
            if m is not None:
                m.stop()
        if client is not None:
            client.close()
        master.stop()
