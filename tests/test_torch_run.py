"""The launcher and the process-group contract of the port.

- ``init_torch_distributed`` (the counterpart of the reference's
  ``init_jax_distributed``, ``dlrover_tpu/trainer/elastic_trainer.py``)
  forms a 2-process ``gloo`` group from the env the port's agent
  exports after its master rendezvous, and returns ``False`` for one
  process; with no card and no device named it raises instead of
  falling back to the CPU.
- ROADMAP §C 3, kept as in the reference: a respawned master replays
  the round and world from its journal and picks a new coordinator
  port.  The agent's client reads the same round and world after the
  launcher's master watchdog respawned its master.
- the fresh-journal drill: a respawned master on an empty journal dir
  recovers from the storage-tier mirror.
- ``python -m dlrover_tpu_torch.run`` runs a script to completion, and
  its agent persists a worker's checkpoint without loading torch.
- ``chip_smoke.py`` phase 8's worker, which names no device, raises on
  a box without a card.

Every check is exact.
"""

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training import ElasticTrainingAgent, WorkerSpec
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.trainer.elastic_trainer import init_torch_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def sock():
    """A short socket directory: a unix socket path holds at most 107
    bytes, which pytest's ``tmp_path`` under xdist can exceed."""
    path = tempfile.mkdtemp(prefix="dlrs")
    yield path
    shutil.rmtree(path, ignore_errors=True)

GROUP_WORKER = r"""
import json, os, sys
import torch
import torch.distributed as dist
from dlrover_tpu_torch.trainer.elastic_trainer import init_torch_distributed

assert init_torch_distributed(device="cpu") is True
rank = dist.get_rank()
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)
out = {"rank": rank, "world": dist.get_world_size(),
       "backend": dist.get_backend(), "sum": float(x.item()),
       "coordinator": os.environ["DLROVER_COORDINATOR_ADDR"],
       "process_id": os.environ["DLROVER_PROCESS_ID"]}
dist.destroy_process_group()
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def test_two_process_gloo_group_from_the_agent_env(tmp_path):
    import json

    master = JobMaster(port=0, node_num=1, job_name="pg-test")
    master.prepare()
    client = MasterClient(f"127.0.0.1:{master.port}", node_id=0,
                          node_type="worker")
    script = tmp_path / "worker.py"
    script.write_text(GROUP_WORKER)
    try:
        spec = WorkerSpec(
            entrypoint=[sys.executable, str(script), str(tmp_path)],
            nproc_per_node=2, max_restarts=0, monitor_interval=0.2,
        )
        agent = ElasticTrainingAgent(
            spec, client=client, node_rank=0, start_monitors=False
        )
        assert agent.run() == 0
    finally:
        client.close()
        master.stop()
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert [o["rank"] for o in outs] == [0, 1]
    assert [o["process_id"] for o in outs] == ["0", "1"]
    assert all(o["world"] == 2 and o["backend"] == "gloo" for o in outs)
    assert all(o["sum"] == 3.0 for o in outs)
    assert outs[0]["coordinator"] == outs[1]["coordinator"]


def test_one_process_forms_no_group(monkeypatch):
    monkeypatch.setenv("DLROVER_COORDINATOR_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("DLROVER_NUM_PROCESSES", "1")
    assert init_torch_distributed(device="cpu") is False
    monkeypatch.delenv("DLROVER_COORDINATOR_ADDR")
    monkeypatch.setenv("DLROVER_NUM_PROCESSES", "2")
    assert init_torch_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_group_needs_the_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DLROVER_COORDINATOR_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("DLROVER_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_torch_distributed()
    assert not torch.distributed.is_initialized()


def test_fresh_journal_drill_raises_naming_its_slice(tmp_path, monkeypatch,
                                                    sock):
    """The fresh-journal master respawn drill (the deferral this test
    pinned until slice 8.1 ported it): with the drill armed, the
    watchdog respawns a SIGKILLed local master on an EMPTY journal dir
    of its own, which recovers the round and world from the
    storage-tier journal mirror alone; shutdown removes that dir."""
    from dlrover_tpu_torch import run as launcher
    from dlrover_tpu_torch.telemetry.events import read_events

    events = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sock)
    monkeypatch.setenv("DLROVER_EVENT_LOG", events)
    monkeypatch.setenv("DLROVER_MASTER_JOURNAL_MIRROR_DIR",
                       str(tmp_path / "mirror"))
    monkeypatch.setenv("DLROVER_JOURNAL_MIRROR_INTERVAL_S", "0.05")
    monkeypatch.setenv(launcher.MASTER_FRESH_JOURNAL_ENV, "1")
    journal = str(tmp_path / "journal")
    proc, addr = launcher._launch_local_master(1, journal_dir=journal)
    supervisor = launcher._MasterSupervisor(proc, addr, 1, journal)
    client = MasterClient(addr, node_id=0, node_type="worker",
                          node_rank=0, local_world_size=1)
    try:
        client.join_rendezvous(0, 1, RendezvousName.ELASTIC_TRAINING)
        before = client.get_comm_world(RendezvousName.ELASTIC_TRAINING, 0)
        assert before[0] == 1 and before[2] == {0: 1}
        time.sleep(0.5)  # several mirror group commits
        first = supervisor.proc
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
        deadline = time.time() + 60
        while supervisor.restarts < 1 and time.time() < deadline:
            time.sleep(0.1)
        assert supervisor.restarts == 1
        after = client.get_comm_world(RendezvousName.ELASTIC_TRAINING, 0)
        assert after[:3] == before[:3]
        fresh = list(supervisor._fresh_journal_dirs)
        assert len(fresh) == 1 and fresh[0] != journal
    finally:
        client.close()
        supervisor.shutdown()
    assert not os.path.exists(fresh[0])
    recovered = [e for e in read_events(events)
                 if e.get("type") == "master_recovered"]
    assert recovered and recovered[-1]["from_mirror"] is True, recovered


def test_respawned_master_keeps_round_and_world(tmp_path, monkeypatch,
                                                sock):
    """ROADMAP §C 3: the launcher's watchdog respawns a SIGKILLed local
    master on the same port and journal; the agent's client then reads
    the replayed round and world, and a coordinator the new master
    picked (host kept, port picked anew, as in the reference)."""
    from dlrover_tpu_torch.run import _launch_local_master, _MasterSupervisor

    monkeypatch.setenv("DLROVER_SHARED_DIR", sock)
    journal = str(tmp_path / "journal")
    proc, addr = _launch_local_master(1, journal_dir=journal)
    supervisor = _MasterSupervisor(proc, addr, 1, journal)
    client = MasterClient(addr, node_id=0, node_type="worker",
                          node_rank=0, local_world_size=1)
    try:
        client.join_rendezvous(0, 1, RendezvousName.ELASTIC_TRAINING)
        before = client.get_comm_world(RendezvousName.ELASTIC_TRAINING, 0)
        assert before[0] == 1 and before[2] == {0: 1}
        first = supervisor.proc
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
        deadline = time.time() + 60
        while supervisor.restarts < 1 and time.time() < deadline:
            time.sleep(0.1)
        assert supervisor.restarts == 1
        after = client.get_comm_world(RendezvousName.ELASTIC_TRAINING, 0)
        assert after[:3] == before[:3]
        assert after[3].rsplit(":", 1)[0] == before[3].rsplit(":", 1)[0]
        assert client.num_nodes_waiting(
            RendezvousName.ELASTIC_TRAINING) == 0
    finally:
        client.close()
        supervisor.shutdown()
    assert supervisor.proc.poll() is not None


def test_launcher_module_runs_a_script(tmp_path, sock):
    script = tmp_path / "ok.py"
    script.write_text(
        "import os, sys\n"
        "open(sys.argv[1], 'w').write(os.environ['DLROVER_RANK'])\n"
    )
    out = tmp_path / "rank.txt"
    env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_SHARED_DIR=sock,
               DLROVER_MASTER_ADDR="")
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run",
         "--nproc_per_node=1", "--max_restarts=0",
         "--monitor_interval=0.2", str(script), str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out.read_text() == "0"


PERSIST_WORKER = r"""
import json, os, sys, time
import torch
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType

ckpt_dir, out = sys.argv[1], sys.argv[2]
ckpt = Checkpointer(ckpt_dir)
ckpt.save_checkpoint(1, {"w": torch.arange(4.0)},
                     storage_type=StorageType.DISK)
ckpt.wait()
tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")
deadline = time.time() + 60
while time.time() < deadline and not os.path.exists(tracker):
    time.sleep(0.05)
with open(f"/proc/{os.getppid()}/maps") as f:
    agent = f.read()
with open("/proc/self/maps") as f:
    me = f.read()
with open(out, "w") as f:
    json.dump({"committed": open(tracker).read().strip(),
               "agent_torch": "libtorch" in agent,
               "worker_torch": "libtorch" in me}, f)
ckpt.close()
"""


def test_the_agent_persists_without_loading_torch(tmp_path, monkeypatch,
                                                  sock):
    """The worker's storage save is persisted and committed by the
    launcher's agent, whose process maps no torch library (a CUDA
    build maps the CUDA driver's with it)."""
    import json

    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    script = tmp_path / "persist.py"
    script.write_text(PERSIST_WORKER)
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_SHARED_DIR=sock,
               DLROVER_MASTER_ADDR="")
    env.pop("DLROVER_JOB_NAME", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run",
             "--nproc_per_node=1", "--max_restarts=0",
             "--monitor_interval=0.2", str(script),
             str(tmp_path / "ckpt"), str(out)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=180,
        )
    finally:
        monkeypatch.setenv("DLROVER_SHARED_DIR", sock)
        monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
        SharedMemoryHandler(0).unlink()
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(out.read_text())
    assert result == {"committed": "1", "agent_torch": False,
                      "worker_torch": True}


def test_the_launcher_worker_of_chip_smoke_needs_the_card(tmp_path, sock):
    """``chip_smoke.py`` phase 8's GPT-2 small worker names no device:
    with no card it raises instead of training on the CPU."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    script = tmp_path / "worker.py"
    script.write_text(chip_smoke.LAUNCHER_WORKER_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_SHARED_DIR=sock,
               DLROVER_CHAOS_TOTAL_STEPS="8", DLROVER_CHAOS_CKPT_EVERY="2")
    env.pop("DLROVER_JOB_NAME", None)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would train on it")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "ckpt"),
         str(tmp_path)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "incarnation_0.json").exists()


def test_auto_config_starts_one_process_a_gpu(monkeypatch):
    """``--nproc_per_node=auto`` (or ``--auto-config``) counts the node's
    NVIDIA cards without loading torch; a node with none runs one."""
    from dlrover_tpu_torch import run as launcher

    args = launcher.parse_args(["--nproc_per_node=auto", "train.py"])
    assert args.nproc_per_node == 0
    monkeypatch.setattr(launcher, "count_local_gpus", lambda: 4)
    assert launcher.apply_auto_config(args).nproc_per_node == 4
    args = launcher.parse_args(["--auto-config", "train.py"])
    monkeypatch.setattr(launcher, "count_local_gpus", lambda: 0)
    assert launcher.apply_auto_config(args).nproc_per_node == 1
    args = launcher.parse_args(["--nproc_per_node=2", "train.py"])
    assert launcher.apply_auto_config(args).nproc_per_node == 2
