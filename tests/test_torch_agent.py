"""Twins of ``tests/test_agent.py`` for the port's agent layer, against
the port's own in-process master: the master client's RPCs, the
rendezvous handler, worker supervision and restart, the preemption
monitor, the launcher's auto-config and the node check's fault
injection.

The sharding client is the port's own since slice 8.1, the platform
starter since slice 8.3: its twin builds the reference starter's argv
and hands it to the port's launcher.  The chip matmul probe runs its bf16 GEMM
chain on the CPU here (on every GPU by default) and refuses to fall
back to the CPU unasked.  Every check is exact.
"""

import os
import sys
import time

import pytest

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.node_check import bm_chip_matmul, mock_error
from dlrover_tpu_torch.agent.training import (
    ElasticTrainingAgent,
    MasterRendezvousHandler,
    WorkerSpec,
)
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.master.master import JobMaster


@pytest.fixture()
def master():
    m = JobMaster(port=0, node_num=1, job_name="agent-test")
    m.prepare()
    yield m
    m.stop()


@pytest.fixture()
def client(master):
    c = MasterClient(f"127.0.0.1:{master.port}", node_id=0,
                     node_type="worker")
    yield c
    c.close()


def test_kv_store_roundtrip(client):
    client.kv_store_set("k", b"v1")
    assert client.kv_store_get("k") == b"v1"
    assert client.kv_store_add("ctr", 2) == 2
    assert client.kv_store_add("ctr", 3) == 5


def test_rendezvous_handler_single_node(client):
    handler = MasterRendezvousHandler(
        RendezvousName.ELASTIC_TRAINING, node_rank=0, local_world_size=2,
        client=client, timeout=30,
    )
    out = handler.next_rendezvous()
    assert out.world == {0: 2}
    assert out.world_size == 2
    assert out.base_rank(0) == 0
    assert out.coordinator


def test_heartbeat_and_metrics(client):
    assert client.report_heartbeat() == ""
    client.report_global_step(10)
    client.report_resource_stats(12.0, 1024.0)
    client.report_model_info(125_000_000, "bfloat16")


def test_sharding_client_consumes_dataset(client):
    from dlrover_tpu_torch.agent.sharding_client import ShardingClient

    sc = ShardingClient(
        dataset_name="ds1", batch_size=4, num_epochs=1, dataset_size=32,
        master_client=client, num_minibatches_per_shard=2,
    )
    seen = 0
    while True:
        task = sc.fetch_task()
        if task is None:
            break
        seen += task.shard_size
        sc.report_task_done(task.task_id)
    assert seen == 32


def test_index_sharding_client_stream(client):
    from dlrover_tpu_torch.agent.sharding_client import IndexShardingClient

    isc = IndexShardingClient(
        dataset_name="ds2", batch_size=4, num_epochs=1, dataset_size=16,
        master_client=client,
    )
    indices = []
    while True:
        idx = isc.fetch_sample_index(timeout=30)
        if idx is None:
            break
        indices.append(idx)
        if len(indices) % 4 == 0:
            isc.report_batch_done()
    assert sorted(indices) == list(range(16))
    isc.stop()


def test_dataset_checkpoint_roundtrip(client):
    from dlrover_tpu_torch.agent.sharding_client import ShardingClient

    sc = ShardingClient(
        dataset_name="ds3", batch_size=2, num_epochs=1, dataset_size=8,
        master_client=client,
    )
    sc.fetch_task()
    content = sc.get_checkpoint()
    assert content
    sc.restore_checkpoint(content)


def test_mock_error_fault_injection(monkeypatch):
    monkeypatch.setenv(NodeEnv.MOCK_ERR_RANK, "0")
    monkeypatch.setenv(NodeEnv.NODE_RANK, "0")
    with pytest.raises(RuntimeError):
        mock_error()
    monkeypatch.setenv(NodeEnv.NODE_RANK, "1")
    mock_error()  # other ranks pass


def test_chip_matmul_benchmark_comes_with_slice_8(monkeypatch):
    """The chip probe (a deferral until slice 8.1): the bf16 GEMM chain
    runs on the device it is given and takes real time; with no GPU
    and no device named it raises instead of probing the CPU."""
    import torch

    elapsed = bm_chip_matmul(size=64, rounds=2, device="cpu")
    assert elapsed > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bm_chip_matmul(size=64, rounds=2)


def _worker_script(tmp_path, body: str) -> str:
    path = os.path.join(tmp_path, "worker.py")
    with open(path, "w") as f:
        f.write(body)
    return path


def test_agent_runs_worker_to_success(master, client, tmp_path):
    script = _worker_script(
        str(tmp_path),
        "import os\n"
        "assert os.environ['DLROVER_COORDINATOR_ADDR']\n"
        "assert os.environ['DLROVER_RANK'] == '0'\n"
        "assert os.environ['DLROVER_WORLD_SIZE'] == '1'\n"
        # the worker can import the port wherever its script lives
        "import dlrover_tpu_torch\n",
    )
    spec = WorkerSpec(
        entrypoint=[sys.executable, script],
        nproc_per_node=1, max_restarts=1, monitor_interval=0.2,
    )
    agent = ElasticTrainingAgent(
        spec, client=client, node_rank=0, start_monitors=False
    )
    assert agent.run() == 0


def test_agent_restarts_then_fails(master, client, tmp_path):
    script = _worker_script(str(tmp_path), "import sys; sys.exit(3)\n")
    spec = WorkerSpec(
        entrypoint=[sys.executable, script],
        nproc_per_node=1, max_restarts=1, monitor_interval=0.2,
    )
    hook_calls = []
    agent = ElasticTrainingAgent(
        spec, client=client, node_rank=0, start_monitors=False,
        save_ckpt_hook=lambda: hook_calls.append(1),
    )
    assert agent.run() == 1
    # breakpoint-save hook fired on restart and on final failure
    assert len(hook_calls) >= 1


def test_agent_worker_succeeds_after_one_restart(master, client, tmp_path):
    flag = os.path.join(str(tmp_path), "flag")
    script = _worker_script(
        str(tmp_path),
        "import os, sys\n"
        f"flag = {flag!r}\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(5)\n",
    )
    spec = WorkerSpec(
        entrypoint=[sys.executable, script],
        nproc_per_node=1, max_restarts=2, monitor_interval=0.2,
    )
    agent = ElasticTrainingAgent(
        spec, client=client, node_rank=0, start_monitors=False
    )
    assert agent.run() == 0


def test_reference_starter_argv_drives_the_launcher():
    """The reference's platform starter builds an argv from the NodeEnv
    contract; the port's launcher parses it to the same job."""
    from dlrover_tpu.trainer.starter import build_run_argv
    from dlrover_tpu_torch.run import parse_args, parse_nnodes

    env = {
        NodeEnv.NODE_NUM: "4",
        NodeEnv.LOCAL_WORLD_SIZE: "4",
        NodeEnv.NODE_RANK: "2",
        "DLROVER_MIN_NODES": "2",
        "DLROVER_MAX_NODES": "4",
        "DLROVER_NETWORK_CHECK": "1",
    }
    argv = build_run_argv(["train.py", "--lr", "0.1"], env=env)
    args = parse_args(argv)
    assert parse_nnodes(args.nnodes) == (2, 4)
    assert args.nproc_per_node == 4
    assert args.node_rank == 2
    assert args.network_check
    assert args.training_script == "train.py"
    assert args.training_script_args == ["--lr", "0.1"]


STARTER_ENVS = [
    {NodeEnv.NODE_NUM: "4", NodeEnv.LOCAL_WORLD_SIZE: "4",
     NodeEnv.NODE_RANK: "2", "DLROVER_MIN_NODES": "2",
     "DLROVER_MAX_NODES": "4", "DLROVER_NETWORK_CHECK": "1"},
    {},
    {NodeEnv.NODE_NUM: "2", "DLROVER_NETWORK_CHECK": "true"},
]


@pytest.mark.parametrize("env", STARTER_ENVS, ids=["elastic", "empty",
                                                   "fixed"])
def test_starter_builds_the_launchers_argv(env):
    """Twin of ``test_starter_builds_tpurun_argv``: the port's starter
    turns the NodeEnv contract into the reference starter's argv, token
    for token, which the port's launcher parses."""
    from dlrover_tpu.trainer.starter import build_run_argv as jax_argv
    from dlrover_tpu_torch.run import parse_args
    from dlrover_tpu_torch.trainer.starter import build_run_argv

    script = ["train.py", "--lr", "0.1"]
    argv = build_run_argv(script, env=env)
    assert argv == jax_argv(script, env=env)
    args = parse_args(argv)
    assert args.training_script == "train.py"
    assert args.nproc_per_node == int(env.get(NodeEnv.LOCAL_WORLD_SIZE, 1))


def test_starter_main_hands_the_argv_to_the_launcher(monkeypatch):
    """``python -m dlrover_tpu_torch.trainer.starter -- train.py ...``
    runs the launcher's ``main`` on the built argv (the leading ``--``
    dropped) and returns its exit code; no script is an error."""
    from dlrover_tpu_torch import run
    from dlrover_tpu_torch.trainer import starter

    seen = []
    monkeypatch.setattr(run, "main", lambda argv: seen.append(argv) or 7)
    for key in (NodeEnv.NODE_NUM, NodeEnv.LOCAL_WORLD_SIZE,
                NodeEnv.NODE_RANK, "DLROVER_MIN_NODES",
                "DLROVER_MAX_NODES", "DLROVER_NETWORK_CHECK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv(NodeEnv.LOCAL_WORLD_SIZE, "2")
    assert starter.main(["--", "train.py", "--", "x"]) == 7
    assert seen == [["--nnodes", "1:1", "--nproc_per_node", "2",
                     "train.py", "--", "x"]]
    with pytest.raises(SystemExit):
        starter.main([])


def test_launcher_auto_config():
    from dlrover_tpu_torch.run import apply_auto_config, parse_args

    args = parse_args(["--auto-config", "t.py"])
    assert apply_auto_config(args).nproc_per_node == 1
    args = parse_args(["--nproc_per_node", "0", "t.py"])
    assert apply_auto_config(args).nproc_per_node == 1
    args = parse_args(["--nproc_per_node", "2", "t.py"])
    assert apply_auto_config(args).nproc_per_node == 2
    # negative values are treated as auto, never zero workers
    args = parse_args(["--nproc_per_node", "-1", "t.py"])
    assert apply_auto_config(args).nproc_per_node == 1


# -- preemption monitor -------------------------------------------------


class _FakeMetadata:
    """Local stand-in for the cloud metadata server: serves FALSE until
    flipped, then TRUE (instance/preempted semantics)."""

    def __init__(self):
        import http.server
        import threading

        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = b"TRUE" if fake.preempted else b"FALSE"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence
                pass

        self.preempted = False
        self._srv = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), Handler
        )
        self.url = f"http://127.0.0.1:{self._srv.server_port}/preempted"
        threading.Thread(
            target=self._srv.serve_forever, daemon=True
        ).start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def test_preemption_monitor_fires_once_on_notice():
    from dlrover_tpu_torch.agent.preemption import PreemptionMonitor

    meta = _FakeMetadata()
    fired = []
    mon = PreemptionMonitor(
        lambda: fired.append(time.time()), metadata_url=meta.url,
        poll_interval=0.05,
    )
    try:
        mon.start()
        time.sleep(0.3)
        assert not fired  # FALSE -> no callback
        meta.preempted = True
        deadline = time.time() + 5
        while not fired and time.time() < deadline:
            time.sleep(0.05)
        assert len(fired) == 1
        time.sleep(0.2)
        assert len(fired) == 1  # fires once, thread exits
    finally:
        mon.stop()
        meta.close()


def test_agent_preemption_notice_saves_ckpt_and_reports(
    master, client, monkeypatch
):
    """Advance preemption notice -> breakpoint-checkpoint hook runs
    and the master sees the node transition with exit_reason
    'preempted' (instead of waiting for a heartbeat timeout)."""
    from dlrover_tpu_torch.agent.preemption import (
        ENV_METADATA_URL,
        PreemptionMonitor,
    )

    meta = _FakeMetadata()
    monkeypatch.setenv(ENV_METADATA_URL, meta.url)
    saved = []
    spec = WorkerSpec(
        entrypoint=[sys.executable, "-c", "import time; time.sleep(30)"],
        nproc_per_node=1, max_restarts=0, monitor_interval=0.2,
    )
    agent = ElasticTrainingAgent(
        spec, client=client, node_rank=0, start_monitors=True,
        save_ckpt_hook=lambda: saved.append(True),
    )
    mon = agent._monitors[-1]
    assert isinstance(mon, PreemptionMonitor)
    mon._poll_interval = 0.05
    try:
        for m in agent._monitors:
            m.start()
        meta.preempted = True
        deadline = time.time() + 5
        while not saved and time.time() < deadline:
            time.sleep(0.05)
        assert saved, "breakpoint checkpoint hook did not run"
        # master saw the advance notice
        deadline = time.time() + 3
        node = None
        while time.time() < deadline:
            n = master.job_manager.get_node(0)
            if n is not None and n.exit_reason == "preempted":
                node = n
                break
            time.sleep(0.05)
        assert node is not None, "master did not record preemption"
    finally:
        for m in agent._monitors:
            m.stop()
        agent.stop()
        meta.close()
