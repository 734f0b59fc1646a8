"""The port's job master against the JAX package's, message for message.

Both packages' ``JobMaster`` start in this process, each behind its own
``MessageServer`` on a free port, and each package's own
``MessageClient`` sends them the same sequence of requests: node
events, rendezvous and world, dataset shards and task results, global
steps and heartbeats, a node failure, the KV store.  The replies are
compared as ``dataclasses.asdict`` field dicts, exactly: the sequence
gives every timestamp itself, and the only field masked is the
master's per-process ``incarnation`` id.  The speed monitors' step and
speed are compared too.

A journal that either master writes replays in the other: the records
are CRC-framed JSON (``master/journal.py:20-22``) and the recovered
round, world, KV entries and shard leases must be the same.

The error monitors classify a table of log lines: the generic lines
alike, the TPU's hardware lines as hardware in the reference only,
and the card's (Xid, ECC, NVLink, illegal address, NCCL, CUDA OOM) as
hardware or OOM in the port.
"""

import dataclasses

import pytest

from dlrover_tpu.common import comm as jcomm
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master import error_monitor as jerr
from dlrover_tpu.master import master as jmaster
from dlrover_tpu_torch.common import comm as pcomm
from dlrover_tpu_torch.common import messages as pmsg
from dlrover_tpu_torch.master import error_monitor as perr
from dlrover_tpu_torch.master import master as pmaster

PACKAGES = {
    "jax": (jmaster.JobMaster, jmsg, jcomm.MessageClient),
    "torch": (pmaster.JobMaster, pmsg, pcomm.MessageClient),
}
COORDINATOR_PORT = 29555
MASKED = {"incarnation"}
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _no_journal_env(monkeypatch):
    for name in ("DLROVER_MASTER_JOURNAL_DIR", "DLROVER_METRICS_PORT",
                 "DLROVER_BRAIN_DB", "DLROVER_MIN_NODES"):
        monkeypatch.delenv(name, raising=False)


def _fields(reply):
    if dataclasses.is_dataclass(reply):
        d = dataclasses.asdict(reply)
        return {k: ("<masked>" if k in MASKED else v) for k, v in d.items()}
    return reply


def script(m):
    """The request sequence, built from a package's message module ``m``:
    ``[(verb, node_id, message)]``."""
    ds = m.DatasetShardParams(
        batch_size=4, num_epochs=1, dataset_size=40, shuffle=False,
        num_minibatches_per_shard=2, dataset_name="train",
        task_type="training", storage_type="table",
    )
    steps = [("report", 0, m.GlobalStepRecord(
        node_id=0, global_step=s, timestamp=T0 + 0.25 * s))
        for s in range(1, 7)]
    return [
        *[("report", i, m.NodeEventReport(
            node_id=i, node_type="worker", status="running"))
          for i in (0, 1)],
        ("report", 0, ds),
        # join, rendezvous and world
        *[("get", i, m.JoinRendezvousRequest(
            node_id=i, node_rank=i, local_world_size=8,
            rdzv_name="elastic-training", node_ip=f"10.0.0.{i + 1}"))
          for i in (0, 1)],
        *[("get", i, m.CommWorldRequest(
            node_id=i, node_rank=i, rdzv_name="elastic-training"))
          for i in (0, 1)],
        ("get", 0, m.NumNodesWaitingRequest(rdzv_name="elastic-training")),
        # global step, speed and heartbeats
        *steps,
        *[("get", i, m.HeartbeatRequest(node_id=i, timestamp=T0 + 2.0))
          for i in (0, 1)],
        ("get", 1, m.HeartbeatRequest(
            node_id=1, timestamp=T0 + 2.1, global_step=7,
            step_timestamp=T0 + 1.75)),
        # dataset shards and tasks
        *[("get", w, m.GetShardTaskRequest(worker_id=w,
                                           dataset_name="train"))
          for w in (0, 1, 0)],
        ("report", 0, m.ReportTaskResultRequest(
            task_id=0, dataset_name="train", worker_id=0, success=True)),
        ("report", 1, m.ReportTaskResultRequest(
            task_id=1, dataset_name="train", worker_id=1, success=False,
            error="worker lost")),
        ("get", 0, m.DatasetCheckpointRequest(dataset_name="train")),
        # the KV store
        ("report", 0, m.KeyValuePair(key="addr", value=b"10.0.0.1:29500")),
        ("get", 1, m.KeyValueGetRequest(key="addr")),
        ("get", 0, m.KeyValueAddRequest(key="barrier", amount=1)),
        ("get", 1, m.KeyValueAddRequest(key="barrier", amount=1)),
        # a failure: relaunch verdict, shards back, node out of the world
        ("get", 1, m.NodeFailure(
            node_id=1, node_rank=1, level="node_error", restart_count=0,
            error_data="RESOURCE_EXHAUSTED: out of memory allocating "
                       "1073741824 bytes")),
        ("get", 0, m.GetShardTaskRequest(worker_id=0, dataset_name="train")),
        ("get", 0, m.CommWorldRequest(
            node_id=0, node_rank=0, rdzv_name="elastic-training")),
        ("get", 0, m.NumNodesWaitingRequest(rdzv_name="elastic-training")),
        ("get", 0, m.ParallelConfigRequest(node_id=0)),
    ]


def run_script(pkg):
    """Start the package's master, send it the script through the
    package's client, and return the replies and the speed monitor's
    view."""
    master_cls, m, client_cls = PACKAGES[pkg]
    master = master_cls(port=0, node_num=2, job_name="parity",
                        coordinator_port=COORDINATOR_PORT)
    master.prepare()
    clients = {}
    try:
        replies = []
        for verb, node_id, message in script(m):
            client = clients.get(node_id)
            if client is None:
                client = clients[node_id] = client_cls(
                    f"127.0.0.1:{master.port}", node_id=node_id,
                    node_type="worker", timeout=10.0)
            reply = getattr(client, verb)(message)
            replies.append((type(message).__name__, _fields(reply)))
        sm = master.speed_monitor
        view = {
            "completed_global_step": sm.completed_global_step,
            "running_speed": sm.running_speed(),
            "running_workers": sorted(sm.running_workers)
            if hasattr(sm, "running_workers") else None,
            "rdzv_round": master.elastic_rdzv.current_round(),
            "waiting": master.elastic_rdzv.num_nodes_waiting(),
        }
        return replies, view
    finally:
        for client in clients.values():
            client.close()
        master.stop()


def test_both_masters_reply_alike_to_one_message_sequence():
    want, want_view = run_script("jax")
    got, got_view = run_script("torch")
    assert [n for n, _ in got] == [n for n, _ in want]
    for i, ((name, g), (_, w)) in enumerate(zip(got, want)):
        assert g == w, f"reply {i} to {name}: port {g} != reference {w}"
    assert got_view == want_view
    # what the sequence must have produced, on both sides
    by_name = {}
    for name, reply in want:
        by_name.setdefault(name, []).append(reply)
    world = by_name["CommWorldRequest"][0]
    assert world["world"] == {0: 8, 1: 8} and world["rdzv_round"] == 1
    assert world["coordinator"] == f"10.0.0.1:{COORDINATOR_PORT}"
    assert [t["start"] for t in by_name["GetShardTaskRequest"][:3]] == [
        0, 8, 16]
    assert by_name["NodeFailure"][0]["success"] is True
    assert want_view["completed_global_step"] == 7
    # six steps 0.25 s apart on the sender's clock, then step 7
    assert want_view["running_speed"] == pytest.approx(6 / 1.5)


def _drive_and_crash(pkg, journal_dir):
    """Build a master on ``journal_dir``, drive rendezvous, KV and shard
    state through its servicer, and 'crash' it: no stop, no snapshot."""
    master_cls, m, _ = PACKAGES[pkg]
    master = master_cls(port=0, node_num=2, job_name="jr",
                        coordinator_port=COORDINATOR_PORT,
                        journal_dir=journal_dir)
    try:
        sv = master.servicer
        sv.report(0, "worker", m.DatasetShardParams(
            batch_size=1, num_epochs=1, dataset_size=6, shuffle=False,
            num_minibatches_per_shard=1, dataset_name="ds",
            task_type="training", storage_type="table"))
        for i in (0, 1):
            sv.get(i, "worker", m.JoinRendezvousRequest(
                node_id=i, node_rank=i, local_world_size=4,
                rdzv_name="elastic-training", node_ip=f"10.0.0.{i + 1}"))
        # the round completes, and is journaled, when a member polls it
        world = sv.get(0, "worker", m.CommWorldRequest(
            node_id=0, node_rank=0, rdzv_name="elastic-training"))
        assert world.rdzv_round == 1
        t1 = sv.get(0, "worker", m.GetShardTaskRequest(worker_id=0,
                                                        dataset_name="ds"))
        t2 = sv.get(1, "worker", m.GetShardTaskRequest(worker_id=1,
                                                        dataset_name="ds"))
        sv.report(0, "worker", m.ReportTaskResultRequest(
            task_id=t1.task_id, dataset_name="ds", worker_id=0, success=True))
        sv.report(0, "worker", m.KeyValuePair(key="coord", value=b"addr"))
        sv.get(0, "worker", m.KeyValueAddRequest(key="n", amount=3))
    finally:
        # the crash: the server goes, nothing is stopped or snapshotted
        master._server.stop()
    return (t1.start, t1.end), (t2.start, t2.end)


def _recovered_state(pkg, journal_dir):
    master_cls, _, _ = PACKAGES[pkg]
    master = master_cls(port=0, node_num=2, job_name="jr",
                        coordinator_port=COORDINATOR_PORT,
                        journal_dir=journal_dir)
    try:
        rnd, _g, world, coord = master.elastic_rdzv.get_comm_world(0)
        ds = master.task_manager._datasets["ds"]
        return {
            "recoveries": master.recoveries,
            "round": rnd, "world": world, "coordinator": coord,
            "waiting": master.elastic_rdzv.num_nodes_waiting(),
            "kv": (master.kv_store.get("coord"), master.kv_store.get("n")),
            "completed": ds.completed_count,
            "todo": [(t.start, t.end) for t in ds.todo],
            "doing": len(ds.doing),
        }
    finally:
        master._server.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_a_journal_written_by_either_master_replays_in_the_other(
        tmp_path, writer, reader):
    jdir = str(tmp_path / "journal")
    acked, leased = _drive_and_crash(writer, jdir)
    other = _recovered_state(reader, jdir)
    # the writer's own package recovers the same state from a copy of
    # the same records
    same_dir = str(tmp_path / "same")
    _drive_and_crash(writer, same_dir)
    same = _recovered_state(writer, same_dir)
    assert other == same
    assert other["recoveries"] == 1
    assert other["round"] == 1 and other["world"] == {0: 4, 1: 4}
    assert other["coordinator"] == f"10.0.0.1:{COORDINATOR_PORT}"
    assert other["kv"] == (b"addr", b"3")
    # the acked shard is done; the un-acked lease is back at the head
    assert other["completed"] == 1 and other["doing"] == 0
    assert other["todo"][0] == leased and acked not in other["todo"]


# (log line, the reference's category, the port's category)
ERROR_TABLE = [
    # generic lines: both alike
    ("RESOURCE_EXHAUSTED: out of memory while trying to allocate",
     "oom", "oom"),
    ("failed to connect to coordinator at 10.0.0.1:29500", "rdzv", "rdzv"),
    ("Rendezvous timed out waiting for nodes", "rdzv", "rdzv"),
    ("barrier timeout after 300s", "rdzv", "rdzv"),
    ("ModuleNotFoundError: No module named 'foo'", "user-fatal",
     "user-fatal"),
    ("SyntaxError: invalid syntax", "user-fatal", "user-fatal"),
    ("node received a preemption notice", "hardware", "hardware"),
    ("HBM uncorrectable error on device", "hardware", "hardware"),
    ("deadline exceeded in collective all-reduce", "hardware", "hardware"),
    ("something else went wrong", "unknown", "unknown"),
    # the TPU's hardware lines: the port has no TPU
    ("TPU device halted unexpectedly", "hardware", "unknown"),
    ("ICI link error on chip 3", "hardware", "unknown"),
    ("DCN timeout talking to slice 1", "hardware", "unknown"),
    # the card's
    ("NVRM: Xid (PCI:0000:1b:00): 79, pid=1234, GPU has fallen off the bus",
     "unknown", "hardware"),
    ("uncorrectable ECC error encountered", "unknown", "hardware"),
    ("NVLink error: link 4 is down", "unknown", "hardware"),
    ("RuntimeError: CUDA error: an illegal memory access was encountered",
     "unknown", "hardware"),
    ("RuntimeError: CUDA error: unspecified launch failure", "unknown",
     "hardware"),
    ("NCCL error in: ProcessGroupNCCL.cpp:1234, unhandled system error",
     "unknown", "hardware"),
    ("Watchdog caught collective operation timeout: NCCL timed out",
     "unknown", "hardware"),
    ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 "
     "GiB", "oom", "oom"),
]


@pytest.mark.parametrize("line,ref_cat,port_cat", ERROR_TABLE)
def test_error_monitor_table(line, ref_cat, port_cat):
    ref, port = jerr.ErrorMonitor(), perr.ErrorMonitor()
    assert ref.classify(line)[0] == ref_cat
    assert port.classify(line)[0] == port_cat
    # the same action for the same category in both packages
    if ref_cat == port_cat:
        assert ref.classify(line) == port.classify(line)
