"""Twin of ``tests/test_master.py`` against the port's master: rendezvous
managers, dynamic sharding, monitors, and the full servicer driven
through a real client (the reference's local-master fixture pattern,
test_utils.py:291 start_local_master).

The error lines name the card's faults where the reference's name the
TPU's; the agent-side half of the topology case (``RendezvousOutcome``)
comes with slice 3b.2's agent."""

import time

import pytest

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import MessageClient
from dlrover_tpu_torch.common.constants import RendezvousName, TaskType
from dlrover_tpu_torch.master.dataset_splitter import (
    TableDatasetSplitter,
    TextDatasetSplitter,
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager


@pytest.fixture()
def local_master():
    master = JobMaster(port=0, node_num=2, job_name="test-job")
    master.prepare()
    yield master
    master.stop()


def _client(master, node_id=0):
    return MessageClient(
        f"127.0.0.1:{master.port}", node_id=node_id, node_type="worker"
    )


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------


def test_elastic_rdzv_completes_when_all_join():
    m = ElasticTrainingRendezvousManager()
    m.update_rdzv_params(min_nodes=2, max_nodes=2)
    m.set_coordinator_port(9999)
    m.join_rendezvous(0, 0, 4, "10.0.0.1")
    r, g, world, coord = m.get_comm_world(0)
    assert world == {}  # incomplete with one node
    m.join_rendezvous(1, 1, 4, "10.0.0.2")
    r, g, world, coord = m.get_comm_world(0)
    assert world == {0: 4, 1: 4}
    assert coord == "10.0.0.1:9999"
    assert m.num_nodes_waiting() == 0
    # second node sees the same completed round
    _, _, world1, _ = m.get_comm_world(1)
    assert world1 == world


def test_elastic_rdzv_node_unit_rounding():
    m = ElasticTrainingRendezvousManager()
    m.update_rdzv_params(
        min_nodes=2, max_nodes=8, waiting_timeout=0.0, node_unit=2
    )
    for i in range(5):
        m.join_rendezvous(i, i, 1)
    time.sleep(0.01)  # timeout=0 -> completes with what it has
    _, _, world, _ = m.get_comm_world(0)
    # 5 waiting rounds down to 4 (unit 2)
    assert sorted(world) == [0, 1, 2, 3]
    assert m.num_nodes_waiting() == 1  # node 4 waits for next round


def test_elastic_rdzv_membership_change_signal():
    m = ElasticTrainingRendezvousManager()
    m.update_rdzv_params(min_nodes=2, max_nodes=2)
    m.join_rendezvous(0, 0, 1)
    m.join_rendezvous(1, 1, 1)
    m.get_comm_world(0)
    assert m.num_nodes_waiting() == 0
    # a replacement node joining signals agents to re-rendezvous
    m.join_rendezvous(2, 2, 1)
    assert m.num_nodes_waiting() == 1


def test_network_check_pairs_and_fault_isolation():
    m = NetworkCheckRendezvousManager()
    m.update_rdzv_params(min_nodes=4, max_nodes=4)
    for i in range(4):
        m.join_rendezvous(i, i, 1, f"10.0.0.{i}")
    # round 0: neighbour pairs
    _, g0, w0, _ = m.get_comm_world(0)
    _, g1, w1, _ = m.get_comm_world(1)
    _, g2, w2, _ = m.get_comm_world(2)
    assert g0 == g1 and sorted(w0) == [0, 1]
    assert sorted(w2) == [2, 3]
    # node 2 fails round 0 (its pair partner 3 also reports abnormal)
    m.report_network_status(0, True, 10.0)
    m.report_network_status(1, True, 10.0)
    m.report_network_status(2, False, 100.0)
    m.report_network_status(3, False, 90.0)
    fault, reason = m.check_fault_node()
    assert fault == [2, 3] and reason == "need-second-round"
    # round 1: re-pair fastest with slowest -> suspect nodes split up
    for i in range(4):
        m.join_rendezvous(i, i, 1, f"10.0.0.{i}")
    _, _, w0b, _ = m.get_comm_world(0)
    assert sorted(w0b) == [0, 2]  # fastest(0) paired with slowest(2)
    # only node 2 fails again -> confirmed fault
    m.report_network_status(0, True, 10.0)
    m.report_network_status(1, True, 10.0)
    m.report_network_status(2, False, 100.0)
    m.report_network_status(3, True, 12.0)
    fault, reason = m.check_fault_node()
    assert fault == [2] and reason == "confirmed"


def test_straggler_detection_two_x_median():
    m = NetworkCheckRendezvousManager()
    m.update_rdzv_params(min_nodes=4, max_nodes=4)
    for i in range(4):
        m.join_rendezvous(i, i, 1)
    m.get_comm_world(0)
    # the reference chaos experiment numbers: {20.3,20.3,206.9,151.8}
    for node, t in enumerate([20.3, 20.3, 206.9, 151.8]):
        m.report_network_status(node, True, t)
    stragglers, med = m.detect_stragglers()
    # median 86.05 -> threshold 172.1: only the 206.9 s node qualifies
    assert stragglers == [2]
    assert med == pytest.approx(86.05)


# ---------------------------------------------------------------------------
# dynamic sharding
# ---------------------------------------------------------------------------


def test_table_splitter():
    s = TableDatasetSplitter("d", dataset_size=10, shard_size=3)
    s.create_shards()
    shards = s.get_shards()
    assert [(sh.start, sh.end) for sh in shards] == [
        (0, 3), (3, 6), (6, 9), (9, 10),
    ]
    assert s.epoch_finished()


def test_text_splitter_shuffle_deterministic():
    a = TextDatasetSplitter("d", 10, 4, shuffle=True, seed=7)
    b = TextDatasetSplitter("d", 10, 4, shuffle=True, seed=7)
    a.create_shards()
    b.create_shards()
    assert a.get_shards()[0].indices == b.get_shards()[0].indices
    all_indices = [i for sh in a.get_shards() for i in sh.indices]
    assert sorted(all_indices) == list(range(10))


def test_task_manager_dispatch_ack_recycle():
    tm = TaskManager()
    tm.new_dataset(
        msg.DatasetShardParams(
            batch_size=2,
            num_epochs=1,
            dataset_size=8,
            dataset_name="train",
            task_type=TaskType.TRAINING,
            num_minibatches_per_shard=1,
        )
    )
    t0 = tm.get_dataset_task(0, "train")
    t1 = tm.get_dataset_task(1, "train")
    assert t0.shard_size == 2 and t1.start == t0.end
    assert tm.report_dataset_task("train", t0.task_id, True)
    # worker 1 dies: its shard is recycled and re-dispatched
    tm.recycle_worker_tasks(1)
    t1b = tm.get_dataset_task(0, "train")
    assert (t1b.start, t1b.end) == (t1.start, t1.end)
    # drain
    served = [t1b]
    while True:
        t = tm.get_dataset_task(0, "train")
        if t.task_id < 0:
            break
        served.append(t)
    for t in served:
        tm.report_dataset_task("train", t.task_id, True)
    assert tm.finished()


def test_task_manager_checkpoint_restore():
    tm = TaskManager()
    params = msg.DatasetShardParams(
        batch_size=2,
        num_epochs=1,
        dataset_size=8,
        dataset_name="train",
        num_minibatches_per_shard=1,
    )
    tm.new_dataset(params)
    t0 = tm.get_dataset_task(0, "train")
    tm.report_dataset_task("train", t0.task_id, True)
    t1 = tm.get_dataset_task(0, "train")  # in flight, not acked
    ckpt = tm.get_dataset_checkpoint("train")
    # new master restores: un-acked shard is served again
    tm2 = TaskManager()
    tm2.new_dataset(params)
    assert tm2.restore_dataset_from_checkpoint("train", ckpt)
    starts = set()
    while True:
        t = tm2.get_dataset_task(0, "train")
        if t.task_id < 0:
            break
        starts.add(t.start)
        tm2.report_dataset_task("train", t.task_id, True)
    assert t1.start in starts and t0.start not in starts


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------


def test_speed_monitor():
    sm = SpeedMonitor()
    sm.set_batch_size(32)
    base = time.time()
    for i in range(10):
        sm.collect_global_step(i * 10, base + i)
    assert sm.completed_global_step == 90
    assert sm.running_speed() == pytest.approx(10.0)
    assert sm.samples_per_second() == pytest.approx(320.0)


def test_error_monitor_classification():
    em = ErrorMonitor()
    assert em.classify("NVRM: Xid (PCI:0000:1b:00): 79, GPU has fallen "
                       "off the bus")[0] == "hardware"
    assert em.classify("RESOURCE_EXHAUSTED: HBM OOM")[0] == "oom"
    assert em.classify("failed to connect to coordinator")[0] == "rdzv"
    cat, action = em.classify("ModuleNotFoundError: no module foo")
    assert cat == "user-fatal" and action == "abort"


# ---------------------------------------------------------------------------
# full servicer through a real client
# ---------------------------------------------------------------------------


def test_servicer_end_to_end(local_master):
    c0 = _client(local_master, 0)
    c1 = _client(local_master, 1)
    # nodes come up
    for i, c in enumerate((c0, c1)):
        c.report(
            msg.NodeEventReport(node_id=i, node_type="worker", status="running")
        )
    # rendezvous over the wire
    for i, c in enumerate((c0, c1)):
        r = c.get(
            msg.JoinRendezvousRequest(
                node_id=i,
                node_rank=i,
                local_world_size=4,
                rdzv_name=RendezvousName.ELASTIC_TRAINING,
                node_ip="127.0.0.1",
            )
        )
        assert isinstance(r, msg.JoinRendezvousResponse)
    w = c0.get(
        msg.CommWorldRequest(
            node_rank=0, rdzv_name=RendezvousName.ELASTIC_TRAINING
        )
    )
    assert w.world == {0: 4, 1: 4}
    assert w.coordinator.startswith("127.0.0.1:")
    # kv store
    c0.report(msg.KeyValuePair(key="init", value=b"done"))
    assert c1.get(msg.KeyValueGetRequest(key="init")).value == b"done"
    assert c1.get(msg.KeyValueAddRequest(key="barrier", amount=1)).value == 1
    assert c0.get(msg.KeyValueAddRequest(key="barrier", amount=1)).value == 2
    # sharding over the wire
    c0.report(
        msg.DatasetShardParams(
            batch_size=2,
            num_epochs=1,
            dataset_size=4,
            dataset_name="d",
            num_minibatches_per_shard=1,
        )
    )
    t = c1.get(msg.GetShardTaskRequest(worker_id=1, dataset_name="d"))
    assert t.shard_size == 2
    c1.report(
        msg.ReportTaskResultRequest(
            task_id=t.task_id, dataset_name="d", success=True
        )
    )
    # steps + heartbeat
    c0.report(
        msg.GlobalStepRecord(node_id=0, global_step=5, timestamp=time.time())
    )
    assert local_master.speed_monitor.completed_global_step == 5
    # failure: relaunch verdict + shard recycling
    resp = c1.get(
        msg.NodeFailure(
            node_id=1, error_data="CUDA error: an illegal memory access", level="node_error"
        )
    )
    assert resp.success  # hardware -> relaunch
    c0.close()
    c1.close()


def test_create_master_kubernetes_composition():
    """platform=kubernetes composes DistributedJobManager + scale-plan
    watcher + auto-scaler (reference: dist_master.py:86)."""
    from dlrover_tpu_torch.master.auto_scaler import AllreduceAutoScaler
    from dlrover_tpu_torch.master.main import create_master, parse_args
    from dlrover_tpu_torch.master.node_manager import DistributedJobManager
    from dlrover_tpu_torch.master.watcher import ScalePlanWatcher
    from dlrover_tpu_torch.scheduler.kubernetes import K8sClient, MockK8sApi

    K8sClient.reset()
    K8sClient.singleton(namespace="test", api=MockK8sApi())
    try:
        args = parse_args([
            "--platform", "kubernetes", "--job_name", "kj",
            "--node_num", "2", "--port", "0",
        ])
        master = create_master(args)
        assert isinstance(master.job_manager, DistributedJobManager)
        kinds = [type(s) for s in master.aux_services]
        assert ScalePlanWatcher in kinds
        assert AllreduceAutoScaler in kinds
        master.stop()
    finally:
        K8sClient.reset()


def test_streaming_dataset_manager_dispatch_and_resume():
    """Streaming shards keep flowing while earlier ones are in flight;
    the checkpoint carries partition offsets so a restore resumes the
    stream with un-acked shards re-queued (reference:
    streaming_dataset_manager.py:204)."""
    from dlrover_tpu_torch.common.messages import DatasetShardParams
    from dlrover_tpu_torch.master.task_manager import (
        StreamingDatasetManager,
        TaskManager,
    )

    tm = TaskManager()
    tm.new_dataset(DatasetShardParams(
        dataset_name="stream-ds", storage_type="stream",
        batch_size=4, dataset_size=-1, num_epochs=1,
        num_minibatches_per_shard=1,
    ))
    ds = tm._datasets["stream-ds"]
    assert isinstance(ds, StreamingDatasetManager)

    t1 = tm.get_dataset_task(0, "stream-ds")
    # next fetch must produce a NEW shard even though t1 is in flight
    t2 = tm.get_dataset_task(1, "stream-ds")
    assert (t1.start, t1.end) == (0, 4)
    assert (t2.start, t2.end) == (4, 8)
    tm.report_dataset_task("stream-ds", t1.task_id, True)

    state = tm.get_dataset_checkpoint("stream-ds")
    # restore into a fresh manager: t2 was never acked -> re-queued
    tm2 = TaskManager()
    tm2.new_dataset(DatasetShardParams(
        dataset_name="stream-ds", storage_type="stream",
        batch_size=4, dataset_size=-1, num_epochs=1,
        num_minibatches_per_shard=1,
    ))
    tm2.restore_dataset_from_checkpoint("stream-ds", state)
    redo = tm2.get_dataset_task(2, "stream-ds")
    assert (redo.start, redo.end) == (4, 8)
    # and the stream continues PAST the checkpointed offsets
    nxt = tm2.get_dataset_task(2, "stream-ds")
    assert nxt.start >= 8
    assert not tm2._datasets["stream-ds"].completed()


def test_topology_sorted_rendezvous_world():
    """Nodes from the same slice become rank-adjacent and the
    coordinator is the topological first node (reference:
    DpTopologySorter, net_topology.py:62)."""
    from dlrover_tpu_torch.master.net_topology import LabelTopologyQuerier

    m = ElasticTrainingRendezvousManager()
    m.update_rdzv_params(min_nodes=4, max_nodes=4)
    q = LabelTopologyQuerier({
        0: "slice1:0", 1: "slice0:1", 2: "slice1:1", 3: "slice0:0",
    })
    m.set_topology_querier(q)
    for rank in range(4):
        m.join_rendezvous(rank, rank, 4, f"10.0.0.{rank}")
    _, _, world, coordinator = m.get_comm_world(0)
    # slice0 hosts (3,1) first in host order, then slice1 (0,2)
    assert list(world.keys()) == [3, 1, 0, 2]
    assert coordinator.startswith("10.0.0.3:")


def test_master_loop_diagnoses_hang_with_culprit(local_master):
    """The run loop drains agent diagnosis reports through the
    inference chain: a stalled step timeline + a blocked-collective
    stack from one node makes the master request a CULPRIT-ONLY
    restart over the culprit's heartbeat ack — the job keeps running
    instead of aborting (deep-diagnosis upgrade of the old
    hang-means-abort policy; the abort path now requires an
    exhausted restart budget, unit-covered in
    test_deep_diagnosis.py)."""
    import threading as _threading

    from dlrover_tpu_torch.common.global_context import Context
    from dlrover_tpu_torch.common.messages import (
        DiagnosisData,
        HeartbeatRequest,
        JobExitRequest,
    )

    master = local_master
    # a worker reported steps long ago, then stalled
    master.speed_monitor.add_running_worker(0)
    master.speed_monitor.collect_global_step(5, time.time() - 4000)
    # agent-side evidence arrives through the REAL report path
    client = _client(master, node_id=1)
    client.report(DiagnosisData(
        node_id=1, data_type="stack",
        content="state=D wchan=futex barrier allreduce",
    ))
    ctx = Context.instance()
    old_poll, old_hang = ctx.seconds_to_check_hang, ctx.hang_timeout
    ctx.seconds_to_check_hang = 0.2
    ctx.hang_timeout = 60.0
    rc_box = {}

    def _run():
        rc_box["rc"] = master.run()

    thread = _threading.Thread(target=_run, daemon=True)
    try:
        thread.start()
        # the culprit's next heartbeat carries the restart action
        deadline = time.time() + 10
        action = ""
        while time.time() < deadline and not action:
            action = client.get(
                HeartbeatRequest(node_id=1)
            ).action
            time.sleep(0.05)
        assert action == "restart_workers"
        # targeted restart, not an abort: the loop is still running
        assert thread.is_alive()
        assert master.job_manager.job_exit_reason == ""
        assert master._hang_restarts.get(1) == 1
    finally:
        ctx.seconds_to_check_hang = old_poll
        ctx.hang_timeout = old_hang
        client.report(JobExitRequest(reason="test-done"))
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert rc_box.get("rc") == 0
