"""Twin of ``tests/test_node_manager.py``, against the port (:mod:`dlrover_tpu_torch`).

Node management tests against the mock k8s API (the reference's
mocked-k8s test pattern): scaler pod creation, watcher classification,
status FSM, relaunch policy, OOM memory bump, auto-scaler.

The operator's scale-plan cases are in ``tests/test_torch_operator.py``.
"""

import time

import pytest

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.node import NodeEvent
from dlrover_tpu_torch.master.auto_scaler import AllreduceAutoScaler
from dlrover_tpu_torch.master.node_manager import DistributedJobManager
from dlrover_tpu_torch.master.resource_optimizer import LocalOptimizer
from dlrover_tpu_torch.master.scaler import ElasticJobScaler, PodScaler, ScalePlan
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.status_flow import can_transition
from dlrover_tpu_torch.master.watcher import (
    PodWatcher,
    classify_exit_reason,
    pod_to_node,
)
from dlrover_tpu_torch.scheduler.job_args import new_job_args
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient, MockK8sApi


@pytest.fixture()
def k8s():
    api = MockK8sApi()
    return K8sClient(namespace="test", api=api), api


def _wait_until(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _manager(client, num_workers=2):
    args = new_job_args(
        platform="kubernetes", job_name="tj", num_workers=num_workers
    )
    scaler = PodScaler("tj", client, master_addr="1.2.3.4:5")
    mgr = DistributedJobManager(args, scaler)
    watcher = PodWatcher("tj", client, mgr.process_event)
    mgr._watcher = watcher
    return mgr


def test_status_flow_blocks_backwards():
    assert can_transition(NodeStatus.PENDING, NodeStatus.RUNNING)
    assert not can_transition(NodeStatus.RUNNING, NodeStatus.PENDING)
    assert not can_transition(NodeStatus.SUCCEEDED, NodeStatus.RUNNING)


def test_exit_reason_classification():
    assert classify_exit_reason(
        {"status": {"reason": "OOMKilled"}}
    ) == NodeExitReason.OOM
    assert classify_exit_reason(
        {"status": {"reason": "Evicted"}}
    ) == NodeExitReason.PREEMPTED
    assert classify_exit_reason(
        {"status": {"container_exit_code": 1}}
    ) == NodeExitReason.FATAL_ERROR
    assert classify_exit_reason(
        {"status": {"container_exit_code": 137}}
    ) == NodeExitReason.KILLED


def test_initial_scale_creates_pods(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: api.create_calls == 2)
        assert "tj-worker-0" in api.pods and "tj-worker-1" in api.pods
        # env contract present in the pod spec
        env = api.pods["tj-worker-0"]["spec"]["containers"][0]["env"]
        assert any(e["name"] == "DLROVER_MASTER_ADDR" for e in env)
    finally:
        mgr.stop()


def test_pod_failure_triggers_relaunch(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        api.set_pod_phase(
            "tj-worker-0", "Failed", reason="Evicted"
        )
        # relaunch: a new pod (id 2) replaces worker 0 at rank 0
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
        replacement = mgr.get_node(2)
        assert replacement.rank_index == 0
        assert replacement.relaunch_count == 1
    finally:
        mgr.stop()


def test_fatal_error_not_relaunched(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-1", "Running")
        api.set_pod_phase("tj-worker-1", "Failed", exit_code=1)
        time.sleep(0.5)
        assert "tj-worker-2" not in api.pods  # no replacement
    finally:
        mgr.stop()


def test_oom_relaunch_bumps_memory(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        original_mem = mgr.get_node(0).config_resource.memory_mb
        api.set_pod_phase("tj-worker-0", "Running")
        api.set_pod_phase("tj-worker-0", "Failed", reason="OOMKilled")
        assert _wait_until(lambda: mgr.get_node(2) is not None)
        assert mgr.get_node(2).config_resource.memory_mb > original_mem
    finally:
        mgr.stop()


def test_adjust_worker_count_scales_up_and_down(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        for name in list(api.pods):
            api.set_pod_phase(name, "Running")
        _wait_until(lambda: all(
            n.status == NodeStatus.RUNNING
            for n in mgr.all_nodes().values()
        ))
        plan = mgr.adjust_worker_count(4)
        assert len(plan.launch_nodes) == 2
        assert _wait_until(lambda: len(api.pods) == 4)
        for name in list(api.pods):
            api.set_pod_phase(name, "Running")
        time.sleep(0.3)
        plan = mgr.adjust_worker_count(2)
        assert len(plan.remove_nodes) == 2
    finally:
        mgr.stop()


def test_elasticjob_scaler_writes_scaleplan_cr(k8s):
    client, api = k8s
    scaler = ElasticJobScaler("tj", client)
    from dlrover_tpu_torch.common.node import new_worker

    plan = ScalePlan(launch_nodes=[new_worker(5, rank=5)])
    scaler.scale(plan)
    assert any(
        key.startswith("scaleplans/tj-scaleplan")
        for key in api.custom_resources
    )
    body = list(api.custom_resources.values())[0]
    assert body["spec"]["createPods"][0]["id"] == 5


def test_auto_scaler_probes_up(k8s):
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        for name in list(api.pods):
            api.set_pod_phase(name, "Running")
        _wait_until(lambda: sum(
            1 for n in mgr.all_nodes().values()
            if n.status == NodeStatus.RUNNING
        ) == 2)
        sm = SpeedMonitor()
        sm.set_batch_size(32)
        now = time.time()
        for i in range(10):
            sm.collect_global_step(i * 10, now + i)
        scaler = AllreduceAutoScaler(
            mgr, sm, optimizer=LocalOptimizer(), interval=3600,
            min_nodes=1, max_nodes=8, node_unit=1,
        )
        scaler.execute_scale_once()
        # throughput present with empty history -> probe scale-up
        assert _wait_until(lambda: len(api.pods) == 3)
    finally:
        mgr.stop()


def test_scaleplan_watcher_resizes_world(k8s):
    """An externally written ScalePlan CR (user/Brain) is picked up by
    the master's ScalePlanWatcher and executed through the job manager
    at node_unit granularity (reference: k8s_watcher.py:267)."""
    from dlrover_tpu_torch.master.watcher import ScalePlanWatcher

    client, api = k8s
    mgr = _manager(client, num_workers=2)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        for name in list(api.pods):
            api.set_pod_phase(name, "Running")
        _wait_until(lambda: sum(
            1 for n in mgr.all_nodes().values()
            if n.status == NodeStatus.RUNNING
        ) == 2)
        client.apply_scale_plan_cr("manual-1", {
            "metadata": {"name": "manual-1"},
            "spec": {
                "ownerJob": "tj",
                "replicaResourceSpecs": {
                    "worker": {"replicas": 5}
                },
            },
        })
        watcher = ScalePlanWatcher("tj", client, mgr, node_unit=2)
        assert watcher.reconcile_once() == 1
        # 5 rounded down to node_unit 2 -> 4 workers
        assert _wait_until(lambda: len(api.pods) == 4)
        cr = api.custom_resources["scaleplans/manual-1"]
        assert cr["status"]["phase"] == "Executed"
        assert cr["status"]["workerTarget"] == 4
        # executed plans are not re-run
        assert watcher.reconcile_once() == 0

        # a plan removing one pod by name
        client.apply_scale_plan_cr("manual-2", {
            "metadata": {"name": "manual-2"},
            "spec": {
                "ownerJob": "tj",
                "removePods": [{"name": "tj-worker-0"}],
            },
        })
        assert watcher.reconcile_once() == 1
        node0 = mgr.get_node(0)
        assert node0.is_released and not node0.relaunchable
    finally:
        mgr.stop()


def test_evaluator_node_group(k8s):
    """Evaluator flavour: side nodes are created and relaunched but
    never swept into worker auto-scaling (reference:
    EvaluatorManager, node/worker.py:66)."""
    client, api = k8s
    args = new_job_args(
        platform="kubernetes", job_name="tj", num_workers=2,
        num_evaluators=1,
    )
    scaler = PodScaler("tj", client, master_addr="1.2.3.4:5")
    mgr = DistributedJobManager(args, scaler)
    mgr._watcher = PodWatcher("tj", client, mgr.process_event)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 3)
        assert "tj-evaluator-2" in api.pods
        for name in list(api.pods):
            api.set_pod_phase(name, "Running")
        _wait_until(lambda: all(
            n.status == NodeStatus.RUNNING
            for n in mgr.all_nodes().values()
        ))
        plan = mgr.adjust_worker_count(4)
        assert len(plan.launch_nodes) == 2
        assert all(
            n.type == NodeType.WORKER for n in plan.launch_nodes
        )
        evaluators = [
            n for n in mgr.all_nodes().values()
            if n.type == NodeType.EVALUATOR
        ]
        assert len(evaluators) == 1
        assert not evaluators[0].is_released
    finally:
        mgr.stop()


def test_agent_reported_preemption_relaunches_immediately(k8s):
    """An agent-reported end state (advance GCE preemption notice via
    NodeEventReport -> update_node_status) triggers the same relaunch
    path as a watcher-observed pod death — and stays idempotent when
    the watcher later sees the pod actually die."""
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        assert _wait_until(
            lambda: mgr.get_node(0) is not None
            and mgr.get_node(0).status == NodeStatus.RUNNING
        )
        # agent reports the advance notice (servicer path)
        mgr.update_node_status(
            0, NodeType.WORKER, NodeStatus.FAILED,
            exit_reason=NodeExitReason.PREEMPTED,
        )
        # replacement launched without any watcher event
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
        assert mgr.get_node(2).rank_index == 0
        # the watcher later observes the actual pod death: no second
        # relaunch (node 0 already released)
        api.set_pod_phase("tj-worker-0", "Failed", reason="Preempted")
        time.sleep(0.5)
        assert "tj-worker-3" not in api.pods
    finally:
        mgr.stop()


def test_concurrent_death_reports_launch_one_replacement(k8s):
    """Agent report and watcher event can deliver the same death on
    two threads; the relaunch claim is atomic so exactly one
    replacement launches."""
    import threading

    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        assert _wait_until(
            lambda: mgr.get_node(0) is not None
            and mgr.get_node(0).status == NodeStatus.RUNNING
        )
        node = mgr.get_node(0)
        node.update_status(NodeStatus.FAILED)
        node.exit_reason = NodeExitReason.PREEMPTED
        barrier = threading.Barrier(2)

        def deliver():
            barrier.wait()
            mgr._handle_node_exit(node)

        threads = [
            threading.Thread(target=deliver) for _ in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
        time.sleep(0.3)
        assert "tj-worker-3" not in api.pods, sorted(api.pods)
    finally:
        mgr.stop()


def test_heartbeat_timeout_relaunches(k8s):
    """A hang-detected node ('no-heartbeat' from the job manager's
    heartbeat monitor) is replaced like a killed one."""
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        assert _wait_until(
            lambda: mgr.get_node(0) is not None
            and mgr.get_node(0).status == NodeStatus.RUNNING
        )
        mgr.update_node_status(
            0, NodeType.WORKER, NodeStatus.FAILED,
            exit_reason="no-heartbeat",
        )
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
    finally:
        mgr.stop()


def test_duplicate_death_report_never_aborts_job(k8s):
    """A retried agent report (same terminal status delivered twice)
    must not abort a job whose replacement already launched: with the
    relaunch budget exactly consumed, the duplicate used to fall into
    the job-exit branch (ADVICE r2 medium)."""
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        assert _wait_until(
            lambda: mgr.get_node(0) is not None
            and mgr.get_node(0).status == NodeStatus.RUNNING
        )
        node = mgr.get_node(0)
        # budget of 1: the first death consumes it exactly
        node.max_relaunch_count = 1
        mgr.update_node_status(
            0, NodeType.WORKER, NodeStatus.FAILED,
            exit_reason=NodeExitReason.PREEMPTED,
        )
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
        assert not mgr.job_exit_reason
        # the @retry_request'd report delivers the same death again:
        # no transition -> no re-handling -> no job abort
        mgr.update_node_status(
            0, NodeType.WORKER, NodeStatus.FAILED,
            exit_reason=NodeExitReason.PREEMPTED,
        )
        assert not mgr.job_exit_reason
        # the watcher's later FAILED->DELETED transition is also benign
        mgr.update_node_status(
            0, NodeType.WORKER, NodeStatus.DELETED,
            exit_reason=NodeExitReason.PREEMPTED,
        )
        assert not mgr.job_exit_reason
    finally:
        mgr.stop()


def test_two_watch_streams_same_selector_both_see_events(k8s):
    """Real Kubernetes delivers each event to EVERY open watch; two
    mock consumers on the SAME selector (each on its own thread, like
    PodWatcher / the reconciler pump) must both see every event
    instead of splitting one shared queue (ADVICE r2) — and a
    consumer's RE-subscribe must resume after its last-seen event, not
    replay the whole history every idle cycle."""
    import threading

    _, api = k8s
    api.create_pod("test", {"metadata": {"name": "p1", "labels": {}}})

    def consume(out):
        # first subscribe: history replay + live events until idle
        for event in api.watch_pods("test", "app=x"):
            out.append(event)
        # re-subscribe on the same thread (the consumers' retry loop)
        for event in api.watch_pods("test", "app=x"):
            out.append(("replayed", event))

    seen1, seen2 = [], []
    t1 = threading.Thread(target=consume, args=(seen1,))
    t2 = threading.Thread(target=consume, args=(seen2,))
    t1.start()
    t2.start()
    time.sleep(0.3)
    api.set_pod_phase("p1", "Running")
    t1.join(timeout=10)
    t2.join(timeout=10)
    for seen in (seen1, seen2):
        kinds = [e[0] for e in seen]
        assert kinds.count("added") == 1, kinds      # history replay
        assert kinds.count("modified") == 1, kinds   # live fan-out
        # the re-subscribe delivered NOTHING: cursor resumed past
        # the already-seen history
        assert "replayed" not in kinds, kinds
    # departed streams are unregistered: no unbounded accumulation
    assert api._streams == []


def test_advance_notice_launches_replacement_without_killing_pod(k8s):
    """handle_preemption_notice (servicer route for event_type
    preemption_notice) must start replacement placement while the
    node is STILL ALIVE: the live pod is not deleted (the cloud takes
    it — removing it here would cut off the grace window the
    breakpoint save needs), the node stays RUNNING, and the real
    death later is already-handled (no second relaunch)."""
    client, api = k8s
    mgr = _manager(client)
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-0", "Running")
        assert _wait_until(
            lambda: mgr.get_node(0) is not None
            and mgr.get_node(0).status == NodeStatus.RUNNING
        )
        mgr.handle_preemption_notice(0, NodeType.WORKER)
        # replacement launched...
        assert _wait_until(lambda: "tj-worker-2" in api.pods)
        assert mgr.get_node(2).rank_index == 0
        # ...but the live pod survives and the node is still running
        assert "tj-worker-0" in api.pods
        assert mgr.get_node(0).status == NodeStatus.RUNNING
        assert mgr.get_node(0).is_released  # claim recorded
        # the actual preemption lands later: no second relaunch, no
        # job abort
        api.set_pod_phase("tj-worker-0", "Failed", reason="Preempted")
        time.sleep(0.5)
        assert "tj-worker-3" not in api.pods
        assert mgr.job_exit_reason == ""
    finally:
        mgr.stop()


def test_terminal_decision_survives_master_restart(k8s, tmp_path):
    """Across the restart boundary: the first master declines a FATAL_ERROR
    relaunch and journals that terminal decision; a respawned master
    restores it, and a LATE preemption_notice or node-exit report
    referencing the pre-restart incarnation must neither overwrite
    the journaled exit reason nor resurrect the node as relaunchable
    PREEMPTED."""
    from dlrover_tpu_torch.master.journal import StateJournal, replay_dir
    from dlrover_tpu_torch.master.recovery import restore_master

    client, api = k8s
    mgr = _manager(client)
    mgr.journal = StateJournal(str(tmp_path / "j"))
    mgr.start()
    try:
        assert _wait_until(lambda: len(api.pods) == 2)
        api.set_pod_phase("tj-worker-1", "Running")
        # fatal code error: relaunch declined, decision journaled
        api.set_pod_phase("tj-worker-1", "Failed", exit_code=1)
        assert _wait_until(
            lambda: mgr.get_node(1) is not None
            and mgr.get_node(1).status == NodeStatus.FAILED
        )
        time.sleep(0.3)
        assert "tj-worker-2" not in api.pods
        assert 1 in mgr._terminal_decisions
    finally:
        mgr.stop()
        mgr.journal.close()

    # ---- master restart: a fresh manager restores the journal
    mgr2 = _manager(client)
    replayed = replay_dir(str(tmp_path / "j"))

    class _Shim:
        """restore_master targets a JobMaster; give it just the
        sub-managers this test restores."""
        task_manager = type(
            "T", (), {
                "restore_state": staticmethod(lambda s: None),
                "apply_journal_entry":
                    staticmethod(lambda k, d: False),
                "requeue_unacked": staticmethod(lambda: 0),
            },
        )()
        rdzv_managers = {}
        job_manager = mgr2
        kv_store = type(
            "K", (), {"load": staticmethod(lambda d: None)}
        )()
        resize_coordinator = type(
            "R", (), {
                "reconcile_after_replay": staticmethod(lambda: None),
            },
        )()
        recoveries = 0

    restore_master(_Shim, replayed)
    node = mgr2.get_node(1)
    assert node is not None
    assert 1 in mgr2._terminal_decisions
    exit_reason_before = node.exit_reason

    # late ADVANCE notice from the dead incarnation: must NOT turn
    # the declined FATAL_ERROR into a relaunchable PREEMPTED
    mgr2.handle_preemption_notice(1, NodeType.WORKER)
    assert node.exit_reason == exit_reason_before
    assert not [p for p in api.pods if p == "tj-worker-2"]

    # late exit report from the dead incarnation: terminal decision
    # stands, no transition fires
    assert mgr2.update_node_status(
        1, NodeType.WORKER, NodeStatus.DELETED,
        exit_reason=NodeExitReason.PREEMPTED,
    ) is False
    assert node.exit_reason == exit_reason_before
