"""Pod event watching -> NodeEvents.

Copy of ``dlrover_tpu/master/watcher.py`` (the port imports nothing of
the JAX package).

Reference: ``PodWatcher`` (``dlrover/python/master/watcher/
k8s_watcher.py:194``) with exit-reason classification
(``k8s_watcher.py:52``): list+watch pods of the job, map phases to
node statuses, classify failures (OOMKilled/evicted/preempted) so the
relaunch policy can distinguish hardware faults from code errors.
"""

import threading
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node, NodeEvent
from dlrover_tpu_torch.scheduler.kubernetes import (
    K8sClient,
    pod_status_to_node_status,
)


def classify_exit_reason(pod: dict) -> str:
    """Reference: exit-reason classification, k8s_watcher.py:52."""
    status = pod.get("status", {})
    reason = str(status.get("reason", ""))
    exit_code = int(status.get("container_exit_code", 0) or 0)
    if reason in ("OOMKilled",):
        return NodeExitReason.OOM
    if reason in ("Evicted", "Preempted", "Deleted"):
        return NodeExitReason.PREEMPTED
    if exit_code in (137, 143):
        return NodeExitReason.KILLED
    if exit_code == 201 or reason == "HardwareError":
        return NodeExitReason.HARDWARE_ERROR
    if exit_code != 0:
        return NodeExitReason.FATAL_ERROR
    return NodeExitReason.SUCCEEDED


def pod_to_node(pod: dict) -> Optional[Node]:
    labels = pod.get("metadata", {}).get("labels", {})
    if "node-id" not in labels:
        return None
    node = Node(
        type=labels.get("node-type", "worker"),
        id=int(labels["node-id"]),
        rank_index=int(labels.get("rank", labels["node-id"])),
        name=pod.get("metadata", {}).get("name", ""),
        status=pod_status_to_node_status(
            pod.get("status", {}).get("phase", "Unknown")
        ),
        host_ip=pod.get("status", {}).get("host_ip", ""),
    )
    if node.status == NodeStatus.FAILED:
        node.exit_reason = classify_exit_reason(pod)
    return node


class PodWatcher:
    """Feeds NodeEvents to a callback from k8s watch events."""

    def __init__(
        self,
        job_name: str,
        client: K8sClient,
        event_handler: Callable[[NodeEvent], None],
    ):
        self._job_name = job_name
        self._client = client
        self._handler = event_handler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def label_selector(self) -> str:
        return f"app=dlrover-tpu,job={self._job_name}"

    def list_nodes(self) -> List[Node]:
        nodes = []
        for pod in self._client.list_pods(self.label_selector):
            node = pod_to_node(pod)
            if node is not None:
                nodes.append(node)
        return nodes

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, daemon=True, name="pod-watcher"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _watch(self):
        while not self._stop.is_set():
            try:
                for etype, pod in self._client.watch_pods(
                    self.label_selector
                ):
                    if self._stop.is_set():
                        return
                    node = pod_to_node(pod)
                    if node is None:
                        continue
                    self._handler(
                        NodeEvent(event_type=etype, node=node)
                    )
            except Exception as e:  # noqa: BLE001
                logger.warning("pod watch error: %s; rewatching", e)
            if not self._stop.wait(1.0):
                continue


# phases that mean "this plan was already consumed by some component"
# — shared with the operator-side ScalePlanReconciler so a plan never
# ping-pongs between the two consumers
SCALE_PLAN_TERMINAL_PHASES = ("Executed", "Succeeded", "Failed")


class ScalePlanWatcher:
    """Watches ScalePlan CRs of this job and executes them through the
    job manager — the entry point for user/Brain-initiated scaling
    (reference: ``K8sScalePlanWatcher``,
    ``master/watcher/k8s_watcher.py:267``).  Plans the master itself
    wrote for the operator (label ``origin: master``) are skipped.

    A plan is executed once: after execution its ``status.phase`` is
    patched to ``Executed`` (with the observed worker target), so
    restarts and repeated polls are idempotent.
    """

    POLL_INTERVAL = 2.0

    def __init__(
        self,
        job_name: str,
        client: K8sClient,
        job_manager,
        node_unit: int = 1,
    ):
        self._job_name = job_name
        self._client = client
        self._job_manager = job_manager
        self._node_unit = max(1, node_unit)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="scaleplan-watcher"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.POLL_INTERVAL):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001
                logger.exception("scale-plan reconcile failed")

    def reconcile_once(self) -> int:
        """Execute every pending ScalePlan of this job; returns how
        many plans were executed."""
        executed = 0
        for cr in self._client.list_scale_plan_crs():
            spec = cr.get("spec", {})
            if spec.get("ownerJob", "") != self._job_name:
                continue
            labels = cr.get("metadata", {}).get("labels", {})
            if labels.get("origin") == "master":
                continue  # written by us for the operator
            status = cr.get("status", {})
            if status.get("phase") in SCALE_PLAN_TERMINAL_PHASES:
                continue
            name = cr.get("metadata", {}).get("name", "unnamed")
            try:
                target = self.execute_plan(spec)
                cr.setdefault("status", {})["phase"] = "Executed"
                cr["status"]["workerTarget"] = target
            except Exception as e:  # noqa: BLE001
                logger.exception("executing scale plan %s failed", name)
                cr.setdefault("status", {})["phase"] = "Failed"
                cr["status"]["message"] = str(e)
            self._client.patch_scale_plan_status(name, cr)
            executed += 1
        return executed

    def execute_plan(self, spec: dict) -> int:
        """spec -> job-manager actions: explicit removePods first, then
        the worker replica target (node_unit aligned)."""
        for item in spec.get("removePods", []):
            pod_name = item.get("name", "")
            node = self._find_node_by_pod_name(pod_name)
            if node is not None:
                self._job_manager.remove_node(node.id)
        target = -1
        worker = spec.get("replicaResourceSpecs", {}).get("worker")
        if worker and "replicas" in worker:
            target = (
                max(1, int(worker["replicas"]) // self._node_unit)
                * self._node_unit
            )
            self._job_manager.adjust_worker_count(target)
        return target

    def _find_node_by_pod_name(self, pod_name: str):
        for node in self._job_manager.all_nodes().values():
            if pod_name.endswith(f"-{node.type}-{node.id}"):
                return node
        return None
