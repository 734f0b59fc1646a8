"""Node-event callback objects.

Copy of ``dlrover_tpu/master/event_callback.py`` (the port imports
nothing of the JAX package).

Reference: ``master/node/event_callback.py`` (339 LoC) —
``TaskRescheduleCallback`` recycles a dead worker's data shards,
``AllReduceNodeHandlingCallback`` updates rendezvous membership so the
next elastic round re-forms the world, and error events surface as
k8s events.  The job manager fires every registered callback on node
status transitions (``job_manager._fire``).
"""

from typing import Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeEvent


class NodeEventCallback:
    """Base: dispatches end-state transitions to typed hooks."""

    def __call__(self, event: NodeEvent):
        node = event.node
        if node.status == NodeStatus.SUCCEEDED:
            self.on_node_succeeded(event)
        elif node.status == NodeStatus.FAILED:
            self.on_node_failed(event)
        elif node.status == NodeStatus.DELETED:
            self.on_node_deleted(event)
        elif node.status == NodeStatus.RUNNING:
            self.on_node_started(event)

    def on_node_started(self, event: NodeEvent):
        pass

    def on_node_succeeded(self, event: NodeEvent):
        pass

    def on_node_failed(self, event: NodeEvent):
        pass

    def on_node_deleted(self, event: NodeEvent):
        pass


class TaskRescheduleCallback(NodeEventCallback):
    """A dead worker's in-flight data shards go back to the todo
    queue (reference: TaskRescheduleCallback — shard-task recycling
    keeps dynamic sharding lossless under churn)."""

    def __init__(self, task_manager):
        self._task_manager = task_manager

    def on_node_failed(self, event: NodeEvent):
        self._recycle(event)

    def on_node_deleted(self, event: NodeEvent):
        self._recycle(event)

    def on_node_succeeded(self, event: NodeEvent):
        # a worker can exit cleanly with shards still un-acked (last
        # get_task before its final report); those must be redone
        self._recycle(event)

    def _recycle(self, event: NodeEvent):
        node = event.node
        self._task_manager.recycle_worker_tasks(node.id)
        logger.info(
            "recycled data shards of exited worker %s", node.id
        )


class AllReduceNodeHandlingCallback(NodeEventCallback):
    """Membership bookkeeping for SPMD training (reference:
    AllReduceNodeHandlingCallback): started nodes join the alive set /
    speed accounting; dead nodes leave the rendezvous so agents see
    the membership change and re-form the world."""

    def __init__(self, rdzv_manager, speed_monitor=None,
                 k8s_client=None, job_name: str = ""):
        self._rdzv = rdzv_manager
        self._speed = speed_monitor
        self._client = k8s_client
        self._job_name = job_name

    def __call__(self, event: NodeEvent):
        # only WORKERS participate in the training rendezvous/speed
        # accounting; evaluator/side nodes would stall rendezvous
        # completion (alive-count includes them otherwise)
        from dlrover_tpu_torch.common.constants import NodeType

        if event.node.type != NodeType.WORKER:
            return
        super().__call__(event)

    def on_node_started(self, event: NodeEvent):
        self._rdzv.add_alive_node(event.node.id)
        if self._speed is not None:
            self._speed.add_running_worker(event.node.id)

    def on_node_succeeded(self, event: NodeEvent):
        self._leave(event)

    def on_node_failed(self, event: NodeEvent):
        self._leave(event)
        if self._client is not None:
            from dlrover_tpu_torch.master.stats import emit_k8s_event

            emit_k8s_event(
                self._client, self._job_name, "NodeFailed",
                f"node {event.node.id} failed: "
                f"{event.node.exit_reason}",
            )

    def on_node_deleted(self, event: NodeEvent):
        self._leave(event)

    def _leave(self, event: NodeEvent):
        self._rdzv.remove_alive_node(event.node.id)
        if self._speed is not None:
            self._speed.remove_running_worker(event.node.id)
