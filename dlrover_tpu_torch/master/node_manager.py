"""Distributed node manager: pod lifecycle on a cluster scheduler.

Copy of ``dlrover_tpu/master/node_manager.py`` (the port imports
nothing of the JAX package).

Reference: ``DistributedJobManager`` (``dlrover/python/master/node/
dist_job_manager.py:88,181,334,561,605``): initializes the node set
from JobArgs, scales the initial plan, processes watcher events
through the status FSM, decides relaunch-vs-abort per exit reason and
restart budget, and emits replacement nodes via the scaler.  Extends
the registry-level :class:`dlrover_tpu_torch.master.job_manager.JobManager`
(heartbeats, event callbacks, failure handling).
"""

import itertools
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node, NodeEvent, new_worker
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.status_flow import apply_transition
from dlrover_tpu_torch.master.watcher import PodWatcher
from dlrover_tpu_torch.scheduler.job_args import JobArgs


class DistributedJobManager(JobManager):
    def __init__(
        self,
        job_args: JobArgs,
        scaler: Scaler,
        watcher: Optional[PodWatcher] = None,
        error_monitor=None,
    ):
        super().__init__(error_monitor=error_monitor)
        self._job_args = job_args
        self._scaler = scaler
        self._watcher = watcher
        self._id_iter = itertools.count(job_args.worker_count())
        # serializes the relaunch decision: the agent-report path
        # (servicer request thread) and the watcher path can deliver
        # the same death concurrently
        self._relaunch_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._init_nodes()
        self._scaler.start()
        self._scaler.scale(self._initial_plan())
        if self._watcher is not None:
            self._watcher.start()
        self.start_heartbeat_monitor()

    def stop(self):
        if self._watcher is not None:
            self._watcher.stop()
        self._scaler.stop()
        super().stop()

    def _init_nodes(self):
        """Every declared node group (worker + evaluator flavours;
        reference: per-type managers in master/node/worker.py)."""
        next_id = 0
        for node_type in (NodeType.WORKER, NodeType.EVALUATOR):
            group = self._job_args.node_args.get(node_type)
            if group is None:
                continue
            for i in range(group.group_resource.count):
                node = self.add_node(node_type, next_id, rank=i)
                # per-node copy so OOM bumps never leak into the
                # shared group spec
                import dataclasses as _dc

                node.config_resource = _dc.replace(
                    group.group_resource.node_resource
                )
                node.max_relaunch_count = group.restart_count
                next_id += 1
        self._id_iter = itertools.count(next_id)

    def _initial_plan(self) -> ScalePlan:
        plan = ScalePlan()
        plan.launch_nodes = [
            n for n in self.all_nodes().values()
            if n.status == NodeStatus.INITIAL
        ]
        return plan

    # -- event processing --------------------------------------------------

    def process_event(self, event: NodeEvent):
        """Watcher callback (reference: _process_event,
        dist_job_manager.py:473)."""
        node = self.get_node(event.node.id)
        if node is None:
            node = self.add_node(event.node.type, event.node.id,
                                 event.node.rank_index)
        if event.node.host_ip:
            node.host_ip = event.node.host_ip
        new_status = event.node.status
        if event.event_type == NodeEventType.DELETED:
            new_status = NodeStatus.DELETED
        changed = apply_transition(node, new_status)
        if not changed:
            return
        node.exit_reason = event.node.exit_reason
        # watcher-observed transitions bypass update_node_status:
        # journal them here or a respawned master would rebuild a
        # node table missing every pod-watcher-driven change
        self._jot(
            "node",
            {
                "id": node.id,
                "type": node.type,
                "status": node.status,
                "exit_reason": node.exit_reason,
            },
        )
        logger.info(
            "node %s -> %s (%s)", node.id, node.status,
            node.exit_reason or "-",
        )
        for cb in self._event_callbacks:
            try:
                cb(NodeEvent(event_type=event.event_type, node=node))
            except Exception:  # noqa: BLE001
                logger.exception("node event callback failed")
        if node.status in (NodeStatus.FAILED, NodeStatus.DELETED):
            self._handle_node_exit(node)

    def update_node_status(
        self,
        node_id: int,
        node_type: str,
        status: str,
        exit_reason: str = "",
    ):
        """Agent-reported transitions (servicer NodeEventReport) get
        the same relaunch treatment as watcher-observed pod deaths —
        an advance preemption notice starts replacement placement
        immediately instead of waiting for the pod watcher to see the
        VM die.  Idempotent with the later watcher event:
        ``_relaunch_node`` marks the node released, which
        ``_should_relaunch`` rejects on the second trigger."""
        changed = super().update_node_status(
            node_id, node_type, status, exit_reason
        )
        if not changed:
            # a retried agent report (or the watcher re-delivering the
            # same terminal status) must not re-enter the exit handler:
            # a node whose relaunch budget is exactly consumed would
            # otherwise hit the job-exit branch on the duplicate even
            # though its replacement already launched
            return False
        node = self.get_node(node_id)
        if node is not None and node.status in (
            NodeStatus.FAILED, NodeStatus.DELETED
        ):
            self._handle_node_exit(node)
        return changed

    def handle_preemption_notice(self, node_id: int, node_type: str):
        """ADVANCE notice from the agent's preemption monitor: start
        replacement placement NOW (the whole point of the ~30 s
        warning) but leave the node RUNNING — it is still alive and
        stepping, and marking it an end state here made the master
        conclude ``all_workers_exited`` and abort a job whose only
        worker was happily training through the grace period.  The
        relaunch marks the node released, so the REAL exit that
        follows (watcher event or agent failure report) is treated as
        already handled — no double replacement, no job abort."""
        node = self.get_node(node_id)
        if node is None or node.is_released:
            return
        if node_id in self._terminal_decisions:
            # journaled terminal decision (possibly from the
            # pre-restart master incarnation): it stands — see the
            # base manager's guard for the rationale
            logger.info(
                "ignoring late preemption notice for node %s: "
                "terminal decision already recorded", node_id,
            )
            return
        if node.status in NodeStatus.end_states():
            # the notice lost the race against the actual exit (the
            # report side-thread retries with seconds of backoff): the
            # exit handler already decided relaunch-vs-abort, and a
            # FATAL_ERROR decline must not be overwritten into a
            # relaunchable PREEMPTED here
            return
        node.exit_reason = NodeExitReason.PREEMPTED
        # claim under the lock, scale OUTSIDE it — same pattern as
        # _handle_node_exit: a stalled cloud API call must not
        # serialize every concurrent death/notice behind this one
        with self._relaunch_lock:
            if not self._should_relaunch(node):
                return
            node.is_released = True
        logger.info(
            "preemption notice for node %s (%s): starting "
            "replacement placement while it is still alive",
            node_id, node_type,
        )
        # remove=False: the pod is alive and mid-grace-period — the
        # cloud takes it, this master must not
        self._relaunch_node(node, remove=False)

    def _handle_node_exit(self, node: Node):
        with self._relaunch_lock:
            already_handled = node.is_released
            relaunch = self._should_relaunch(node)
            if relaunch:
                # claim under the lock: a concurrent second delivery
                # of the same death (agent report + watcher event)
                # must not launch a second replacement
                node.is_released = True
        if relaunch:
            self._relaunch_node(node)
        elif not already_handled:
            # terminal: this node will not come back — journal the
            # decision so a respawned master (and any late report
            # from the pre-restart incarnation) honors it instead of
            # re-deciding
            self.record_exit_decision(
                node.id, "no_relaunch", node.exit_reason
            )
            if node.critical or self._all_relaunches_exhausted():
                # only the delivery that first handled this death may
                # abort the job: a duplicate arriving after the
                # relaunch claimed the node would see an exhausted
                # budget and abort a job whose replacement is already
                # running
                self.job_exit_reason = node.exit_reason or "node_failed"

    def _should_relaunch(self, node: Node) -> bool:
        """Reference: _should_relaunch, dist_job_manager.py:561."""
        if not node.relaunchable or node.is_released:
            return False
        if node.exit_reason == NodeExitReason.FATAL_ERROR:
            # code errors don't heal by relaunching
            return False
        if node.exceeded_max_relaunch():
            return False
        return node.exit_reason in (
            NodeExitReason.KILLED,
            NodeExitReason.OOM,
            NodeExitReason.PREEMPTED,
            NodeExitReason.HARDWARE_ERROR,
            NodeExitReason.UNKNOWN,
            # heartbeat-timeout failures (job_manager hang monitor):
            # a hung node heals by replacement like a killed one
            "no-heartbeat",
            "",
        )

    def _all_relaunches_exhausted(self) -> bool:
        return all(
            n.exceeded_max_relaunch()
            for n in self.all_nodes().values()
            if n.status in NodeStatus.end_states()
        )

    def _relaunch_node(self, node: Node, remove: bool = True):
        """Reference: _relaunch_node, dist_job_manager.py:605 — a new
        node id replaces the dead one at the same rank AND type (a
        dead evaluator comes back as an evaluator).  ``remove=False``
        launches the replacement WITHOUT putting the old node in the
        plan's remove set — the advance-preemption path, where the
        old pod is still alive and the cloud (not this master) will
        take it; deleting it here would cut off the grace window the
        breakpoint save needs."""
        import dataclasses as _dc

        node.inc_relaunch_count()
        node.is_released = True
        new_id = next(self._id_iter)
        replacement = new_worker(new_id, rank=node.rank_index)
        replacement.type = node.type
        replacement.name = f"{node.type}-{new_id}"
        # own copy: the OOM bump below must not mutate the group spec
        # shared by other nodes
        replacement.config_resource = _dc.replace(node.config_resource)
        replacement.relaunch_count = node.relaunch_count
        replacement.max_relaunch_count = node.max_relaunch_count
        with self._lock:
            self._nodes[new_id] = replacement
        if node.exit_reason == NodeExitReason.OOM:
            # bump memory on OOM (reference: job.py OOM adjustment)
            replacement.config_resource.memory_mb *= 1.5
        logger.info(
            "relaunching node %s as %s (attempt %s/%s)",
            node.id, new_id, node.relaunch_count,
            node.max_relaunch_count,
        )
        plan = ScalePlan(
            launch_nodes=[replacement],
            remove_nodes=[node] if remove else [],
        )
        self._scaler.scale(plan)

    # -- scaling (used by the auto-scaler / scale-plan watcher) ------------

    def remove_node(self, node_id: int):
        """Release one node without relaunch (scale-plan removePods;
        reference: _migrate/remove handling in dist_job_manager)."""
        node = self.get_node(node_id)
        if node is None or node.is_released:
            return None
        node.relaunchable = False
        node.is_released = True
        self._scaler.scale(ScalePlan(remove_nodes=[node]))
        logger.info("removed node %s per scale plan", node_id)
        return node

    def adjust_worker_count(self, target: int) -> ScalePlan:
        """Grow/shrink the worker group to ``target`` (reference:
        AllreduceTrainingAutoScaler execution path)."""
        plan = ScalePlan()
        alive = [
            n for n in self.all_nodes().values()
            if n.type == NodeType.WORKER and n.is_alive()
            and not n.is_released
        ]
        if target > len(alive):
            import dataclasses as _dc

            # ranks stay contiguous within the WORKER group even when
            # evaluator ids interleave the id space
            next_rank = 1 + max(
                (n.rank_index for n in self.all_nodes().values()
                 if n.type == NodeType.WORKER and not n.is_released),
                default=-1,
            )
            for _ in range(target - len(alive)):
                new_id = next(self._id_iter)
                node = new_worker(new_id, rank=next_rank)
                next_rank += 1
                worker_args = self._job_args.node_args.get(
                    NodeType.WORKER
                )
                if worker_args:
                    node.config_resource = _dc.replace(
                        worker_args.group_resource.node_resource
                    )
                with self._lock:
                    self._nodes[new_id] = node
                plan.launch_nodes.append(node)
        elif target < len(alive):
            doomed = sorted(alive, key=lambda n: -n.rank_index)[
                : len(alive) - target
            ]
            for node in doomed:
                node.relaunchable = False
                node.is_released = True
                plan.remove_nodes.append(node)
        if not plan.empty():
            self._scaler.scale(plan)
        return plan
