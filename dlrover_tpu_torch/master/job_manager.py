"""Job managers: node lifecycle bookkeeping on the master.

Copy of ``dlrover_tpu/master/job_manager.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/node/local_job_manager.py`` (and the
registry half of ``dist_job_manager.py``): track every node's status,
heartbeats and restart accounting, fire event callbacks (shard
recycling, rendezvous membership) on failures, and decide
relaunch-vs-abort with the error monitor.  The scheduler-backed
distributed flavour (pod creation/watching) lives in
:mod:`dlrover_tpu_torch.master.node_manager`.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node, NodeEvent, new_worker
from dlrover_tpu_torch.master.error_monitor import ErrorMonitor


class JobManager:
    """Local/base job manager (reference ``LocalJobManager:175``)."""

    def __init__(self, error_monitor: Optional[ErrorMonitor] = None):
        self._lock = threading.Lock()
        self._nodes: Dict[int, Node] = {}
        self._error_monitor = error_monitor or ErrorMonitor()
        self._stop = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None
        # callbacks fired with NodeEvent on status transitions
        self._event_callbacks: List[Callable[[NodeEvent], None]] = []
        self._job_exit_reason = ""
        # master crash recovery: node transitions and terminal exit
        # decisions are journaled when a StateJournal is attached;
        # _terminal_decisions carries decisions across a master
        # restart so a LATE report referencing the pre-restart
        # incarnation cannot overwrite/resurrect them
        self.journal = None
        self._terminal_decisions: Dict[int, str] = {}

    def _jot(self, kind: str, data: Dict):
        if self.journal is not None:
            self.journal.append(kind, data)

    @property
    def job_exit_reason(self) -> str:
        return self._job_exit_reason

    @job_exit_reason.setter
    def job_exit_reason(self, reason: str):
        """The job-level terminal decision is durable the moment it is
        made: a respawned master honors it instead of resurrecting an
        aborted job."""
        if reason and reason != self._job_exit_reason:
            self._jot("job_exit", {"reason": reason})
        self._job_exit_reason = reason

    # -- registry ----------------------------------------------------------

    def add_node(self, node_type: str, node_id: int, rank: int = -1) -> Node:
        with self._lock:
            if node_id not in self._nodes:
                node = new_worker(node_id, rank)
                node.type = node_type
                self._nodes[node_id] = node
            return self._nodes[node_id]

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def all_nodes(self) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes)

    def add_event_callback(self, cb: Callable[[NodeEvent], None]):
        self._event_callbacks.append(cb)

    # -- status flow -------------------------------------------------------

    def update_node_status(
        self,
        node_id: int,
        node_type: str,
        status: str,
        exit_reason: str = "",
    ):
        node = self.add_node(node_type, node_id)
        old = node.status
        if old == status:
            # no transition: callers (e.g. the distributed manager's
            # relaunch path) must not re-handle an already-seen death
            # delivered again by a @retry_request'd agent report
            return False
        if (
            node_id in self._terminal_decisions
            and old in NodeStatus.end_states()
        ):
            # the journaled terminal decision for this node already
            # stands (possibly made by the PRE-RESTART master): a
            # late exit report from the old incarnation must not
            # rewrite the status/exit_reason it was decided on
            logger.info(
                "ignoring late status %r for node %s: terminal "
                "decision %r is journaled",
                status, node_id, self._terminal_decisions[node_id],
            )
            return False
        node.update_status(status)
        if exit_reason:
            node.exit_reason = exit_reason
        self._jot(
            "node",
            {
                "id": node_id,
                "type": node_type,
                "status": status,
                "exit_reason": node.exit_reason,
            },
        )
        event_type = (
            NodeEventType.DELETED
            if status in NodeStatus.end_states()
            else NodeEventType.MODIFIED
        )
        logger.info(
            "node %s (%s): %s -> %s (%s)",
            node_id,
            node_type,
            old,
            status,
            exit_reason,
        )
        self._fire(NodeEvent(event_type, node))
        return True

    def handle_node_rejoin(self, node_id: int, node_type: str = ""):
        """A node the master wrote off (heartbeat silence, reported
        death) joined the rendezvous again: a replacement agent under
        the same identity.  Transition it back to RUNNING so liveness,
        rendezvous membership and speed accounting re-admit it —
        elastic grow-back rides this.  A journaled terminal decision
        stands: a declined node does not resurrect by rejoining."""
        node = self.get_node(node_id)
        if node is None:
            return False
        if node_id in self._terminal_decisions:
            logger.info(
                "node %s rejoined but its terminal decision %r "
                "stands; not re-admitting", node_id,
                self._terminal_decisions[node_id],
            )
            return False
        if node.status not in (NodeStatus.FAILED, NodeStatus.DELETED):
            return False
        logger.warning(
            "node %s rejoined after %s; re-admitting as RUNNING",
            node_id, node.status,
        )
        node.heartbeat_time = time.time()
        return self.update_node_status(
            node_id, node_type or node.type, NodeStatus.RUNNING,
        )

    def handle_preemption_notice(self, node_id: int, node_type: str):
        """ADVANCE preemption notice: the node is still alive and
        stepping, so it must NOT transition to an end state here (the
        real exit arrives later via the watcher or a failure report —
        treating the notice as a death made the master abort a job
        whose only worker was still training through the grace
        period).  The base manager just records the pending reason;
        the distributed manager additionally starts replacement
        placement immediately."""
        node = self.add_node(node_type, node_id)
        if (
            node.status in NodeStatus.end_states()
            or node_id in self._terminal_decisions
        ):
            # a late notice referencing a pre-restart incarnation (or
            # one that lost the race against the real exit): the
            # journaled terminal decision stands — overwriting
            # exit_reason here would turn a FATAL_ERROR decline into
            # a relaunchable PREEMPTED across the restart boundary
            logger.info(
                "ignoring late preemption notice for node %s: "
                "terminal decision already recorded", node_id,
            )
            return
        node.exit_reason = NodeExitReason.PREEMPTED
        logger.info(
            "advance preemption notice for node %s (%s); node stays "
            "%s until it actually exits", node_id, node_type,
            node.status,
        )

    def _fire(self, event: NodeEvent):
        for cb in self._event_callbacks:
            try:
                cb(event)
            except Exception:
                logger.exception("node event callback failed")

    # -- heartbeats --------------------------------------------------------

    def collect_heartbeat(self, node_id: int, timestamp: float = 0.0):
        node = self.add_node(NodeType.WORKER, node_id)
        node.heartbeat_time = timestamp or time.time()
        if node.status in (NodeStatus.INITIAL, NodeStatus.PENDING):
            self.update_node_status(node_id, node.type, NodeStatus.RUNNING)

    def start_heartbeat_monitor(self):
        if getattr(self, "_heartbeat_thread", None) is not None:
            return  # idempotent: distributed start() + prepare() both call
        self._heartbeat_thread = threading.Thread(
            target=self._monitor_heartbeats,
            name="heartbeat-monitor",
            daemon=True,
        )
        self._heartbeat_thread.start()

    def _monitor_heartbeats(self):
        """Dead-node events after a silence window (reference
        ``_monitor_node_heart_beat:355``, 300 s).  The poll cadence
        tracks the window: a seconds-scale window (elastic-resize
        chaos runs) must not sit behind a fixed 15 s poll."""
        window = Context.instance().hang_detection_seconds
        poll = max(0.5, min(15.0, window / 3.0))
        while not self._stop.wait(poll):
            now = time.time()
            for node in self.all_nodes().values():
                if (
                    node.status == NodeStatus.RUNNING
                    and node.heartbeat_time
                    and now - node.heartbeat_time > window
                ):
                    logger.warning(
                        "node %s heartbeat silent for %.0fs; marking failed",
                        node.id,
                        now - node.heartbeat_time,
                    )
                    self.update_node_status(
                        node.id, node.type, NodeStatus.FAILED, "no-heartbeat"
                    )

    # -- failures ----------------------------------------------------------

    def handle_failure(
        self,
        node_id: int,
        restart_count: int,
        error_data: str,
        level: str,
    ) -> bool:
        """Returns whether the node may relaunch."""
        node = self.add_node(NodeType.WORKER, node_id)
        relaunch = self._error_monitor.process_error(
            node_id, restart_count, error_data, level
        )
        node.inc_relaunch_count()
        if node.exceeded_max_relaunch():
            logger.error(
                "node %s exceeded max relaunch (%d)",
                node_id,
                node.max_relaunch_count,
            )
            return False
        return relaunch

    # -- master crash recovery (state journal) -----------------------------

    def record_exit_decision(self, node_id: int, decision: str,
                             reason: str = ""):
        """Durably record a per-node terminal decision (relaunch
        declined, budget exhausted, job abort) so it survives a
        master restart and late reports cannot overwrite it."""
        self._terminal_decisions[node_id] = decision
        self._jot(
            "decision",
            {"node_id": node_id, "decision": decision,
             "reason": reason},
        )

    def snapshot_state(self) -> Dict:
        with self._lock:
            nodes = [
                {
                    "id": n.id,
                    "type": n.type,
                    "rank": n.rank_index,
                    "status": n.status,
                    "exit_reason": n.exit_reason,
                    "relaunch_count": n.relaunch_count,
                    "max_relaunch_count": n.max_relaunch_count,
                    "relaunchable": n.relaunchable,
                    "is_released": n.is_released,
                    "critical": n.critical,
                }
                for n in self._nodes.values()
            ]
        return {
            "nodes": nodes,
            "decisions": dict(self._terminal_decisions),
            "job_exit_reason": self._job_exit_reason,
        }

    def restore_state(self, state: Dict):
        for rec in state.get("nodes", []):
            node = self.add_node(
                rec.get("type", NodeType.WORKER),
                int(rec["id"]),
                int(rec.get("rank", -1)),
            )
            node.status = rec.get("status", node.status)
            node.exit_reason = rec.get("exit_reason", "")
            node.relaunch_count = int(rec.get("relaunch_count", 0))
            node.max_relaunch_count = int(
                rec.get("max_relaunch_count", node.max_relaunch_count)
            )
            node.relaunchable = bool(rec.get("relaunchable", True))
            node.is_released = bool(rec.get("is_released", False))
            node.critical = bool(rec.get("critical", False))
            # fresh heartbeat grace: the outage must not read as node
            # silence — live agents re-confirm on their next beat
            if node.status == NodeStatus.RUNNING:
                node.heartbeat_time = time.time()
        self._terminal_decisions.update(
            {int(k): v for k, v in
             (state.get("decisions") or {}).items()}
        )
        reason = state.get("job_exit_reason", "")
        if reason:
            self._job_exit_reason = reason

    def apply_journal_entry(self, kind: str, data: Dict) -> bool:
        """Replay one incremental record.  Transitions are applied
        directly (no event callbacks: shard recycling and rendezvous
        membership are rebuilt from their own journaled records, and
        re-firing callbacks here would double-apply them)."""
        if kind == "node":
            node = self.add_node(
                data.get("type", NodeType.WORKER), int(data["id"])
            )
            node.status = data.get("status", node.status)
            if data.get("exit_reason"):
                node.exit_reason = data["exit_reason"]
            if node.status == NodeStatus.RUNNING:
                node.heartbeat_time = time.time()
            return True
        if kind == "decision":
            self._terminal_decisions[int(data["node_id"])] = data.get(
                "decision", ""
            )
            node = self.get_node(int(data["node_id"]))
            if node is not None:
                node.is_released = True
            return True
        if kind == "job_exit":
            self._job_exit_reason = data.get("reason", "")
            return True
        return False

    # -- lifecycle ---------------------------------------------------------

    def all_workers_exited(self) -> bool:
        nodes = [
            n
            for n in self.all_nodes().values()
            if n.type == NodeType.WORKER
        ]
        return bool(nodes) and all(
            n.status in NodeStatus.end_states() for n in nodes
        )

    def all_workers_succeeded(self) -> bool:
        nodes = [
            n
            for n in self.all_nodes().values()
            if n.type == NodeType.WORKER
        ]
        return bool(nodes) and all(
            n.status == NodeStatus.SUCCEEDED for n in nodes
        )

    def stop(self):
        self._stop.set()
