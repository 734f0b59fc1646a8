"""Job auto-scaler + elastic world-resize coordinator.

Copy of ``dlrover_tpu/master/auto_scaler.py`` (the port imports
nothing of the JAX package).

Reference: ``JobAutoScaler`` (``dlrover/python/master/node/
job_auto_scaler.py:40,98,254``): periodically consults the resource
optimizer and executes the resulting plan; the allreduce flavour
adjusts the worker count (node_unit aligned), the PS flavour migrates
hot parameter servers.  TPU target: resizing means changing how many
TPU-VM hosts participate in the next rendezvous round — the elastic
agent restarts training at the new world size (the hard part flagged
in SURVEY.md §7: recompilation amortized by node_unit alignment).

:class:`ResizeCoordinator` is the piece the reference drives through
``ScalePlan`` CRDs: it turns a capacity change (a node died and no
replacement is coming, a node rejoined, an operator asked) into a new
target world size, persists the decision through the master's state
journal (a master crash mid-resize replays and re-drives it), and
delivers a ``resize`` action to every surviving agent over the
heartbeat-action channel so the job reconverges at the new size
instead of waiting forever for the old one.
"""

import os
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import MasterAction, NodeStatus, NodeType
from dlrover_tpu_torch.common.env_utils import _get_float as _env_float
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.node_manager import DistributedJobManager
from dlrover_tpu_torch.master.resource_optimizer import (
    LocalOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

# how long a capacity mismatch must persist before the coordinator
# commits to a resize — a debounce, so a node flapping through a
# restart or a heartbeat blip does not thrash the world
RESIZE_GRACE_ENV = "DLROVER_RESIZE_GRACE_S"
# re-deliver the resize action to an agent that has not re-joined
# after this long (lost heartbeat ack); 0 disables re-delivery
RESIZE_REDELIVER_ENV = "DLROVER_RESIZE_REDELIVER_S"
# how often the Brain decision source (when attached) is consulted
# for a throughput-driven target; resizes are expensive, so this is
# deliberately much slower than the capacity/operator paths
BRAIN_RESIZE_INTERVAL_ENV = "DLROVER_BRAIN_RESIZE_INTERVAL_S"

_RESIZE_SECONDS = get_registry().histogram(
    "dlrover_resize_seconds",
    "Elastic world-resize phase wall time (labels: phase = decide / "
    "rendezvous / first_step; drain and reshard-restore are agent/"
    "trainer-side and appear on the assembled timeline)",
)
_RESIZES_TOTAL = get_registry().counter(
    "dlrover_resize_total", "Resize decisions by direction",
)


class ResizeCoordinator:
    """Decides and drives world-size changes for a running job.

    Polled from the master's run loop (no thread of its own: the
    decision must serialize with journal snapshots and diagnosis).
    State machine: ``idle`` → (capacity mismatch persists past the
    grace window, or an operator request arrives) → ``resizing``
    (decision journaled + event emitted + ``resize`` actions delivered
    to the surviving agents) → a rendezvous round completes at the
    target size → ``await_first_step`` → a global-step report lands →
    ``idle``.
    """

    def __init__(
        self,
        rdzv_manager,
        job_manager,
        speed_monitor,
        servicer,
        journal=None,
        min_nodes: int = 1,
        max_nodes: int = 1,
        node_unit: int = 1,
    ):
        self._rdzv = rdzv_manager
        self._job_manager = job_manager
        self._speed = speed_monitor
        self._servicer = servicer
        self.journal = journal
        self.min_nodes = max(1, min_nodes)
        self.max_nodes = max(self.min_nodes, max_nodes)
        self.node_unit = max(1, node_unit)
        self.grace_s = _env_float(RESIZE_GRACE_ENV, 30.0)
        self.redeliver_s = _env_float(RESIZE_REDELIVER_ENV, 30.0)
        self.resizes = 0
        # Brain decision source (set_brain): a third input next to
        # capacity mismatches and operator requests — the standing
        # cluster optimizer's throughput heuristic proposes targets
        self._brain = None
        self._brain_interval = _env_float(
            BRAIN_RESIZE_INTERVAL_ENV, 60.0
        )
        self._last_brain_poll = 0.0
        # debounce: (target, first-observed ts) of the current mismatch
        self._observed: Optional[tuple] = None
        # operator request (servicer thread) consumed by the next poll
        self._requested: Optional[tuple] = None
        # in-flight decision dict while state != idle
        self.pending: Optional[Dict] = None
        self._state = "idle"
        self._delivered_at: Dict[int, float] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return (
            self.max_nodes > self.min_nodes
            or self._brain is not None
            or bool(os.getenv("DLROVER_AUTO_RESIZE", ""))
        )

    # -- inputs ------------------------------------------------------------

    def request(self, target: int, reason: str = "operator"):
        """Operator-requested resize (servicer ``ResizeRequest``)."""
        with self._lock:
            self._requested = (int(target), reason)
        logger.info(
            "operator resize request: target=%s (%s)", target, reason
        )

    def set_brain(self, brain, interval_s: Optional[float] = None):
        """Attach a Brain decision source: anything with the
        ``generate_worker_plan(current_workers, speed_monitor)``
        contract (:class:`~dlrover_tpu_torch.brain.service.BrainService`).
        Consulted from the idle poll at ``interval_s`` cadence; its
        plan becomes a journaled resize decision with reason
        ``brain:<comment>`` — the same drain/reconverge machinery as
        node-loss and operator resizes, different brain."""
        self._brain = brain
        if interval_s is not None:
            self._brain_interval = max(1.0, float(interval_s))

    def _poll_brain(self, current: int, now: float) -> bool:
        """One Brain consultation; returns True when it decided."""
        if self._brain is None:
            return False
        if now - self._last_brain_poll < self._brain_interval:
            return False
        self._last_brain_poll = now
        try:
            plan = self._brain.generate_worker_plan(
                current, self._speed
            )
        except Exception:  # noqa: BLE001 - an optimizer bug must
            logger.exception("brain worker plan failed")  # not resize
            return False
        if not plan or not getattr(plan, "worker_count", 0):
            return False
        target = self._align(int(plan.worker_count))
        if target == current:
            return False
        available = len(self._available_nodes())
        if target > available:
            # a grow beyond live capacity would start a resize whose
            # rendezvous can never complete — the Brain proposes,
            # the liveness view disposes
            logger.info(
                "brain proposed world=%s but only %s nodes are "
                "alive; deferring", target, available,
            )
            return False
        comment = getattr(plan, "comment", "") or "throughput"
        self._decide(
            target, current, f"brain:{comment}", now, now
        )
        return True

    def _align(self, target: int) -> int:
        unit = self.node_unit
        target = (target // unit) * unit
        return max(self.min_nodes, min(target, self.max_nodes))

    def _available_nodes(self) -> List[int]:
        """Capacity the next round could admit: the rendezvous
        liveness view (joined/heartbeating nodes minus the ones the
        failure and heartbeat-silence paths removed)."""
        return self._rdzv.alive_node_ids()

    def _detected_ts(self, lost_ids: List[int], observed_ts: float):
        """Outage start for the decide phase: a lost node's last
        heartbeat is its last sign of life — tighter than when this
        coordinator first polled the mismatch."""
        marks = []
        for node_id in lost_ids:
            node = self._job_manager.get_node(node_id)
            if node is not None and node.heartbeat_time:
                marks.append(node.heartbeat_time)
        return min(marks + [observed_ts]) if marks else observed_ts

    # -- poll --------------------------------------------------------------

    def poll(self):
        """One decision-loop iteration; called from the master run
        loop every ``seconds_to_check_hang``."""
        if not self.enabled:
            return
        if self._state == "resizing":
            self._poll_resizing()
            return
        if self._state == "await_first_step":
            self._poll_first_step()
            return
        self._poll_idle()

    def _poll_idle(self):
        now = time.time()
        current = self._rdzv.latest_world_size()
        if current <= 0:
            return  # no round yet: the initial rendezvous owns this
        with self._lock:
            requested = self._requested
            self._requested = None
        if requested is not None:
            target, reason = requested
            target = self._align(target)
            if target != current:
                self._decide(target, current, reason, now, now)
            return
        if self._poll_brain(current, now):
            return
        available = self._available_nodes()
        target = self._align(len(available))
        if target == current or len(available) < self.min_nodes:
            self._observed = None
            return
        if self._observed is None or self._observed[0] != target:
            self._observed = (target, now)
            return
        if now - self._observed[1] < self.grace_s:
            return
        observed_ts = self._observed[1]
        self._observed = None
        lost = [
            nid for nid in self._rdzv.latest_node_ids()
            if nid not in available
        ]
        reason = (
            "node-loss" if target < current else "capacity-gain"
        )
        self._decide(
            target, current, reason,
            self._detected_ts(lost, observed_ts), now,
        )

    def _decide(
        self, target: int, from_world: int, reason: str,
        detected_ts: float, now: float,
    ):
        self.resizes += 1
        decision = {
            "id": self.resizes,
            "target": int(target),
            "from_world": int(from_world),
            "reason": reason,
            "round": int(self._rdzv.current_round()),
            "detected_ts": float(detected_ts),
            "decided_ts": float(now),
            "step_at_decision": int(
                self._speed.completed_global_step
            ),
        }
        if self.journal is not None:
            # durable BEFORE any action: a master crash mid-resize
            # replays this record and re-drives the same decision
            self.journal.append("resize", decision)
        _RESIZES_TOTAL.inc(
            direction="shrink" if target < from_world else "grow"
        )
        _RESIZE_SECONDS.observe(now - detected_ts, phase="decide")
        emit_event(
            "resize_decision",
            target=decision["target"],
            from_world=decision["from_world"],
            reason=reason,
            round=decision["round"],
            detected_ts=round(decision["detected_ts"], 3),
        )
        logger.warning(
            "resize decision #%s: world %s -> %s (%s); draining "
            "surviving agents via the heartbeat-action channel",
            self.resizes, from_world, target, reason,
        )
        self.pending = decision
        self._state = "resizing"
        self._delivered_at = {}
        self._deliver_actions()

    def _deliver_actions(self):
        """Queue the ``resize`` action for every surviving member of
        the current world; nodes already waiting to re-join (or not in
        the old world at all) need no drain."""
        now = time.time()
        alive = set(self._available_nodes())
        waiting = set(self._rdzv.waiting_node_ids())
        for node_id in self._rdzv.latest_node_ids():
            if node_id not in alive or node_id in waiting:
                continue
            last = self._delivered_at.get(node_id)
            if last is not None and (
                self.redeliver_s <= 0 or now - last < self.redeliver_s
            ):
                continue
            self._servicer.request_node_action(
                node_id, MasterAction.RESIZE
            )
            self._delivered_at[node_id] = now

    def _poll_resizing(self):
        decision = self.pending
        if decision is None:  # defensive: lost state
            self._state = "idle"
            return
        if self._rdzv.current_round() > decision["round"]:
            size = self._rdzv.latest_world_size()
            if size == decision["target"]:
                now = time.time()
                rdzv_s = now - decision["decided_ts"]
                _RESIZE_SECONDS.observe(rdzv_s, phase="rendezvous")
                emit_event(
                    "resize_phase",
                    phase="rendezvous",
                    seconds=round(rdzv_s, 3),
                    target=decision["target"],
                )
                decision["round_completed_ts"] = now
                logger.warning(
                    "resize #%s: rendezvous reconverged at world=%s "
                    "in %.1fs; waiting for the first step",
                    decision["id"], size, rdzv_s,
                )
                self._state = "await_first_step"
                return
            # the world reconverged at some OTHER size: capacity
            # changed again mid-resize — fold back to idle and let the
            # next poll re-decide against the fresh state
            logger.warning(
                "resize #%s: round completed at %s (wanted %s); "
                "re-evaluating", decision["id"], size,
                decision["target"],
            )
            self.pending = None
            self._state = "idle"
            return
        self._deliver_actions()

    def _poll_first_step(self):
        decision = self.pending
        if decision is None:
            self._state = "idle"
            return
        step = self._speed.completed_global_step
        last_ts = self._speed.last_step_time
        done_ts = decision.get(
            "round_completed_ts", decision["decided_ts"]
        )
        if step > decision["step_at_decision"] or last_ts > done_ts:
            first_s = time.time() - done_ts
            _RESIZE_SECONDS.observe(first_s, phase="first_step")
            emit_event(
                "resize_phase",
                phase="first_step",
                seconds=round(first_s, 3),
                target=decision["target"],
            )
            logger.warning(
                "resize #%s complete: world=%s stepping again "
                "(first step %.1fs after rendezvous)",
                decision["id"], decision["target"], first_s,
            )
            self.pending = None
            self._state = "idle"

    # -- master crash recovery ---------------------------------------------

    def journal_state(self) -> Dict:
        """Snapshot payload: the in-flight decision (if any) plus the
        decision counter."""
        return {
            "resizes": self.resizes,
            "state": self._state,
            "pending": dict(self.pending) if self.pending else None,
        }

    def restore_state(self, state: Dict):
        state = state or {}
        self.resizes = int(state.get("resizes", 0))
        pending = state.get("pending")
        if pending:
            self._adopt_pending(dict(pending))

    def apply_journal_entry(self, kind: str, data: Dict) -> bool:
        """Replay one incremental ``resize`` record: the LAST such
        record that is still unfinished (no later round at its target)
        becomes the pending decision the respawned master re-drives.
        Entries replay in seq order, so the completing rdzv record
        (if any) arrives AFTER this one — the caller runs
        :meth:`reconcile_after_replay` once the whole log is applied
        to drop decisions that turn out to have completed."""
        if kind != "resize":
            return False
        self.resizes = max(self.resizes, int(data.get("id", 0)))
        self._adopt_pending(dict(data))
        return True

    def reconcile_after_replay(self):
        """Replay epilogue: re-judge the pending decision against the
        FINAL restored rendezvous state.  A resize whose target round
        was journaled after the decision record would otherwise
        replay as still-pending and emit a spurious rendezvous phase
        spanning the whole outage."""
        if self.pending is not None:
            self._adopt_pending(dict(self.pending))

    def _adopt_pending(self, decision: Dict):
        """A replayed decision is pending only while no newer round
        reached its target; completed resizes replay as no-ops."""
        if (
            self._rdzv.current_round() > int(decision.get("round", 0))
            and self._rdzv.latest_world_size()
            == int(decision.get("target", -1))
        ):
            self.pending = None
            self._state = "idle"
            return
        self.pending = decision
        self._state = "resizing"
        # fresh delivery map: the respawned master re-delivers the
        # action — agents that already restarted are in the waiting
        # pool (or the new round) and are skipped
        self._delivered_at = {}


class AllreduceAutoScaler:
    """Worker-count auto-scaling for SPMD jobs (reference:
    AllreduceTrainingAutoScaler:254)."""

    def __init__(
        self,
        job_manager: DistributedJobManager,
        speed_monitor: SpeedMonitor,
        optimizer: Optional[LocalOptimizer] = None,
        interval: float = 300.0,
        min_nodes: int = 1,
        max_nodes: int = 0,
        node_unit: int = 1,
    ):
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._optimizer = optimizer or LocalOptimizer()
        self._interval = interval
        self._min_nodes = min_nodes
        self._max_nodes = max_nodes
        self._node_unit = max(1, node_unit)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="auto-scaler"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _alive_worker_count(self) -> int:
        return sum(
            1
            for n in self._job_manager.all_nodes().values()
            if n.type == NodeType.WORKER
            and n.status == NodeStatus.RUNNING
        )

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.execute_scale_once()
            except Exception:  # noqa: BLE001
                logger.exception("auto-scale iteration failed")

    def execute_scale_once(self):
        alive = self._alive_worker_count()
        plan = self._optimizer.generate_worker_plan(
            alive, self._speed_monitor
        )
        target = self._align(plan.worker_count)
        if target != alive and target > 0:
            logger.info(
                "auto-scale: %s -> %s workers", alive, target
            )
            self._job_manager.adjust_worker_count(target)

    def _align(self, target: int) -> int:
        """node_unit rounding within [min, max] (reference: rdzv
        node_unit semantics)."""
        unit = self._node_unit
        target = (target // unit) * unit
        if self._max_nodes:
            target = min(target, self._max_nodes)
        return max(target, self._min_nodes)
