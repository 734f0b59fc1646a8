"""Master request servicer: single report/get dispatch hub.

Copy of ``dlrover_tpu/master/servicer.py`` (the port imports nothing
of the JAX package).

Role of ``dlrover/python/master/servicer.py``: every agent/trainer
message lands here and is dispatched by dataclass type to rendezvous
managers, the KV store, the task manager, the job manager and the
monitors.  The reference dispatches ~40 pickled message types through
one gRPC ``report``/``get`` pair (``servicer.py:98,296``); this is the
same design over the socket transport.
"""

import base64
import time
from typing import Dict

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import RequestHandler
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
    RendezvousManager,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager
from dlrover_tpu_torch.telemetry.metrics import get_registry

# control-plane SLO raw material: every dispatched request is timed
# by verb ("get.<MessageType>" / "report.<MessageType>") so the SLO
# checker can hold the servicer paths to declarative latency bounds
# — the fleet-scale load harness (ROADMAP item 4) measures against
# exactly these series
_RPC_SECONDS = get_registry().histogram(
    "dlrover_rpc_seconds",
    "Master servicer dispatch latency by verb "
    "(verb.MessageType, handler execution only)",
)
# fleet fan-in: how many server threads sit INSIDE each verb's
# handler right now — the scoreboard reads this to tell queueing
# (rising in-flight, flat handler time) from slow handlers
_RPC_INFLIGHT = get_registry().gauge(
    "dlrover_rpc_inflight",
    "Requests currently executing in the servicer, by verb",
)


class MasterServicer(RequestHandler):
    def __init__(
        self,
        task_manager: TaskManager,
        job_manager: JobManager,
        rdzv_managers: Dict[str, RendezvousManager],
        kv_store: KVStoreService,
        speed_monitor: SpeedMonitor,
    ):
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._rdzv_managers = rdzv_managers
        self._kv_store = kv_store
        self._speed_monitor = speed_monitor
        self._paral_config = msg.ParallelConfig()
        self.diagnosis_records = []
        self.resource_stats: Dict[int, msg.NodeResourceStats] = {}
        self.model_info = msg.ModelInfo()
        self._exit_reason = ""
        # master crash recovery: set by JobMaster when journaling is
        # on.  ``incarnation`` identifies THIS master process; agents
        # compare it across session resyncs to detect a recovery.
        self.journal = None
        self.incarnation = ""
        self.recoveries = 0
        # per-node actions the master piggybacks on the next heartbeat
        # ack (diagnosis chain's culprit-only relaunch); one pending
        # action per node, latest wins
        self._node_actions: Dict[int, str] = {}
        # elastic world-resize: set by JobMaster; operator
        # ResizeRequest messages land here
        self.resize_coordinator = None

    def request_node_action(self, node_id: int, action: str):
        """Queue ``action`` for delivery on node ``node_id``'s next
        heartbeat (the agent consumes it from the ack)."""
        self._node_actions[int(node_id)] = action

    def _jot(self, kind: str, data: Dict):
        if self.journal is not None:
            self.journal.append(kind, data)

    @property
    def elastic_rdzv(self) -> ElasticTrainingRendezvousManager:
        return self._rdzv_managers[RendezvousName.ELASTIC_TRAINING]

    @property
    def network_rdzv(self) -> NetworkCheckRendezvousManager:
        return self._rdzv_managers[RendezvousName.NETWORK_CHECK]

    # ------------------------------------------------------------------
    # get: request/response
    # ------------------------------------------------------------------

    def get(self, node_id: int, node_type: str, message):
        verb = f"get.{type(message).__name__}"
        inflight = _RPC_INFLIGHT.labels(verb=verb)
        inflight.inc()
        try:
            with _RPC_SECONDS.time(verb=verb):
                return self._dispatch_get(node_id, node_type, message)
        finally:
            inflight.dec()

    def _dispatch_get(self, node_id: int, node_type: str, message):
        if isinstance(message, msg.JoinRendezvousRequest):
            mngr = self._rdzv_managers[
                message.rdzv_name or RendezvousName.ELASTIC_TRAINING
            ]
            round_ = mngr.join_rendezvous(
                message.node_id,
                message.node_rank,
                message.local_world_size,
                message.node_ip,
            )
            # a join from a node the master wrote off (heartbeat
            # silence, reported death) is a REJOIN: a replacement
            # agent came back under the same identity and must flow
            # back into the liveness/speed accounting — elastic
            # grow-back depends on it
            self._job_manager.handle_node_rejoin(
                message.node_id, node_type
            )
            self._job_manager.collect_heartbeat(message.node_id)
            if (message.rdzv_name or RendezvousName.ELASTIC_TRAINING
                    ) == RendezvousName.ELASTIC_TRAINING:
                # this node's previous trainer incarnation is
                # definitively gone (its agent is re-forming the
                # world): any dataset lease it still holds would
                # otherwise sit in `doing` until the 30-min timeout
                # and wedge the epoch's tail — re-queue it now
                self._task_manager.recycle_worker_tasks(
                    message.node_id
                )
            return msg.JoinRendezvousResponse(round=round_)

        if isinstance(message, msg.CommWorldRequest):
            mngr = self._rdzv_managers[
                message.rdzv_name or RendezvousName.ELASTIC_TRAINING
            ]
            round_, group, world, coordinator = mngr.get_comm_world(
                message.node_rank
            )
            return msg.CommWorldResponse(
                rdzv_round=round_,
                group=group,
                world=world,
                coordinator=coordinator,
            )

        if isinstance(message, msg.NumNodesWaitingRequest):
            mngr = self._rdzv_managers[
                message.rdzv_name or RendezvousName.ELASTIC_TRAINING
            ]
            return msg.NumNodesWaitingResponse(
                num_nodes=mngr.num_nodes_waiting()
            )

        if isinstance(message, msg.NetworkCheckResultRequest):
            fault, reason = self.network_rdzv.check_fault_node()
            stragglers, _ = self.network_rdzv.detect_stragglers()
            return msg.NetworkCheckResultResponse(
                normal=message.node_id not in fault,
                fault_nodes=fault,
                straggler_nodes=stragglers,
                reason=reason,
            )

        if isinstance(message, msg.KeyValueGetRequest):
            return msg.KeyValuePair(
                key=message.key, value=self._kv_store.get(message.key)
            )

        if isinstance(message, msg.KeyValueAddRequest):
            value = self._kv_store.add(message.key, message.amount)
            self._jot(
                "kv_add",
                {"key": message.key, "amount": message.amount},
            )
            return msg.KeyValueAddResponse(value=value)

        if isinstance(message, msg.SessionResyncRequest):
            # agent -> recovered-master handshake: rebuild this
            # node's live state (liveness, rendezvous membership,
            # progress marks) WITHOUT restarting its healthy trainers
            self._job_manager.collect_heartbeat(message.node_id)
            self.elastic_rdzv.add_alive_node(message.node_id)
            if message.last_step > 0:
                self._speed_monitor.collect_global_step(
                    message.last_step
                )
            self._speed_monitor.add_running_worker(message.node_id)
            # close any lease this worker already acked that the
            # recovered master still holds open — the journal
            # mirror's group-commit lag can lose the dead master's
            # final acks on a different-host respawn, and without
            # this the shard would re-dispatch (duplicate work).
            # Several acks can land inside ONE commit window, so the
            # whole recent-ack history reconciles, not just the last
            acked = [
                (str(pair[0]), int(pair[1]))
                for pair in (message.recent_acked_tasks or [])
            ]
            last = (
                message.last_acked_dataset, message.last_acked_task
            )
            if message.last_acked_task >= 0 and last not in acked:
                acked.append(last)  # older agent: single-slot resync
            # batched: the whole recent-ack history reconciles under
            # ONE journal io-lock claim + ONE fsync — a 64-ack resync
            # used to do 64 sequential appends, the first SLO breach
            # the fleet scoreboard found past 200 agents
            self._task_manager.reconcile_acked_tasks(acked)
            emit_event(
                "agent_resync",
                node_id=message.node_id,
                node_rank=message.node_rank,
                restart_count=message.restart_count,
                last_step=message.last_step,
                last_acked_dataset=message.last_acked_dataset,
                last_acked_task=message.last_acked_task,
            )
            return msg.SessionResyncResponse(
                incarnation=self.incarnation,
                rdzv_round=self.elastic_rdzv.current_round(),
                recoveries=self.recoveries,
            )

        if isinstance(message, msg.GetShardTaskRequest):
            return self._task_manager.get_dataset_task(
                message.worker_id, message.dataset_name
            )

        if isinstance(message, msg.DatasetCheckpointRequest):
            return msg.DatasetCheckpointResponse(
                content=self._task_manager.get_dataset_checkpoint(
                    message.dataset_name
                )
            )

        if isinstance(message, msg.ParallelConfigRequest):
            return self._paral_config

        if isinstance(message, msg.HeartbeatRequest):
            self._job_manager.collect_heartbeat(
                message.node_id, message.timestamp
            )
            # a piggybacked step report rode the heartbeat (the
            # agent-side coalescing that halves fleet RPC volume) —
            # feed the speed monitor as if it were a GlobalStepRecord
            if getattr(message, "global_step", -1) >= 0:
                self._speed_monitor.collect_global_step(
                    message.global_step,
                    message.step_timestamp or message.timestamp,
                )
            # piggyback a pending action (e.g. the hang diagnosis'
            # culprit-only restart) on the ack — delivered once
            return msg.HeartbeatResponse(
                action=self._node_actions.pop(message.node_id, "")
            )

        if isinstance(message, msg.NodeFailure):
            return msg.BaseResponse(
                success=self._handle_node_failure(message)
            )

        logger.warning("unhandled get message %s", type(message).__name__)
        return msg.BaseResponse(
            success=False, message=f"unhandled {type(message).__name__}"
        )

    def _handle_node_failure(self, message: msg.NodeFailure) -> bool:
        relaunch = self._job_manager.handle_failure(
            message.node_id,
            message.restart_count,
            message.error_data,
            message.level,
        )
        # failed node's shards go back to the queue
        self._task_manager.recycle_worker_tasks(message.node_id)
        self.elastic_rdzv.remove_alive_node(message.node_id)
        self._speed_monitor.remove_running_worker(message.node_id)
        return relaunch

    # ------------------------------------------------------------------
    # report: fire-and-ack
    # ------------------------------------------------------------------

    def report(self, node_id: int, node_type: str, message) -> bool:
        verb = f"report.{type(message).__name__}"
        inflight = _RPC_INFLIGHT.labels(verb=verb)
        inflight.inc()
        try:
            with _RPC_SECONDS.time(verb=verb):
                return self._dispatch_report(
                    node_id, node_type, message
                )
        finally:
            inflight.dec()

    def _dispatch_report(
        self, node_id: int, node_type: str, message
    ) -> bool:
        if isinstance(message, msg.DatasetShardParams):
            self._task_manager.new_dataset(message)
            if message.batch_size:
                self._speed_monitor.set_batch_size(message.batch_size)
            return True

        if isinstance(message, msg.ReportTaskResultRequest):
            return self._task_manager.report_dataset_task(
                message.dataset_name, message.task_id, message.success
            )

        if isinstance(message, msg.RestoreDatasetCheckpointRequest):
            return self._task_manager.restore_dataset_from_checkpoint(
                message.dataset_name, message.content
            )

        if isinstance(message, msg.KeyValuePair):
            self._kv_store.set(message.key, message.value)
            self._jot(
                "kv_set",
                {
                    "key": message.key,
                    "value": base64.b64encode(
                        message.value or b""
                    ).decode("ascii"),
                },
            )
            return True

        if isinstance(message, msg.GlobalStepRecord):
            self._speed_monitor.collect_global_step(
                message.global_step, message.timestamp
            )
            self._job_manager.collect_heartbeat(message.node_id)
            return True

        if isinstance(message, msg.HeartbeatRequest):
            self._job_manager.collect_heartbeat(
                message.node_id, message.timestamp
            )
            if getattr(message, "global_step", -1) >= 0:
                self._speed_monitor.collect_global_step(
                    message.global_step,
                    message.step_timestamp or message.timestamp,
                )
            return True

        if isinstance(message, msg.NetworkStatusRequest):
            self.network_rdzv.report_network_status(
                message.node_id, message.normal, message.elapsed_time
            )
            return True

        if isinstance(message, msg.NodeEventReport):
            if message.event_type == "preemption_notice":
                # ADVANCE notice: the node is still alive and
                # stepping — plan the replacement now, transition the
                # node only when it actually exits (watcher event or
                # failure report).  Routing this through the status
                # path marked a live node FAILED and aborted the job
                # mid-grace-period.
                self._job_manager.handle_preemption_notice(
                    message.node_id, message.node_type
                )
                return True
            # membership/speed/shard-recycling side effects happen in
            # the registered event callbacks (event_callback.py), not
            # inline — one path for agent-reported and watcher-observed
            # transitions alike
            self._job_manager.update_node_status(
                message.node_id,
                message.node_type,
                message.status,
                message.exit_reason,
            )
            return True

        if isinstance(message, msg.NodeFailure):
            # the agent SENDS failures through the report verb
            # (master_client.report_failure); they were only handled
            # on the get path, so every agent-reported worker death
            # fell through to "unhandled" — shards were never
            # recycled and the dead node stayed in the rendezvous
            # pool (surfaced by the multinode partition chaos run)
            return self._handle_node_failure(message)

        if isinstance(message, msg.NodeResourceStats):
            self.resource_stats[message.node_id] = message
            return True

        if isinstance(message, msg.ModelInfo):
            self.model_info = message
            return True

        if isinstance(message, msg.DiagnosisData):
            self.diagnosis_records.append(message)
            return True

        if isinstance(message, msg.ParallelConfig):
            self._paral_config = message
            return True

        if isinstance(message, msg.ReadyToExitRequest):
            self._job_manager.update_node_status(
                message.node_id, "worker", "succeeded"
            )
            return True

        if isinstance(message, msg.ResizeRequest):
            if self.resize_coordinator is None:
                logger.warning(
                    "resize request ignored: no coordinator wired"
                )
                return False
            self.resize_coordinator.request(
                message.target, message.reason or "operator"
            )
            return True

        if isinstance(message, msg.JobExitRequest):
            self._exit_reason = message.reason or "requested"
            # terminal job decision: durable, so a respawned master
            # honors it instead of resurrecting a finished job
            self._jot("job_exit", {"reason": self._exit_reason})
            return True

        logger.warning("unhandled report message %s", type(message).__name__)
        return False

    def drain_diagnosis_records(self):
        """Hand the accumulated agent diagnosis reports to the
        master's inference-chain manager (report() runs on server
        threads; the atomic swap keeps the hand-off race-free)."""
        records, self.diagnosis_records = self.diagnosis_records, []
        return records

    @property
    def exit_requested(self) -> str:
        return self._exit_reason
