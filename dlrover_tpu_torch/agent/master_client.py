"""Singleton client wrapping every master RPC.

Copy of ``dlrover_tpu/agent/master_client.py`` (the port imports
nothing of the JAX package).

Reference: ``dlrover/python/elastic_agent/master_client.py:50``
(``MasterClient`` + ``retry_grpc_request:28``).  One typed method per
control-plane interaction — rendezvous join/poll, KV store, shard
tasks, metrics, failures, heartbeats — all over the two-verb
report/get transport, with uniform retry.
"""

import os
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import (
    RPC_RESYNC_TIMEOUT_ENV,
    MessageClient,
)
from dlrover_tpu_torch.common.constants import NodeEnv, NodeType, TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event

# how long an agent/trainer parks waiting for a crashed master to be
# respawned before giving up (seconds); the journal-backed respawn
# takes ~1-2 s locally, minutes on a cluster scheduler
DEFAULT_RESYNC_TIMEOUT = 120.0

# step-report piggybacking (fleet fan-in relief, measured by the
# fleet load harness): when armed, report_global_step coalesces —
# the latest step rides the next heartbeat, or is flushed directly
# once per window — instead of paying one RPC per step.  The master
# only needs the LATEST step (SpeedMonitor keeps a monotone max), so
# coalescing is semantically safe; the cost is sample density in the
# speed window, which is why it defaults OFF outside the harness.
STEP_PIGGYBACK_ENV = "DLROVER_STEP_PIGGYBACK"
STEP_PIGGYBACK_WINDOW_ENV = "DLROVER_STEP_PIGGYBACK_WINDOW_S"
DEFAULT_STEP_PIGGYBACK_WINDOW = 2.0


def retry_request(func):
    """Retry an RPC a few times before giving up (reference:
    ``retry_grpc_request``, master_client.py:28)."""

    def wrapped(self, *args, **kwargs):
        retry = 3
        last_exc: Optional[Exception] = None
        for i in range(retry):
            try:
                return func(self, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 - transport errors vary
                last_exc = e
                logger.warning(
                    "RPC %s failed (attempt %s/%s): %s",
                    func.__name__, i + 1, retry, e,
                )
                time.sleep(1 + i * 2)
        raise RuntimeError(
            f"RPC {func.__name__} failed after {retry} attempts"
        ) from last_exc

    return wrapped


class MasterClient:
    """Typed facade over the master's report/get service."""

    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(
        self,
        master_addr: str,
        node_id: int,
        node_type: str,
        node_rank: Optional[int] = None,
        local_world_size: Optional[int] = None,
    ):
        """``node_rank`` / ``local_world_size`` override the ambient
        env lookups — the fleet harness runs hundreds of clients in
        one process, where a shared env cannot identify them."""
        self._addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        try:
            resync_timeout = float(
                os.environ.get(
                    RPC_RESYNC_TIMEOUT_ENV, DEFAULT_RESYNC_TIMEOUT
                )
            )
        except ValueError:
            resync_timeout = DEFAULT_RESYNC_TIMEOUT
        self._client = MessageClient(
            master_addr, node_id, node_type,
            resync_timeout=resync_timeout,
        )
        # durable progress marks replayed to a recovered master so it
        # rebuilds this node's live state without restarting trainers
        self._last_reported_step = 0
        self._last_acked_dataset = ""
        self._last_acked_task = -1
        # bounded ack history for resync reconciliation: the mirror
        # can lose EVERY ack inside one group-commit window (0.25 s
        # default), not just the last — 64 spans that window at any
        # plausible ack rate
        self._recent_acks: deque = deque(maxlen=64)
        self._master_incarnation = ""
        self._client.set_session_resync(self._session_resync)
        # step-report coalescing (see STEP_PIGGYBACK_ENV above):
        # _pending_step holds the newest unreported (step, ts) and is
        # drained by the next heartbeat or a windowed direct flush
        self._piggyback = os.environ.get(
            STEP_PIGGYBACK_ENV, ""
        ).strip().lower() in ("1", "true", "yes", "on")
        try:
            self._piggyback_window = float(os.environ.get(
                STEP_PIGGYBACK_WINDOW_ENV,
                DEFAULT_STEP_PIGGYBACK_WINDOW,
            ))
        except ValueError:
            self._piggyback_window = DEFAULT_STEP_PIGGYBACK_WINDOW
        self._step_lock = threading.Lock()
        self._pending_step: Optional[Tuple[int, float]] = None
        self._last_step_send = 0.0

    def session_resync(self):
        """Replay the session-resync handshake on demand (fleet
        harness fault mix; normally the transport's park loop drives
        it after a master crash)."""
        self._session_resync()

    def _session_resync(self):
        """Handshake replayed after the master comes back from a
        crash (called by the transport's park loop, re-entrancy
        guarded there)."""
        resp: msg.SessionResyncResponse = self._client.get(
            msg.SessionResyncRequest(
                node_id=self._node_id,
                node_rank=(
                    self._node_rank
                    if self._node_rank is not None
                    else env_utils.get_node_rank()
                ),
                node_type=self._node_type,
                local_world_size=(
                    self._local_world_size
                    if self._local_world_size is not None
                    else env_utils.get_local_world_size()
                ),
                restart_count=env_utils.get_restart_count(),
                last_step=self._last_reported_step,
                last_acked_dataset=self._last_acked_dataset,
                last_acked_task=self._last_acked_task,
                recent_acked_tasks=list(self._recent_acks),
            )
        )
        recovered = bool(
            self._master_incarnation
            and resp.incarnation != self._master_incarnation
        )
        self._master_incarnation = resp.incarnation
        emit_event(
            "master_resync",
            node_id=self._node_id,
            incarnation=resp.incarnation,
            recoveries=resp.recoveries,
            rdzv_round=resp.rdzv_round,
            master_changed=recovered,
            last_step=self._last_reported_step,
        )
        logger.warning(
            "session resync with master %s complete (incarnation %s, "
            "recoveries %s, rdzv round %s)",
            self._addr, resp.incarnation, resp.recoveries,
            resp.rdzv_round,
        )

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def singleton(cls) -> "MasterClient":
        with cls._lock:
            if cls._instance is None:
                addr = os.getenv(NodeEnv.MASTER_ADDR, "")
                if not addr:
                    raise RuntimeError(
                        f"{NodeEnv.MASTER_ADDR} is not set; cannot reach "
                        "the job master"
                    )
                cls._instance = cls(
                    addr,
                    env_utils.get_node_id(),
                    os.getenv("DLROVER_NODE_TYPE", NodeType.WORKER),
                )
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
            cls._instance = None

    @property
    def node_id(self) -> int:
        return self._node_id

    @property
    def master_addr(self) -> str:
        return self._addr

    def close(self):
        try:
            self.flush_step_report()
        except Exception:  # noqa: BLE001 - best-effort final drain
            pass
        self._client.close()

    # -- rendezvous --------------------------------------------------------

    @retry_request
    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str,
        node_ip: str = "",
    ) -> int:
        req = msg.JoinRendezvousRequest(
            node_id=self._node_id,
            node_rank=node_rank,
            local_world_size=local_world_size,
            rdzv_name=rdzv_name,
            node_ip=node_ip or socket.gethostbyname(socket.gethostname()),
        )
        resp: msg.JoinRendezvousResponse = self._client.get(req)
        return resp.round

    @retry_request
    def get_comm_world(
        self, rdzv_name: str, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        req = msg.CommWorldRequest(
            node_id=self._node_id, node_rank=node_rank, rdzv_name=rdzv_name
        )
        resp: msg.CommWorldResponse = self._client.get(req)
        return resp.rdzv_round, resp.group, resp.world, resp.coordinator

    @retry_request
    def num_nodes_waiting(self, rdzv_name: str) -> int:
        resp: msg.NumNodesWaitingResponse = self._client.get(
            msg.NumNodesWaitingRequest(rdzv_name=rdzv_name)
        )
        return resp.num_nodes

    @retry_request
    def network_ready(self) -> bool:
        resp = self._client.get(msg.NetworkReadyRequest())
        return bool(resp.success)

    @retry_request
    def report_network_status(
        self, node_id: int, normal: bool, elapsed_time: float
    ) -> bool:
        return self._client.report(
            msg.NetworkStatusRequest(
                node_id=node_id, normal=normal, elapsed_time=elapsed_time
            )
        )

    @retry_request
    def check_fault_node(self) -> msg.NetworkCheckResultResponse:
        return self._client.get(
            msg.NetworkCheckResultRequest(node_id=self._node_id)
        )

    # -- KV store (rendezvous bootstrap / barriers) ------------------------

    @retry_request
    def kv_store_set(self, key: str, value: bytes) -> bool:
        return self._client.report(msg.KeyValuePair(key=key, value=value))

    @retry_request
    def kv_store_get(self, key: str) -> bytes:
        resp: msg.KeyValuePair = self._client.get(
            msg.KeyValueGetRequest(key=key)
        )
        return resp.value

    @retry_request
    def kv_store_add(self, key: str, amount: int) -> int:
        resp: msg.KeyValueAddResponse = self._client.get(
            msg.KeyValueAddRequest(key=key, amount=amount)
        )
        return resp.value

    # -- dynamic data sharding --------------------------------------------

    @retry_request
    def report_dataset_shard_params(
        self,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        shuffle: bool,
        num_minibatches_per_shard: int,
        dataset_name: str,
        task_type: str = TaskType.TRAINING,
        storage_type: str = "text",
    ) -> bool:
        return self._client.report(
            msg.DatasetShardParams(
                batch_size=batch_size,
                num_epochs=num_epochs,
                dataset_size=dataset_size,
                shuffle=shuffle,
                num_minibatches_per_shard=num_minibatches_per_shard,
                dataset_name=dataset_name,
                task_type=task_type,
                storage_type=storage_type,
            )
        )

    @retry_request
    def get_task(self, dataset_name: str) -> msg.ShardTask:
        return self._client.get(
            msg.GetShardTaskRequest(
                worker_id=self._node_id, dataset_name=dataset_name
            )
        )

    @retry_request
    def report_task_result(
        self, dataset_name: str, task_id: int, success: bool = True,
        error: str = "",
    ) -> bool:
        ok = self._client.report(
            msg.ReportTaskResultRequest(
                task_id=task_id,
                dataset_name=dataset_name,
                worker_id=self._node_id,
                success=success,
                error=error,
            )
        )
        if ok and success:
            self._last_acked_dataset = dataset_name
            self._last_acked_task = task_id
            self._recent_acks.append((dataset_name, task_id))
        return ok

    @retry_request
    def get_dataset_checkpoint(self, dataset_name: str) -> str:
        resp: msg.DatasetCheckpointResponse = self._client.get(
            msg.DatasetCheckpointRequest(dataset_name=dataset_name)
        )
        return resp.content

    @retry_request
    def restore_dataset_checkpoint(
        self, dataset_name: str, content: str
    ) -> bool:
        return self._client.report(
            msg.RestoreDatasetCheckpointRequest(
                dataset_name=dataset_name, content=content
            )
        )

    # -- metrics / monitoring ---------------------------------------------

    def report_global_step(self, global_step: int, timestamp: float = 0.0):
        """Report training progress.  With ``DLROVER_STEP_PIGGYBACK``
        armed this coalesces: the latest step is stashed to ride the
        next heartbeat, and a direct send happens at most once per
        piggyback window — one control-plane RPC per window instead
        of one per step (the fleet scoreboard's top contention fix)."""
        ts = timestamp or time.time()
        if self._piggyback:
            with self._step_lock:
                self._pending_step = (int(global_step), ts)
                due = (
                    time.monotonic() - self._last_step_send
                    >= self._piggyback_window
                )
            if not due:
                self._last_reported_step = max(
                    self._last_reported_step, int(global_step)
                )
                return True
        return self._send_global_step(global_step, ts)

    @retry_request
    def _send_global_step(self, global_step: int, timestamp: float):
        ok = self._client.report(
            msg.GlobalStepRecord(
                node_id=self._node_id,
                global_step=global_step,
                timestamp=timestamp,
            )
        )
        with self._step_lock:
            self._last_step_send = time.monotonic()
            pending = self._pending_step
            if pending is not None and pending[0] <= int(global_step):
                self._pending_step = None
        self._last_reported_step = max(
            self._last_reported_step, int(global_step)
        )
        return ok

    def flush_step_report(self) -> bool:
        """Deliver any coalesced step immediately (shutdown paths and
        the fleet agents' stop drain call this so the master's final
        progress view is exact)."""
        with self._step_lock:
            pending = self._pending_step
        if pending is None:
            return True
        return bool(self._send_global_step(pending[0], pending[1]))

    @retry_request
    def report_resource_stats(
        self,
        cpu_percent: float,
        memory_mb: float,
        chip_stats: Optional[List[Dict[str, float]]] = None,
    ):
        return self._client.report(
            msg.NodeResourceStats(
                node_id=self._node_id,
                node_type=self._node_type,
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                chip_stats=chip_stats or [],
            )
        )

    @retry_request
    def report_model_info(
        self, num_params: int, dtype: str = "", flops_per_step: float = 0.0
    ):
        return self._client.report(
            msg.ModelInfo(
                num_params=num_params,
                dtype=dtype,
                flops_per_step=flops_per_step,
            )
        )

    @retry_request
    def report_heartbeat(self, timestamp: float = 0.0) -> str:
        # drain a coalesced step report on the heartbeat: the master
        # handles the piggybacked fields exactly like a
        # GlobalStepRecord, so one RPC does the work of two
        with self._step_lock:
            pending = self._pending_step
            self._pending_step = None
        req = msg.HeartbeatRequest(
            node_id=self._node_id, timestamp=timestamp or time.time()
        )
        if pending is not None:
            req.global_step, req.step_timestamp = pending
        try:
            resp: msg.HeartbeatResponse = self._client.get(req)
        except Exception:
            if pending is not None:
                # the step must not be lost to a failed heartbeat —
                # restore it (newer steps win the race)
                with self._step_lock:
                    if (
                        self._pending_step is None
                        or self._pending_step[0] < pending[0]
                    ):
                        self._pending_step = pending
            raise
        if pending is not None:
            with self._step_lock:
                self._last_step_send = time.monotonic()
            self._last_reported_step = max(
                self._last_reported_step, int(pending[0])
            )
        return resp.action

    # -- failure / lifecycle ----------------------------------------------

    @retry_request
    def report_failure(
        self, error_data: str, level: str, restart_count: int = 0,
        node_rank: int = -1,
    ) -> bool:
        return self._client.report(
            msg.NodeFailure(
                node_id=self._node_id,
                node_rank=node_rank,
                error_data=error_data,
                level=level,
                restart_count=restart_count,
            )
        )

    @retry_request
    def report_diagnosis_data(self, data_type: str, content: str) -> bool:
        return self._client.report(
            msg.DiagnosisData(
                node_id=self._node_id,
                data_type=data_type,
                content=content,
                timestamp=time.time(),
            )
        )

    def report_node_event_once(
        self, event_type: str, status: str, exit_reason: str = ""
    ) -> bool:
        """Single-shot (unretried) variant for advisory reports whose
        retry could deliver duplicates: the preemption notice is a
        latency optimization — the pod watcher is the durable fallback
        when the report is lost, so re-sending buys nothing and a
        success-with-lost-ack retry would feed the master the same
        death twice."""
        return self._client.report(
            msg.NodeEventReport(
                node_id=self._node_id,
                node_type=self._node_type,
                event_type=event_type,
                status=status,
                exit_reason=exit_reason,
            )
        )

    report_node_event = retry_request(report_node_event_once)

    @retry_request
    def ready_to_exit(self, reason: str = "") -> bool:
        return self._client.report(
            msg.ReadyToExitRequest(node_id=self._node_id, reason=reason)
        )

    @retry_request
    def get_parallel_config(self) -> msg.ParallelConfig:
        return self._client.get(
            msg.ParallelConfigRequest(node_id=self._node_id)
        )

    @retry_request
    def report_job_exit(self, reason: str) -> bool:
        return self._client.report(msg.JobExitRequest(reason=reason))

    @retry_request
    def request_resize(self, target: int, reason: str = "operator") -> bool:
        """Operator-requested elastic world resize: ask the master's
        resize coordinator to reconverge the job at ``target`` nodes."""
        return self._client.report(
            msg.ResizeRequest(target=target, reason=reason)
        )
