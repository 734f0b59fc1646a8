"""Control-plane message schema between master, agents and trainers.

Copy of ``dlrover_tpu/common/messages.py`` (the port imports nothing
of the JAX package).

The reference serializes ~45 ``@dataclass`` message types with pickle
inside a generic proto ``Message.data`` and dispatches on type in the
servicer (``dlrover/python/common/grpc.py:129-``,
``dlrover/proto/elastic_training.proto:20-34``).  We keep the same
shape — one ``report`` (fire-and-forget ack) and one ``get``
(request/response) verb, typed dataclasses dispatched by class — over
the socket transport in :mod:`dlrover_tpu_torch.common.comm`.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Message:
    """Marker base class for control-plane messages."""


# ---------------------------------------------------------------------------
# Generic / envelope
# ---------------------------------------------------------------------------


@dataclass
class BaseRequest(Message):
    node_id: int = -1
    node_type: str = ""
    data: object = None


@dataclass
class BaseResponse(Message):
    success: bool = True
    message: str = ""


# ---------------------------------------------------------------------------
# Rendezvous (reference: servicer._join_rendezvous / rdzv_manager)
# ---------------------------------------------------------------------------


@dataclass
class JoinRendezvousRequest(Message):
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""
    node_ip: str = ""


@dataclass
class JoinRendezvousResponse(Message):
    round: int = 0


@dataclass
class CommWorldRequest(Message):
    node_id: int = 0
    node_rank: int = 0
    rdzv_name: str = ""


@dataclass
class CommWorldResponse(Message):
    rdzv_round: int = 0
    group: int = 0
    # {node_rank: local_world_size}, empty while rendezvous incomplete
    world: Dict[int, int] = field(default_factory=dict)
    # torch.distributed rendezvous address (host:port of rank 0's TCP
    # store, init_method "tcp://" + coordinator); chosen by the master
    # as the lowest-rank node's ip:port once the round completes.
    coordinator: str = ""


@dataclass
class NumNodesWaitingRequest(Message):
    rdzv_name: str = ""


@dataclass
class NumNodesWaitingResponse(Message):
    num_nodes: int = 0


@dataclass
class NetworkReadyRequest(Message):
    pass


@dataclass
class NetworkStatusRequest(Message):
    node_id: int = 0
    normal: bool = True
    elapsed_time: float = 0.0


@dataclass
class NetworkCheckResultRequest(Message):
    node_id: int = 0


@dataclass
class NetworkCheckResultResponse(Message):
    normal: bool = True
    # nodes the master has diagnosed as faulty / straggling this round
    fault_nodes: List[int] = field(default_factory=list)
    straggler_nodes: List[int] = field(default_factory=list)
    reason: str = ""


# ---------------------------------------------------------------------------
# KV store (rendezvous bootstrap store; reference: master_kv_store.py)
# ---------------------------------------------------------------------------


@dataclass
class KeyValuePair(Message):
    key: str = ""
    value: bytes = b""


@dataclass
class KeyValueGetRequest(Message):
    key: str = ""


@dataclass
class KeyValueAddRequest(Message):
    key: str = ""
    amount: int = 0


@dataclass
class KeyValueAddResponse(Message):
    value: int = 0


# ---------------------------------------------------------------------------
# Dynamic data sharding (reference: shard/task_manager.py, proto Task)
# ---------------------------------------------------------------------------


@dataclass
class DatasetShardParams(Message):
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = "text"


@dataclass
class ShardTask(Message):
    task_id: int = -1
    task_type: str = ""
    dataset_name: str = ""
    start: int = 0
    end: int = 0
    # optional shuffled per-sample index list for this shard
    indices: Optional[List[int]] = None

    @property
    def shard_size(self) -> int:
        return self.end - self.start


@dataclass
class GetShardTaskRequest(Message):
    worker_id: int = 0
    dataset_name: str = ""


@dataclass
class ReportTaskResultRequest(Message):
    task_id: int = -1
    dataset_name: str = ""
    worker_id: int = 0
    success: bool = True
    error: str = ""


@dataclass
class DatasetCheckpointRequest(Message):
    dataset_name: str = ""


@dataclass
class DatasetCheckpointResponse(Message):
    content: str = ""


@dataclass
class RestoreDatasetCheckpointRequest(Message):
    dataset_name: str = ""
    content: str = ""


# ---------------------------------------------------------------------------
# Metrics / monitoring (reference: servicer report paths, SpeedMonitor)
# ---------------------------------------------------------------------------


@dataclass
class GlobalStepRecord(Message):
    node_id: int = 0
    global_step: int = 0
    timestamp: float = 0.0


@dataclass
class NodeResourceStats(Message):
    node_id: int = 0
    node_type: str = ""
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    # per-chip HBM/duty-cycle stats when available
    chip_stats: List[Dict[str, float]] = field(default_factory=list)


@dataclass
class ModelInfo(Message):
    num_params: int = 0
    dtype: str = ""
    flops_per_step: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)


@dataclass
class HeartbeatRequest(Message):
    node_id: int = 0
    timestamp: float = 0.0
    # step-report piggybacking (fleet fan-in relief): a client with
    # DLROVER_STEP_PIGGYBACK armed folds its latest global step into
    # the heartbeat instead of paying a second RPC; -1 = none riding
    global_step: int = -1
    step_timestamp: float = 0.0


@dataclass
class HeartbeatResponse(Message):
    # master can piggyback an action on the heartbeat ack
    action: str = ""


# ---------------------------------------------------------------------------
# Failure / diagnosis (reference: report_failures, error_monitor)
# ---------------------------------------------------------------------------


@dataclass
class NodeFailure(Message):
    node_id: int = 0
    node_rank: int = 0
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@dataclass
class DiagnosisData(Message):
    node_id: int = 0
    data_type: str = ""  # "stack" | "log" | "chip_metrics" | "step_time"
    content: str = ""
    timestamp: float = 0.0


# ---------------------------------------------------------------------------
# Node lifecycle / elasticity
# ---------------------------------------------------------------------------


@dataclass
class NodeEventReport(Message):
    node_id: int = 0
    node_type: str = ""
    event_type: str = ""
    status: str = ""
    exit_reason: str = ""


@dataclass
class ReadyToExitRequest(Message):
    node_id: int = 0
    reason: str = ""


@dataclass
class ParallelConfigRequest(Message):
    node_id: int = 0


@dataclass
class ParallelConfig(Message):
    """Runtime-tunable knobs written by master, polled by trainer
    (reference: paral_config_tuner.py ParallelConfig JSON)."""

    dataloader_workers: int = 0
    micro_batch_size: int = 0
    gradient_accumulation: int = 0
    version: int = 0


@dataclass
class ScaleRequest(Message):
    """Request the master to scale the worker group (tests/tools)."""

    node_type: str = "worker"
    count: int = 0


@dataclass
class ResizeRequest(Message):
    """Operator-requested world resize: ask the master's resize
    coordinator to reconverge the job at ``target`` nodes (the manual
    flavour of the alive-count-driven decision; reference: ScalePlan
    CRD written by an operator)."""

    target: int = 0
    reason: str = "operator"


@dataclass
class JobExitRequest(Message):
    reason: str = ""


@dataclass
class SessionResyncRequest(Message):
    """Agent -> recovered master handshake: everything the master
    needs to rebuild this node's live state after a crash/restart —
    identity, incarnation, and the last durable progress marks — so
    healthy trainers keep running instead of being restarted."""

    node_id: int = 0
    node_rank: int = 0
    node_type: str = "worker"
    local_world_size: int = 1
    restart_count: int = 0
    last_step: int = 0
    last_acked_dataset: str = ""
    last_acked_task: int = -1
    # every ack the mirror's group-commit lag could have lost — the
    # single last_acked_* pair (kept for older agents) misses earlier
    # acks when several complete inside one commit window
    recent_acked_tasks: List[Tuple[str, int]] = field(
        default_factory=list
    )


@dataclass
class SessionResyncResponse(Message):
    """``incarnation`` identifies the master process instance; a
    change tells the agent a recovery happened (it logs/emits, it
    does NOT restart healthy workers)."""

    incarnation: str = ""
    rdzv_round: int = 0
    recoveries: int = 0
    success: bool = True


# (node_id, node_type, message) -> response message tuple alias
Request = Tuple[int, str, Message]
