"""Framework-wide constants and the environment-variable contract.

Copy of ``dlrover_tpu/common/constants.py`` (the port imports nothing
of the JAX package).

Mirrors the role of ``dlrover/python/common/constants.py`` in the
reference (NodeType/NodeStatus/RendezvousName/NodeEnv/...), re-targeted
at TPU pod slices: accelerator types are TPU generations, the
communication fabric is ICI/DCN rather than NCCL, and the env contract
feeds ``jax.distributed.initialize`` instead of ``torch.distributed``.
The port keeps every name and value; there the coordinator address of
the env contract is the ``torch.distributed`` rendezvous address.
"""


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    # Parameter-server style roles kept for sparse/PS-parity jobs
    # (reference: common/constants.py NodeType).
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"
    UNKNOWN = "unknown"

    @classmethod
    def end_states(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    """Classified exit reasons (reference: k8s_watcher exit-reason
    classification + common/constants.py NodeExitReason)."""

    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    PREEMPTED = "preempted"          # TPU/GCE preemption signal
    RELAUNCHED = "relaunched"
    UNKNOWN = "unknown"


class RendezvousName:
    ELASTIC_TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class Accelerators:
    """TPU generations plus CPU for local testing.

    Reference keys NVIDIA_GPU/ASCEND_NPU (common/constants.py) become
    TPU generations; the health-check payload and mesh topology depend
    on this.
    """

    TPU_V4 = "tpu-v4"
    TPU_V5E = "tpu-v5e"
    TPU_V5P = "tpu-v5p"
    TPU_V6E = "tpu-v6e"
    CPU = "cpu"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class ErrorMonitorConstants:
    TYPE_INFO = "info"
    TYPE_WARN = "warn"
    TYPE_ERROR = "error"
    ACTION_RELAUNCH = "relaunch"
    ACTION_ABORT = "abort"
    ACTION_ISOLATE = "isolate"
    ACTION_NONE = "none"


class MasterAction:
    """Actions the master piggybacks on a heartbeat ack for the agent
    to execute (the diagnosis chain's culprit-only relaunch path and
    the elastic world-resize drain)."""

    RESTART_WORKERS = "restart_workers"
    # elastic world-resize: stop the local workers and re-join the
    # rendezvous so the job reconverges at the master's new target
    # world size (a planned drain, not a failure — no restart budget)
    RESIZE = "resize"


class CheckpointConstant:
    """Flash-checkpoint file naming (reference:
    common/constants.py CheckpointConstant + ckpt_saver commit files)."""

    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_FILE_PREFIX = ".done_"
    MODEL_STATES_NAME = "model_states"
    SAVE_TIMEOUT = 600


class JobExitReason:
    SUCCEEDED = "succeeded"
    CODE_ERROR = "code_error"
    HANG_ERROR = "hang_error"
    RDZV_ERROR = "rdzv_error"
    UNKNOWN_ERROR = "unknown_error"


class NodeEnv:
    """Env-var contract between agent and training process.

    The agent exports these before spawning training processes; the
    in-process library reads them.  Reference: common/constants.py
    NodeEnv (DLROVER_MASTER_ADDR, NODE_RANK, ...), retargeted so that
    training processes can call ``jax.distributed.initialize`` with the
    coordinator negotiated through the master rendezvous.
    """

    MASTER_ADDR = "DLROVER_MASTER_ADDR"
    JOB_NAME = "DLROVER_JOB_NAME"
    NODE_ID = "DLROVER_NODE_ID"
    NODE_RANK = "DLROVER_NODE_RANK"
    NODE_NUM = "DLROVER_NODE_NUM"
    # the coordinates of the process group (torch.distributed in the
    # port), set by the agent after rendezvous.
    COORDINATOR_ADDR = "DLROVER_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_NUM_PROCESSES"
    LOCAL_RANK = "DLROVER_LOCAL_RANK"
    LOCAL_WORLD_SIZE = "DLROVER_LOCAL_WORLD_SIZE"
    RANK = "DLROVER_RANK"
    WORLD_SIZE = "DLROVER_WORLD_SIZE"
    # Restart accounting
    RESTART_COUNT = "DLROVER_RESTART_COUNT"
    # Fault injection for tests (reference: node_check/utils.py
    # MOCK_ERR_RANK mock_error()).
    MOCK_ERR_RANK = "MOCK_ERR_RANK"
    # Monitoring
    MONITOR_ENABLED = "DLROVER_MONITOR_ENABLED"
    # Paral-config file path for runtime auto-tuning
    PARAL_CONFIG_PATH = "DLROVER_PARAL_CONFIG_PATH"
    # Accelerator type (Accelerators.*)
    ACCELERATOR = "DLROVER_ACCELERATOR"


class GRPC:
    """Transport limits for the master<->agent message channel."""

    MAX_MESSAGE_BYTES = 512 * 1024 * 1024


class RendezvousConstant:
    DEFAULT_TIMEOUT = 600
    WAITING_TIMEOUT = 60
    JOIN_INTERVAL = 3


class NetworkCheckConstant:
    # Straggler rule: elapsed > STRAGGLER_FACTOR * median
    # (reference: rdzv_manager.py:550-565 _detect_stragglers).
    STRAGGLER_FACTOR = 2.0
    MAX_CHECK_ROUNDS = 2
    CHECK_TIMEOUT = 300


class TrainingLoopConstant:
    # Seconds without a step report before the master calls the
    # job hung (reference: dist_master.py:242-248, global_context).
    HANG_TIMEOUT = 1800


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "kubernetes"
    RAY = "ray"


class DistributionStrategy:
    ALLREDUCE = "AllreduceStrategy"  # SPMD data-parallel family
    PS = "ParameterServerStrategy"
    LOCAL = "Local"


class ReporterType:
    LOG = "log"
    MASTER = "master"


class TaskType:
    """Dynamic data-sharding task types (reference:
    elastic_training.proto TaskType + shard managers)."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class DefaultPorts:
    MASTER = 51051
    COORDINATOR = 52525
