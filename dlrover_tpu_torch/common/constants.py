"""Env-var contract between agent and training process, and the flash
checkpoint's file naming.

Copies of ``NodeEnv`` and ``CheckpointConstant`` from
``dlrover_tpu/common/constants.py``, cut to what the trainer and the
checkpoint read in this slice of the port.
"""


class CheckpointConstant:
    """Flash-checkpoint file naming (reference:
    common/constants.py CheckpointConstant + ckpt_saver commit files)."""

    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_FILE_PREFIX = ".done_"
    MODEL_STATES_NAME = "model_states"
    SAVE_TIMEOUT = 600


class NodeEnv:
    """The agent exports these before spawning training processes; the
    in-process library reads them."""

    JOB_NAME = "DLROVER_JOB_NAME"
    NODE_RANK = "DLROVER_NODE_RANK"
    LOCAL_RANK = "DLROVER_LOCAL_RANK"
    LOCAL_WORLD_SIZE = "DLROVER_LOCAL_WORLD_SIZE"
    RANK = "DLROVER_RANK"
    WORLD_SIZE = "DLROVER_WORLD_SIZE"
    # Restart accounting
    RESTART_COUNT = "DLROVER_RESTART_COUNT"
