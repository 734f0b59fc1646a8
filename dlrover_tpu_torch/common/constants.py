"""Env-var contract between agent and training process.

Copy of ``NodeEnv`` from ``dlrover_tpu/common/constants.py``, cut to
what the trainer reads in this slice of the port.
"""


class NodeEnv:
    """The agent exports these before spawning training processes; the
    in-process library reads them."""

    NODE_RANK = "DLROVER_NODE_RANK"
    WORLD_SIZE = "DLROVER_WORLD_SIZE"
    # Restart accounting
    RESTART_COUNT = "DLROVER_RESTART_COUNT"
