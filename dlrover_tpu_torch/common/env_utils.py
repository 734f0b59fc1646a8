"""Env accessors for the agent<->trainer contract.

Copy of ``get_node_rank``, ``get_world_size`` and
``get_restart_count`` from ``dlrover_tpu/common/env_utils.py``.
"""

import os

from dlrover_tpu_torch.common.constants import NodeEnv


def _get_int(name: str, default: int = 0) -> int:
    try:
        return int(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


def get_node_rank() -> int:
    return _get_int(NodeEnv.NODE_RANK)


def get_world_size() -> int:
    return _get_int(NodeEnv.WORLD_SIZE, 1)


def get_restart_count() -> int:
    return _get_int(NodeEnv.RESTART_COUNT)
