"""Node status FSM.

Copy of ``dlrover_tpu/master/status_flow.py`` (the port imports
nothing of the JAX package).

Reference: ``NodeStateFlow`` (``dlrover/python/master/node/
status_flow.py:136``): the master only applies status transitions that
are legal for the lifecycle (initial->pending->running->end states),
so stale watcher events cannot move a node backwards.
"""

from dataclasses import dataclass
from typing import Optional, Set

from dlrover_tpu_torch.common.constants import NodeStatus

# legal (from -> to) edges; '*' matches any source
_EDGES: Set = {
    (NodeStatus.INITIAL, NodeStatus.PENDING),
    (NodeStatus.INITIAL, NodeStatus.RUNNING),
    (NodeStatus.INITIAL, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.RUNNING),
    (NodeStatus.PENDING, NodeStatus.SUCCEEDED),
    (NodeStatus.PENDING, NodeStatus.FAILED),
    (NodeStatus.PENDING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.SUCCEEDED),
    (NodeStatus.RUNNING, NodeStatus.FAILED),
    (NodeStatus.RUNNING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.BREAKDOWN),
    (NodeStatus.SUCCEEDED, NodeStatus.DELETED),
    (NodeStatus.FAILED, NodeStatus.DELETED),
    (NodeStatus.BREAKDOWN, NodeStatus.DELETED),
    (NodeStatus.UNKNOWN, NodeStatus.RUNNING),
    (NodeStatus.UNKNOWN, NodeStatus.FAILED),
    (NodeStatus.UNKNOWN, NodeStatus.DELETED),
}


def can_transition(from_status: str, to_status: str) -> bool:
    if from_status == to_status:
        return False
    return (from_status, to_status) in _EDGES


def apply_transition(node, to_status: str) -> bool:
    """Apply if legal; returns whether the node changed."""
    if not can_transition(node.status, to_status):
        return False
    node.update_status(to_status)
    return True
