"""Node models shared by master components.

Copy of ``dlrover_tpu/common/node.py`` (the port imports nothing of
the JAX package).

Role of ``dlrover/python/common/node.py``: the master's in-memory view
of each node (status, resources, rank, restart accounting) plus the
group-resource description used by scale plans.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeStatus


@dataclass
class NodeResource:
    cpu: float = 0.0
    memory_mb: float = 0.0
    # GPUs attached to this host (an H100 node: 8)
    chips: int = 0
    chip_type: str = ""

    def to_dict(self) -> Dict:
        return {
            "cpu": self.cpu,
            "memory_mb": self.memory_mb,
            "chips": self.chips,
            "chip_type": self.chip_type,
        }


@dataclass
class NodeGroupResource:
    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)


@dataclass
class Node:
    type: str = "worker"
    id: int = 0
    rank_index: int = 0
    name: str = ""
    status: str = NodeStatus.INITIAL
    config_resource: NodeResource = field(default_factory=NodeResource)
    used_resource: NodeResource = field(default_factory=NodeResource)
    host_ip: str = ""
    create_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    exit_reason: str = ""
    relaunch_count: int = 0
    max_relaunch_count: int = 3
    relaunchable: bool = True
    critical: bool = False
    is_released: bool = False
    heartbeat_time: float = 0.0
    # elapsed time reported by the node health check
    check_elapsed: float = 0.0

    def update_status(self, status: str):
        self.status = status
        if status == NodeStatus.RUNNING and not self.start_time:
            self.start_time = time.time()
        if status in NodeStatus.end_states():
            self.finish_time = time.time()

    def is_alive(self) -> bool:
        return self.status in (NodeStatus.PENDING, NodeStatus.RUNNING)

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def exceeded_max_relaunch(self) -> bool:
        return self.relaunch_count >= self.max_relaunch_count


@dataclass
class NodeEvent:
    event_type: str
    node: Node


def new_worker(node_id: int, rank: int = -1, chips: int = 0) -> Node:
    return Node(
        type="worker",
        id=node_id,
        rank_index=rank if rank >= 0 else node_id,
        name=f"worker-{node_id}",
        create_time=time.time(),
        config_resource=NodeResource(chips=chips),
    )
