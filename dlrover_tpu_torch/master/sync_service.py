"""Worker synchronization barriers + elastic PS version negotiation.

Copy of ``dlrover_tpu/master/sync_service.py`` (the port imports
nothing of the JAX package).

Reference: ``SyncService`` (``dlrover/python/master/elastic_training/
sync_service.py:119``) — named join/finish barriers workers use to
align phase changes — and ``ElasticPsService`` (``elastic_ps.py``) —
a monotonically increasing PS-cluster version workers poll so that all
of them swap to the new parameter-server membership together.  On TPU
the "PS version" doubles as the *mesh epoch*: every elastic resize
bumps it, and stragglers detect they must re-initialize their runtime.
"""

import threading
import time
from typing import Dict, Optional, Set

from dlrover_tpu_torch.common.log import default_logger as logger


class SyncService:
    def __init__(self):
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()

    def join_sync(self, name: str, node_id: int, world: Set[int]) -> bool:
        """Join barrier ``name``; returns True once every node in
        ``world`` joined."""
        with self._lock:
            members = self._syncs.setdefault(name, set())
            members.add(node_id)
            done = world.issubset(members)
            if done:
                self._finished.add(name)
            return done

    def sync_finished(self, name: str) -> bool:
        with self._lock:
            return name in self._finished

    def barrier(self, name: str, node_id: int, world: Set[int],
                timeout: float = 300.0, poll: float = 0.1) -> bool:
        deadline = time.time() + timeout
        self.join_sync(name, node_id, world)
        while time.time() < deadline:
            if self.sync_finished(name):
                return True
            time.sleep(poll)
        return False

    def remove_node(self, node_id: int):
        """A dead node cannot block barriers forever."""
        with self._lock:
            for members in self._syncs.values():
                members.discard(node_id)


class ElasticPsService:
    """Cluster-membership version (PS parity / mesh epoch)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._version = 0
        self._ready_nodes: Set[int] = set()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def bump_version(self) -> int:
        """Called on every elastic resize (reference: PS cluster
        update on scale events)."""
        with self._lock:
            self._version += 1
            self._ready_nodes.clear()
            logger.info("cluster version -> %s", self._version)
            return self._version

    def report_ready(self, node_id: int, version: int) -> bool:
        """Worker acks it runs at ``version``; True if current."""
        with self._lock:
            if version != self._version:
                return False
            self._ready_nodes.add(node_id)
            return True

    def all_ready(self, world: Set[int]) -> bool:
        with self._lock:
            return world.issubset(self._ready_nodes)
