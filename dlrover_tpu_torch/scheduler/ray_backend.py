"""Ray cluster substrate: actor-based workers.

Reference: ``RayClient`` (``dlrover/python/scheduler/ray.py:60``) +
the ray scaler/watcher (``master/scaler/ray_scaler.py``,
``master/watcher/ray_watcher.py``): on Ray, a "node" is a named actor
the master creates/kills/polls instead of a k8s pod.  The real ``ray``
import is gated (not part of this image); ``MockRayApi`` carries the
same surface for tests and local development — exactly the mock-first
pattern of the k8s backend (:mod:`dlrover_tpu_torch.scheduler.kubernetes`).

Copy of ``dlrover_tpu/scheduler/ray_backend.py`` (the port imports
nothing of the JAX package); host code, as in the reference. The actors
run the port's launcher, ``python -m dlrover_tpu_torch.run``, where the
reference's run its ``tpurun``.
"""

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class RayApi:
    """Surface both the real and mock backends implement."""

    def create_actor(self, name: str, spec: Dict) -> bool:
        raise NotImplementedError

    def kill_actor(self, name: str) -> bool:
        raise NotImplementedError

    def list_actors(self) -> List[Dict]:
        """[{name, state, labels}] of this job's actors."""
        raise NotImplementedError


class RealRayApi(RayApi):  # pragma: no cover - needs a ray cluster
    def __init__(self):
        import ray  # gated: not in the default image

        self._ray = ray
        if not ray.is_initialized():
            ray.init(address="auto")

    def create_actor(self, name, spec):
        runner = self._ray.remote(
            num_cpus=spec.get("num_cpus", 1),
            resources=spec.get("resources") or None,
        )(_ActorRunner)
        runner.options(name=name, lifetime="detached").remote(spec)
        return True

    def kill_actor(self, name):
        try:
            self._ray.kill(self._ray.get_actor(name))
            return True
        except ValueError:
            return False

    def list_actors(self):
        from ray.util.state import list_actors

        return [
            {
                "name": a.name,
                "state": a.state,
                "labels": {},
            }
            for a in list_actors()
            if a.name
        ]


class _ActorRunner:  # pragma: no cover - body runs inside ray
    """Detached actor hosting one elastic agent."""

    def __init__(self, spec: Dict):
        import subprocess

        self._proc = subprocess.Popen(spec.get("command", ["python", "-m", "dlrover_tpu_torch.run"]))


class MockRayApi(RayApi):
    """In-memory actor registry (tests / local development)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.actors: Dict[str, Dict] = {}
        self.create_calls = 0
        self.kill_calls = 0

    def create_actor(self, name, spec):
        with self._lock:
            self.actors[name] = {
                "name": name, "state": "ALIVE",
                "labels": dict(spec.get("labels", {})),
            }
            self.create_calls += 1
        return True

    def kill_actor(self, name):
        with self._lock:
            self.kill_calls += 1
            actor = self.actors.pop(name, None)
        return actor is not None

    def set_actor_state(self, name: str, state: str):
        with self._lock:
            if name in self.actors:
                self.actors[name]["state"] = state

    def list_actors(self):
        with self._lock:
            return [dict(a) for a in self.actors.values()]


_ACTOR_STATE_TO_NODE = {
    "PENDING_CREATION": NodeStatus.PENDING,
    "ALIVE": NodeStatus.RUNNING,
    "RESTARTING": NodeStatus.PENDING,
    "DEAD": NodeStatus.FAILED,
}


class RayClient:
    """Facade the ray scaler/watcher use (reference: RayClient:60)."""

    def __init__(self, job_name: str, api: Optional[RayApi] = None):
        self.job_name = job_name
        self.api = api or RealRayApi()

    def actor_name(self, node: Node) -> str:
        return f"{self.job_name}-{node.type}-{node.id}"

    def create_node(self, node: Node, command=None) -> bool:
        return self.api.create_actor(
            self.actor_name(node),
            {
                "labels": {
                    "job": self.job_name,
                    "node-id": str(node.id),
                    "node-type": node.type,
                    "rank": str(node.rank_index),
                },
                "command": command or ["python", "-m", "dlrover_tpu_torch.run"],
            },
        )

    def remove_node(self, node: Node) -> bool:
        return self.api.kill_actor(self.actor_name(node))

    def list_nodes(self) -> List[Node]:
        nodes = []
        prefix = f"{self.job_name}-"
        for actor in self.api.list_actors():
            name = actor.get("name", "")
            if not name.startswith(prefix):
                continue
            labels = actor.get("labels", {})
            try:
                node_id = int(labels.get(
                    "node-id", name.rsplit("-", 1)[-1]
                ))
            except ValueError:
                continue
            nodes.append(Node(
                type=labels.get("node-type", "worker"),
                id=node_id,
                rank_index=int(labels.get("rank", node_id)),
                name=name,
                status=_ACTOR_STATE_TO_NODE.get(
                    actor.get("state", ""), NodeStatus.PENDING
                ),
            ))
        return nodes


class RayScaler:
    """Executes ScalePlans as actor create/kill (reference:
    ray_scaler.py:134)."""

    def __init__(self, client: RayClient):
        self._client = client

    def start(self):
        pass

    def stop(self):
        pass

    def scale(self, plan):
        for node in plan.launch_nodes:
            if not self._client.create_node(node):
                logger.warning(
                    "ray actor create failed for node %s", node.id
                )
        for node in plan.remove_nodes:
            self._client.remove_node(node)


class RayWatcher:
    """Polls actor states into NodeEvents (reference:
    ray_watcher.py; Ray has no watch stream, so this polls)."""

    POLL_INTERVAL = 2.0

    def __init__(self, client: RayClient, event_handler):
        self._client = client
        self._handler = event_handler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last: Dict[int, str] = {}

    def list_nodes(self) -> List[Node]:
        return self._client.list_nodes()

    def poll_once(self):
        from dlrover_tpu_torch.common.constants import NodeEventType
        from dlrover_tpu_torch.common.node import NodeEvent

        seen = {}
        for node in self._client.list_nodes():
            seen[node.id] = node.status
            if self._last.get(node.id) != node.status:
                self._handler(NodeEvent(
                    NodeEventType.MODIFIED, node
                ))
        for node_id, status in self._last.items():
            if node_id not in seen and status != NodeStatus.FAILED:
                dead = Node(
                    type="worker", id=node_id, rank_index=node_id,
                    status=NodeStatus.FAILED,
                )
                dead.exit_reason = "actor-gone"
                from dlrover_tpu_torch.common.constants import (
                    NodeEventType,
                )
                from dlrover_tpu_torch.common.node import NodeEvent

                self._handler(NodeEvent(NodeEventType.DELETED, dead))
        self._last = seen

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ray-watcher"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.POLL_INTERVAL):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001
                logger.exception("ray watch poll failed")
