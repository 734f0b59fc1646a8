"""Twins of ``tests/test_ray_backend.py`` for the port's Ray substrate
(``dlrover_tpu_torch/scheduler/ray_backend.py``): the actor-based scaler
and watcher, run through both packages over their own ``MockRayApi``,
with the actors, node states and watcher events held equal to the
reference's (the actors' launcher command names each package's own).
``ray`` itself is imported lazily, as in the reference, and is absent
here."""

from dlrover_tpu.common.node import new_worker as j_worker
from dlrover_tpu.master.scaler import ScalePlan as JPlan
from dlrover_tpu.scheduler import ray_backend as j_ray
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.node import new_worker
from dlrover_tpu_torch.master.scaler import ScalePlan
from dlrover_tpu_torch.scheduler import ray_backend as p_ray
from dlrover_tpu_torch.scheduler.ray_backend import (
    MockRayApi,
    RayClient,
    RayScaler,
    RayWatcher,
)

PACKAGES = {"port": (p_ray, ScalePlan, new_worker),
            "ref": (j_ray, JPlan, j_worker)}


def _nodes(client):
    return sorted((n.id, n.type, n.status, n.rank_index)
                  for n in client.list_nodes())


def _actors(api):
    return {name: {k: v for k, v in spec.items() if k != "command"}
            for name, spec in api.actors.items()}


def test_ray_scaler_creates_and_kills_actors():
    api = MockRayApi()
    client = RayClient("rj", api=api)
    scaler = RayScaler(client)
    scaler.scale(ScalePlan(
        launch_nodes=[new_worker(0, rank=0), new_worker(1, rank=1)]
    ))
    assert set(api.actors) == {"rj-worker-0", "rj-worker-1"}
    nodes = client.list_nodes()
    assert {n.id for n in nodes} == {0, 1}
    assert all(n.status == NodeStatus.RUNNING for n in nodes)
    scaler.scale(ScalePlan(remove_nodes=[new_worker(1, rank=1)]))
    assert set(api.actors) == {"rj-worker-0"}

    def run(mod, plan, worker):
        api = mod.MockRayApi()
        client = mod.RayClient("rj", api=api)
        scaler = mod.RayScaler(client)
        scaler.scale(plan(launch_nodes=[worker(0, rank=0),
                                        worker(1, rank=1)]))
        seen = [_actors(api), _nodes(client)]
        scaler.scale(plan(remove_nodes=[worker(1, rank=1)]))
        return seen + [_actors(api), _nodes(client)]

    assert run(*PACKAGES["port"]) == run(*PACKAGES["ref"])


def test_ray_watcher_emits_state_changes():
    api = MockRayApi()
    client = RayClient("rj", api=api)
    events = []
    watcher = RayWatcher(client, events.append)
    RayScaler(client).scale(
        ScalePlan(launch_nodes=[new_worker(0, rank=0)])
    )
    watcher.poll_once()
    assert len(events) == 1
    assert events[0].node.status == NodeStatus.RUNNING
    api.set_actor_state("rj-worker-0", "DEAD")
    watcher.poll_once()
    assert events[-1].node.status == NodeStatus.FAILED
    api.set_actor_state("rj-worker-0", "ALIVE")
    watcher.poll_once()
    api.actors.clear()
    watcher.poll_once()
    assert events[-1].node.exit_reason == "actor-gone"
    assert events[-1].node.status == NodeStatus.FAILED

    def run(mod, plan, worker):
        api = mod.MockRayApi()
        client = mod.RayClient("rj", api=api)
        events = []
        watcher = mod.RayWatcher(client, events.append)
        mod.RayScaler(client).scale(plan(launch_nodes=[worker(0, rank=0)]))
        for state in (None, "DEAD", "ALIVE", "gone"):
            if state == "gone":
                api.actors.clear()
            elif state:
                api.set_actor_state("rj-worker-0", state)
            watcher.poll_once()
        return [(e.event_type, e.node.id, e.node.status,
                 e.node.exit_reason) for e in events]

    assert run(*PACKAGES["port"]) == run(*PACKAGES["ref"])
