"""Twin of ``tests/test_chaos_e2e.py::test_serving_fleet_replica_kill``
(tier-1, as the reference) for the port's serving fleet: under live
routed traffic (``fleet.lookup_load.LookupLoadHarness``) against a
3-replica ``ReplicaPool`` of ``python -m dlrover_tpu_torch.serving``
processes fronted by a ``python -m dlrover_tpu_torch.serving.router``
process, replica 0 is SIGKILLed mid-ingest and the router mid-stream.
The router sheds the dead member within the heartbeat window and keeps
answering from the survivors — zero failed and zero stale lookups on the
``serving_route`` windows, zero client-visible failures in the load
aggregate — the respawned router replays its journaled membership to the
identical live routing table without restarting healthy replicas, and
the freshness floor never regresses, with the reference's assertions.
"""

import os
import shutil
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios

pytestmark = pytest.mark.chaos


@pytest.fixture()
def root():
    path = tempfile.mkdtemp(prefix="dlsf")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_serving_fleet_replica_kill(root):
    report = harness.run_serving_fleet_scenario(
        scenarios.serving_fleet_replica_kill(seed=97),
        workdir=os.path.join(root, "run"),
    )
    assert report.ok, report.summary()
    # both seeded kills fired: the replica's ingest hook and the
    # router's route hook
    points = {t[1] for t in report.timeline}
    assert points == {"serving.ingest", "serving.route"}, report.timeline
    # routed windows exist on both sides of the router kill (the
    # respawn resumed emitting), and the fleet's stats windows landed
    # on the assembled timeline's "serving fleet" track
    router_kill_ts = min(
        e["ts"] for e in report.events
        if e.get("type") == "chaos_inject"
        and e.get("point") == "serving.route"
    )
    windows = [
        e for e in report.events if e.get("type") == "serving_route"
    ]
    assert any(e["ts"] < router_kill_ts for e in windows)
    assert any(e["ts"] > router_kill_ts for e in windows)
    assert report.job_timeline is not None
    fleet_slices = [
        s for s in report.job_timeline.slices
        if s.track == "serving fleet"
    ]
    assert fleet_slices, "no serving-fleet slices on the timeline"
    # the load harness's client-side aggregate is in the event log
    # (the zero-client-visible-failure half of the verdict)
    loads = [
        e for e in report.events
        if e.get("type") == "serving_lookup_stats"
        and e.get("replica") == "load"
    ]
    assert loads and loads[0]["failed"] == 0, loads
