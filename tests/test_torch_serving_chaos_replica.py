"""Twin of ``tests/test_chaos_e2e.py::test_serving_replica_kill_midingest``
(tier-1, as the reference) for the port's serving plane: the real
supervision tree (``dlrover_tpu_torch.run``'s launcher in-process, a
local master child) trains the port's train-to-serve loop
(``SPARSE_SERVING_TRAIN_SCRIPT``: the sparse DeepFM on the CPU plus an
``EmbeddingPublisher``), while a supervised ``python -m
dlrover_tpu_torch.serving`` replica ingests its generations under lookup
traffic.  The replica is SIGKILLed INSIDE a generation apply; the
respawned replica re-bases from the newest committed generation and
converges, and the ``serving_ingest``/``serving_publish`` digests prove
that no torn or uncommitted generation was ever served — all decided
from the event log, with the reference's assertions.
"""

import os
import shutil
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

pytestmark = pytest.mark.chaos


@pytest.fixture()
def root(monkeypatch):
    """A short work root (a unix socket path holds at most 107 bytes);
    the run's shm segment, named after its socket dir, is unlinked at
    the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlsr")
    yield path
    for dirpath, dirnames, _ in os.walk(path):
        for d in dirnames:
            if d.startswith("sock"):
                with harness._patched_env(
                        {"DLROVER_SHARED_DIR": os.path.join(dirpath, d)}):
                    SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def test_serving_replica_kill_midingest(root):
    report = harness.run_serving_scenario(
        scenarios.serving_replica_kill_midingest(seed=83),
        workdir=os.path.join(root, "run"),
        monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    # exactly one seeded kill, inside the replica's ingest hook
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, _step = report.timeline[0]
    assert point == "serving.ingest" and action == "kill"
    # the generation being applied at the kill emitted NO ingest event
    # from the first replica life (the event is post-apply): every
    # recorded ingest digest-matches its publish, and the respawned
    # replica's trail starts with a base
    ingests = [
        e for e in report.events if e.get("type") == "serving_ingest"
    ]
    respawned = [e for e in ingests if e.get("respawned")]
    assert respawned and respawned[0]["kind"] == "base"
    # lookup traffic ran, and freshness was measured
    lookups = [
        e for e in report.events
        if e.get("type") == "serving_lookup_stats"
    ]
    assert lookups and all(e["p99_ms"] > 0 for e in lookups)
    fresh = [
        e for e in report.events if e.get("type") == "serving_freshness"
    ]
    assert fresh, "no serving_freshness events"
