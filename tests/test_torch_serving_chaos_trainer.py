"""Twin of ``tests/test_chaos_e2e.py::test_serving_trainer_kill_midpublish``
(tier-1, as the reference) for the port's serving plane: the trainer of
the port's train-to-serve loop is SIGKILLed between a generation's
blobs/manifest and its ``DONE`` marker.  The half-published generation
never commits (the replica keeps serving the previous one), the
respawned trainer restores from the flash checkpoint and re-bases at a
fresh number, and every committed generation carries exactly one
``serving_publish`` event — with the restored loss trajectory still equal
to the uninterrupted control and the serving slices on the assembled
timeline, as the reference asserts.
"""

import os
import shutil
import tempfile

import pytest

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.telemetry.timeline import CAT_SERVING

pytestmark = pytest.mark.chaos


@pytest.fixture()
def root(monkeypatch):
    """A short work root (a unix socket path holds at most 107 bytes);
    the run's shm segment, named after its socket dir, is unlinked at
    the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlst")
    yield path
    for dirpath, dirnames, _ in os.walk(path):
        for d in dirnames:
            if d.startswith("sock"):
                with harness._patched_env(
                        {"DLROVER_SHARED_DIR": os.path.join(dirpath, d)}):
                    SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def test_serving_trainer_kill_midpublish(root):
    report = harness.run_serving_scenario(
        scenarios.serving_trainer_kill_midpublish(seed=89),
        workdir=os.path.join(root, "run"),
        monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, _step = report.timeline[0]
    assert point == "serving.publish" and action == "kill"
    # the replacement's first publish after the fault is a BASE (a
    # fresh publisher cannot know what its predecessor half-wrote)
    fault_ts = min(
        e["ts"] for e in report.events if e.get("type") == "chaos_inject"
    )
    post = [
        e for e in report.events
        if e.get("type") == "serving_publish" and e["ts"] >= fault_ts
    ]
    assert post and post[0]["kind"] == "base", post[:2]
    # serving slices landed on the assembled timeline (the flight
    # recorder's "serving" track)
    assert report.job_timeline is not None
    serving_slices = report.job_timeline.slices_by_cat(CAT_SERVING)
    assert serving_slices, "no serving slices on the timeline"
