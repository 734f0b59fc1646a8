"""Twin of ``tests/test_chaos_e2e.py::test_warm_recovery_cache_hit``
(``:598``) for the port: a SIGKILLed worker under warm restarts and the
job-keyed compile cache recovers with a PROVEN cache hit, and every
assertion reads telemetry alone.  The scenario holds the reference's
invariants with the reference's ceilings: the compile-cache hit, the AOT
hit, retrace + aot under 1.0 s and the death -> first-step cycle under
3.0 s (``DLROVER_CHAOS_RETRACE_CEILING_S``,
``DLROVER_CHAOS_CYCLE_CEILING_S``), and the recovery phases on the
assembled timeline; ``recovery_budgets`` and the report's ``cache=HIT``
line are checked here too.

On the CPU the tiny GPT's step loads no kernel library, so the
``compile_cache`` witness reads ``entries_before == entries_after == 0``:
this twin proves the protocol — the first incarnation writes its step's
entry, keyed; the forkserver template preloads it; the respawn resolves
through it (an ``aot-hit``).  ``chip_smoke.py`` phase 19a proves the hit
over real kernel libraries: GPT-2 small's flash library, built into the
cache by the first incarnation and loaded by the template.
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
    the run's shm segment, which outlives the job by design, is
    unlinked at the end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlwr")
    yield path
    for dirpath, dirs, _files in os.walk(path):
        if "sock" in dirs:
            with harness._patched_env(
                    {"DLROVER_SHARED_DIR": os.path.join(dirpath, "sock")}):
                SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def test_warm_recovery_cache_hit(root):
    report = harness.run_scenario(
        scenarios.warm_recovery_cache_hit(seed=73),
        workdir=os.path.join(root, "run"),
        max_restarts=2,
    )
    assert report.ok, report.summary()
    names = {r.name for r in report.invariants}
    assert {"compile_cache_hit", "aot_cache_hit", "retrace_below[1s]",
            "recovery_cycle_below[3s]",
            "recovery_phases_on_timeline"} <= names
    # the per-cycle budget through the shared ingestion helper
    from dlrover_tpu_torch.telemetry.timeline import recovery_budgets

    budgets = {
        count: phases
        for (_rank, count), phases in recovery_budgets(
            report.events
        ).items()
        if count > 0
    }
    assert budgets, "no recovery budget for the respawned incarnation"
    phases = budgets[min(budgets)]
    assert phases.get("compile_cache_hit") is True
    assert phases.get("compile_cache_status") == "aot-hit"
    assert phases.get("aot_cache_hit") is True
    for phase in ("restore", "retrace", "first_step"):
        assert phase in phases, phases
    # the protocol on the CPU: the first incarnation wrote the entry,
    # the template preloaded it, the respawn resolved through it, and no
    # kernel library was built or loaded on either side
    aot = [e for e in report.events if e.get("type") == "aot_cache"]
    first = [e for e in aot if e.get("restart_count") == 0]
    respawn = [e for e in aot if e.get("restart_count", 0) > 0]
    assert first and first[0]["wrote"] and not first[0]["hit"]
    assert respawn and respawn[0]["hit"] and respawn[0]["preloaded"]
    assert respawn[0]["key"] == first[0]["key"]
    cc = [e for e in report.events if e.get("type") == "compile_cache"
          and e.get("restart_count", 0) > 0]
    assert cc[0]["entries_before"] == cc[0]["entries_after"] == 0
    # and the incident report prints the budget line
    from dlrover_tpu_torch.telemetry import timeline as flight

    text = flight.to_report(report.job_timeline)
    assert "recovery budgets" in text
    assert "cache=HIT" in text
