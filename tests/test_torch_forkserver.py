"""Twins of ``tests/test_forkserver.py`` for the port's warm fork
server: spawn mechanics, recovery boost, late-spawn reaping, exit
bookkeeping across template rebuilds and pid recycling.  One case more
than the reference's: a template that preloads torch and the port's
trainer modules never initialises ``torch.cuda``, so a forked worker
makes its own CUDA context (a child cannot use its parent's).  Every
check is exact."""

import os
import signal
import subprocess
import sys
import time

import pytest

from dlrover_tpu_torch.agent.forkserver import WorkerForkServer


@pytest.fixture
def srv():
    s = WorkerForkServer(preload="")
    yield s
    s.close()


def _wait_file(path, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.05)
    return False


def test_spawn_runs_script_and_reports_exit(srv, tmp_path):
    out = tmp_path / "out.txt"
    script = tmp_path / "w.py"
    script.write_text(
        f"open({str(out)!r}, 'w').write('ran')\n"
    )
    h = srv.spawn([str(script)], {}, timeout=30.0)
    assert _wait_file(str(out))
    deadline = time.time() + 20
    while time.time() < deadline and srv.exit_code(h.pid) is None:
        time.sleep(0.05)
    assert srv.exit_code(h.pid) == 0


def test_nice_boost_applied_then_reverted(srv, tmp_path):
    """A respawn with nice_boost starts at the boosted priority (the
    recovery window must not be starved by host load) and returns to
    normal after the window."""
    out = tmp_path / "prio.txt"
    script = tmp_path / "w.py"
    script.write_text(
        "import os, threading, time\n"
        "p0 = os.getpriority(os.PRIO_PROCESS, 0)\n"
        "res = {}\n"
        "def worker_thread():\n"
        "    # created DURING the boost (like XLA's pools): inherits\n"
        "    # the boost and must be reverted with the main thread\n"
        "    res['t0'] = os.getpriority(os.PRIO_PROCESS, 0)\n"
        "    time.sleep(2.0)\n"
        "    res['t1'] = os.getpriority(os.PRIO_PROCESS, 0)\n"
        "t = threading.Thread(target=worker_thread)\n"
        "t.start()\n"
        "time.sleep(2.0)\n"
        "p1 = os.getpriority(os.PRIO_PROCESS, 0)\n"
        "t.join()\n"
        # write-to-temp + rename: the parent polls for the file and a
        # non-atomic write races its read on a loaded box
        f"open({str(out)!r} + '.tmp', 'w').write(\n"
        "    f'{p0} {p1} {res[\"t0\"]} {res[\"t1\"]}')\n"
        f"os.replace({str(out)!r} + '.tmp', {str(out)!r})\n"
    )
    h = srv.spawn(
        [str(script)], {}, timeout=30.0,
        nice_boost={"nice": -5, "seconds": 0.5},
    )
    assert _wait_file(str(out), timeout=30.0)
    p0, p1, t0, t1 = map(int, out.read_text().split())
    can_boost = True
    try:
        os.setpriority(os.PRIO_PROCESS, 0, -5)
        os.setpriority(os.PRIO_PROCESS, 0, 0)
    except (OSError, PermissionError):
        can_boost = False
    if can_boost:
        assert p0 == -5 and t0 == -5, (p0, p1, t0, t1)
        # boost is BOUNDED for every thread, not just main (nice is
        # per-thread on Linux)
        assert p1 == 0 and t1 == 0, (p0, p1, t0, t1)
    else:  # unprivileged: boost silently skipped
        assert p0 == p1 == t0 == t1 == 0
    # reap
    deadline = time.time() + 10
    while time.time() < deadline and srv.exit_code(h.pid) is None:
        time.sleep(0.05)


def test_spawn_timeout_reaps_late_worker(srv, tmp_path):
    """A spawn that times out marks its request abandoned; when the
    template delivers the fork late, the reader thread kills it —
    no orphan worker, no stale result entry (ADVICE r4)."""
    # a name of its own: the reference's twin of this test greps for
    # "sleeper.py" and may run at the same time in another worker
    script = tmp_path / "port_late_idler.py"
    script.write_text("import time\ntime.sleep(600)\n")
    h = srv.spawn([str(script)], {}, timeout=30.0)  # warm the template
    os.kill(h.pid, signal.SIGKILL)

    # freeze the template so the next request sits undelivered
    os.kill(srv._proc.pid, signal.SIGSTOP)
    with pytest.raises(RuntimeError):
        srv.spawn([str(script)], {}, timeout=0.7)
    os.kill(srv._proc.pid, signal.SIGCONT)  # late fork happens now
    deadline = time.time() + 10
    while time.time() < deadline:
        with srv._lock:
            if not srv._abandoned and not srv._spawn_results:
                break
        time.sleep(0.1)
    with srv._lock:
        assert not srv._spawn_results
        assert not srv._abandoned
    # the late-arriving worker was killed, not leaked: no process
    # besides this one references the idler script
    out = subprocess.run(
        ["pgrep", "-f", "port_late_idler.py"], capture_output=True,
        text=True
    )
    pids = [p for p in out.stdout.split() if int(p) != os.getpid()]
    for p in list(pids):
        # a just-killed pid may linger as a zombie for a beat
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().split()[2] == "Z":
                    pids.remove(p)
        except OSError:
            pids.remove(p)
    assert not pids, pids


def test_exit_tracking_survives_template_rebuild(srv, tmp_path):
    """A worker forked by an OLD template generation must not poll
    alive forever after close()+rebuild: the new template never
    reports the old pid, so liveness falls back to a direct probe."""
    script = tmp_path / "sleeper2.py"
    script.write_text("import time\ntime.sleep(600)\n")
    h_old = srv.spawn([str(script)], {}, timeout=30.0)
    srv.close()                     # old template (and its events) gone
    h_new = srv.spawn([str(script)], {}, timeout=30.0)  # rebuilds
    assert srv.exit_code(h_old.pid) is None  # still actually running
    os.kill(h_old.pid, signal.SIGKILL)
    deadline = time.time() + 15
    code = None
    while time.time() < deadline:
        code = srv.exit_code(h_old.pid)
        if code is not None:
            break
        time.sleep(0.1)
    assert code is not None, (
        "old-generation worker's death was never observed"
    )
    os.kill(h_new.pid, signal.SIGKILL)


def test_exit_bookkeeping_pruned_after_consumption(srv, tmp_path):
    """A long-lived elastic agent respawns workers every round; the
    per-pid bookkeeping must be pruned once a handle consumed the
    exit code, or the server grows without bound across rounds."""
    script = tmp_path / "quick.py"
    script.write_text("pass\n")
    handles = [srv.spawn([str(script)], {}, timeout=30.0)
               for _ in range(3)]
    for h in handles:
        assert h.wait(timeout=20.0) == 0
    # the handle keeps answering from its local cache...
    for h in handles:
        assert h.poll() == 0
    # ...while the server-side maps are empty again
    assert srv._exits == {}
    assert srv._pid_generation == {}
    assert srv._pid_start == {}
    assert srv._spawned == []


def test_pid_recycle_guard_uses_start_time(srv, tmp_path):
    """The stale-generation liveness probe must not trust a bare
    pid-exists check: after pid wraparound an unrelated process can
    hold the number.  A recorded spawn start time that no longer
    matches /proc/<pid>/stat means OUR worker exited."""
    script = tmp_path / "sleeper3.py"
    script.write_text("import time\ntime.sleep(600)\n")
    h = srv.spawn([str(script)], {}, timeout=30.0)
    # sanity: the real start time was recorded and matches
    assert srv._pid_start[h.pid] == srv._proc_start_time(h.pid)
    # simulate recycling: mark the generation stale (forcing the
    # direct probe) and make the recorded start time disagree with
    # the live process at this pid
    with srv._lock:
        srv._pid_generation[h.pid] = srv._generation - 1
        srv._pid_start[h.pid] = 1  # no real process started at tick 1
    assert srv.exit_code(h.pid) == -1  # treated as exited
    os.kill(h.pid, signal.SIGKILL)


@pytest.mark.chaos
def test_rapid_kill_respawn_prunes_bookkeeping(srv, tmp_path):
    """ISSUE 2 satellite: hammer the spawn path with the chaos kill
    primitive — every round SIGKILLs the fresh worker immediately and
    respawns.  Across rounds (1) every recorded spawn start time
    matches the live /proc snapshot (the pid-reuse guard's raw
    material stays truthful), (2) consuming the exit prunes ALL
    per-pid maps, so a long-lived agent cannot accumulate an entry per
    incarnation, and (3) no round's death is ever missed."""
    from dlrover_tpu_torch.chaos import kill_process

    script = tmp_path / "victim.py"
    script.write_text("import time\ntime.sleep(600)\n")
    seen_pids = []
    for _ in range(5):
        h = srv.spawn([str(script)], {}, timeout=30.0)
        seen_pids.append(h.pid)
        # start-time bookkeeping recorded and truthful at spawn
        assert srv._pid_start[h.pid] == srv._proc_start_time(h.pid)
        assert kill_process(h.pid, signal.SIGKILL)
        code = h.wait(timeout=20.0)  # death observed, never missed
        assert code is not None and code != 0
        # the handle consumed the exit: per-pid maps fully pruned
        with srv._lock:
            assert h.pid not in srv._exits
            assert h.pid not in srv._pid_generation
            assert h.pid not in srv._pid_start
            assert h.pid not in srv._spawned
    # after the storm the server is byte-for-byte back to empty
    with srv._lock:
        assert srv._exits == {}
        assert srv._pid_generation == {}
        assert srv._pid_start == {}
        assert srv._spawned == []
    # a recycled-looking pid (stale generation + mismatched start
    # time) is reported dead instead of trusted as alive
    h = srv.spawn([str(script)], {}, timeout=30.0)
    with srv._lock:
        srv._pid_generation[h.pid] = srv._generation - 1
        srv._pid_start[h.pid] = 1
    assert srv.exit_code(h.pid) == -1
    kill_process(h.pid, signal.SIGKILL)


def test_proc_start_time_none_for_dead_pid(srv, tmp_path):
    script = tmp_path / "quick2.py"
    script.write_text("pass\n")
    h = srv.spawn([str(script)], {}, timeout=30.0)
    assert h.wait(timeout=20.0) == 0
    assert isinstance(srv._proc_start_time(os.getpid()), int)
    deadline = time.time() + 10
    while time.time() < deadline:
        if srv._proc_start_time(h.pid) is None:
            break
        time.sleep(0.05)  # template may not have reaped the zombie yet
    assert srv._proc_start_time(h.pid) is None


def test_template_preloads_torch_without_touching_cuda(tmp_path):
    """The worker is a fork of the template, so what the worker sees
    before it runs anything is the template's state: torch and the
    trainer modules are imported, ``torch.cuda`` is not initialised,
    and no step cache is armed."""
    from dlrover_tpu_torch.agent.forkserver import TRAINER_PRELOAD

    out = tmp_path / "state.json"
    script = tmp_path / "probe.py"
    script.write_text(
        "import json, os, sys\n"
        "mods = sorted(m for m in sys.modules if m == 'torch' or\n"
        "              m.startswith('dlrover_tpu_torch.'))\n"
        "torch = sys.modules['torch']\n"
        "state = {'mods': mods,\n"
        "         'cuda_initialized': torch.cuda.is_initialized(),\n"
        "         'jax': [m for m in sys.modules if m.startswith('jax')]}\n"
        f"open({str(out)!r} + '.tmp', 'w').write(json.dumps(state))\n"
        f"os.replace({str(out)!r} + '.tmp', {str(out)!r})\n"
    )
    srv = WorkerForkServer(preload=TRAINER_PRELOAD)
    try:
        h = srv.spawn([str(script)], {}, timeout=120.0)
        assert h.wait(timeout=60.0) == 0
    finally:
        srv.close()
    import json

    state = json.loads(out.read_text())
    assert "torch" in state["mods"]
    for mod in TRAINER_PRELOAD.split(","):
        if mod.startswith("dlrover_tpu_torch."):
            assert mod in state["mods"], mod
    assert state["cuda_initialized"] is False
    assert state["jax"] == []
