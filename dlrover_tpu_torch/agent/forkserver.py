"""Warm-template worker spawner (fork server).

Restart latency is the dominant term of goodput under churn: a cold
``python script.py`` pays seconds of interpreter + torch imports
before the first restored step.  The fork server keeps a TEMPLATE
process parked after pre-importing the heavy module set — crucially
WITHOUT touching the device: no torch op runs in the template and it
never initialises ``torch.cuda``, so every forked child makes its own
CUDA context (a child cannot use a context its parent made) and no
OpenMP or intra-op thread pool was started before the fork (a pool
used before ``fork`` can deadlock the child) — and every (re)start
forks the template and runs the entrypoint in the child via
``runpy``.

Reference analog: the elastic agent's worker respawn path
(``dlrover/python/elastic_agent/torch/training.py``) — torch keeps
respawn cheap with persistent workers; here the lever is amortizing
import cost across incarnations.

Copy of ``dlrover_tpu/agent/forkserver.py``.  The reference's template
imports JAX and pushes the compile-cache env into JAX's config after
the fork (``_sync_jax_config_from_env``), and preloads the AOT cache's
bytes (``DLROVER_AOT_PRETRACE``); the port preloads torch and its own
modules, and with ``DLROVER_AOT_PRETRACE`` the AOT step entries and the
kernel libraries they list (:func:`_aot_preload`).  It needs no config
push: the kernel build reads ``DLROVER_COMPILE_CACHE_DIR`` from the
worker's env at its first build.

Protocol (dedicated pipe fds, so worker stdout stays untouched):
agent -> template: one JSON line per spawn
{"req": R, "env": {...}, "argv": [...]};
template -> agent: {"event": "spawned", "pid": N, "req": R} (the
request id is echoed so concurrent spawns match their own reply) and,
from the reap loop, {"event": "exit", "pid": N, "code": C}.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.log import default_logger as logger

DEFAULT_PRELOAD = "torch,numpy"

# the warm-restart recovery posture: everything the respawned trainer
# imports on its critical path, baked into the template ONCE — the
# single source the chaos scenarios and chip_smoke.py share, so the
# module set they measure cannot silently drift apart
TRAINER_PRELOAD = (
    DEFAULT_PRELOAD
    # a torch optimizer's first construction imports torch._dynamo
    # (seconds on a cold host): on the respawn's critical path too
    + ",torch._dynamo"
    + ",dlrover_tpu_torch.checkpoint.checkpointer"
    + ",dlrover_tpu_torch.trainer.elastic_trainer"
    + ",dlrover_tpu_torch.trainer.recovery"
    + ",dlrover_tpu_torch.models.gpt"
)

_AOT_PRETRACE_ENV = "DLROVER_AOT_PRETRACE"


def _flush_and_exit(code: int):
    """``os._exit`` skips interpreter shutdown, which is exactly what
    a forked worker needs (no atexit/thread teardown of the template's
    state) — but it also skips the std-stream flush a cold interpreter
    performs, silently dropping the worker's buffered output."""
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001
        pass
    os._exit(code)


def _aot_preload():
    """AOT pre-load (``DLROVER_AOT_PRETRACE``): read the job's AOT step
    entries into template memory and load the kernel libraries they
    list — every forked worker INHERITS the bytes and the loaded
    libraries, so its resolve hits without touching disk and its first
    step neither builds nor loads a kernel library.  A library load is
    a ``dlopen`` whose constructors register the kernels' fatbinaries
    with the statically linked CUDA runtime, which defers the driver to
    the first CUDA call: the template still makes none, as the
    reference's template never deserializes.  Called at template start
    AND before every fork (incremental rescan), so the entry a cold
    first incarnation writes is already in memory for the replacement
    fork that follows its death."""
    if os.environ.get(_AOT_PRETRACE_ENV, "").strip().lower() not in (
            "1", "true", "yes", "on"):
        return
    try:
        from dlrover_tpu_torch.common import aot_cache

        n, nbytes = aot_cache.preload_entries()
        if n:
            logger.info(
                "forkserver template preloaded %d AOT cache "
                "file(s), %.1f MB", n, nbytes / 2**20,
            )
    except Exception:  # noqa: BLE001 - preload is best-effort
        pass


def _template_main(req_fd: int, ev_fd: int):
    """Runs inside the template process (see __main__ below)."""
    for mod in os.environ.get(
        "DLROVER_PRELOAD", DEFAULT_PRELOAD
    ).split(","):
        mod = mod.strip()
        if not mod:
            continue
        # chaos hook: a kill here dies mid-import (half-warmed
        # template) — the agent must detect the death and fall back
        # to cold spawns instead of waiting on a corpse
        _chaos.fire("forkserver.template_import", module=mod)
        try:
            __import__(mod)
        except Exception:  # noqa: BLE001 - preload is best-effort
            pass
    _aot_preload()
    req = os.fdopen(req_fd, "r")
    ev = os.fdopen(ev_fd, "w")
    children: Dict[int, bool] = {}
    lock = threading.Lock()
    # text IO objects are not thread-safe: the reap loop and the
    # spawn loop both emit event lines, and an interleaved write
    # would be dropped by the agent's JSON reader — losing a
    # "spawned" (spawn() times out) or an "exit" (stop hangs)
    ev_lock = threading.Lock()

    def emit(msg: Dict):
        with ev_lock:
            ev.write(json.dumps(msg) + "\n")
            ev.flush()

    def reap_loop():
        while True:
            with lock:
                live = list(children)
            for pid in live:
                try:
                    done, status = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done, status = pid, 0
                if done:
                    code = (
                        os.waitstatus_to_exitcode(status)
                        if done == pid else 0
                    )
                    with lock:
                        children.pop(pid, None)
                    emit({"event": "exit", "pid": pid, "code": code})
            time.sleep(0.05)

    threading.Thread(target=reap_loop, daemon=True).start()
    for line in req:
        try:
            spec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if spec.get("event") == "shutdown":
            break
        # chaos hook: a kill here dies mid-spawn (request consumed,
        # no child forked, no reply coming) — the hardest template
        # loss for the agent to get right
        _chaos.fire("forkserver.spawn", req=spec.get("req", -1))
        # pick up AOT entries written since the last fork (a cold
        # first incarnation's trace) so THIS fork inherits them
        _aot_preload()
        pid = os.fork()
        if pid == 0:
            # ---- child: become the worker
            try:
                boost = spec.get("nice_boost")
                if boost:
                    # recovery boost: the respawned worker's restore +
                    # retrace must not be starved by other host load
                    # (the goodput killer in practice); bounded — a
                    # timer returns it to normal priority
                    try:
                        # who=getpid(), NOT 0: on Linux who=0 means
                        # the CALLING THREAD, and the unboost below
                        # runs on a side thread — with 0 it would
                        # renice itself while the training main
                        # thread kept the boost forever
                        me = os.getpid()
                        os.setpriority(
                            os.PRIO_PROCESS, me, int(boost["nice"])
                        )

                        def _unboost(
                            sec=float(boost.get("seconds", 20.0)),
                        ):
                            time.sleep(sec)
                            # nice is PER-THREAD on Linux and
                            # setpriority(PRIO_PROCESS, pid) renices
                            # only tid==pid: every thread the worker
                            # created during the boost (torch's pools
                            # do the steady-state compute!) must be
                            # reniced too, or the boost is unbounded
                            # for exactly the hottest threads
                            try:
                                tids = os.listdir("/proc/self/task")
                            except OSError:
                                tids = [str(me)]
                            for tid in tids:
                                try:
                                    os.setpriority(
                                        os.PRIO_PROCESS, int(tid), 0
                                    )
                                except (OSError, ValueError):
                                    pass

                        threading.Thread(
                            target=_unboost, daemon=True
                        ).start()
                    except (OSError, PermissionError):
                        pass  # not privileged: run unboosted
                os.environ.clear()
                os.environ.update(spec["env"])
                argv = spec["argv"]
                sys.argv = list(argv)
                # match cold-spawn import semantics: `python x.py`
                # puts the script's dir at sys.path[0], and the
                # per-spawn PYTHONPATH never reaches an
                # already-running interpreter by itself
                script_dir = os.path.dirname(
                    os.path.abspath(argv[0])
                )
                extra = spec["env"].get("PYTHONPATH", "").split(
                    os.pathsep
                )
                for p in [x for x in extra if x][::-1] + [script_dir]:
                    if p not in sys.path:
                        sys.path.insert(0, p)
                import runpy

                runpy.run_path(argv[0], run_name="__main__")
                _flush_and_exit(0)
            except SystemExit as e:
                code = e.code
                if code is None:
                    _flush_and_exit(0)
                if isinstance(code, int):
                    _flush_and_exit(code & 0xFF)
                # sys.exit("message") semantics: message to stderr,
                # status 1 (what a cold interpreter does)
                print(code, file=sys.stderr)
                _flush_and_exit(1)
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                _flush_and_exit(1)
        with lock:
            children[pid] = True
        emit({
            "event": "spawned", "pid": pid,
            "req": spec.get("req", -1),
        })
    # agent went away: leave children to the reaper of last resort
    os._exit(0)


class ForkedWorkerHandle:
    """Popen-compatible surface over a template-forked worker."""

    def __init__(self, pid: int, server: "WorkerForkServer"):
        self.pid = pid
        self._server = server
        self._code: Optional[int] = None

    def poll(self) -> Optional[int]:
        # cache the code here and CONSUME the server-side entry: the
        # handle is the only owner of this pid, so once the code is
        # local the server's per-pid bookkeeping can be pruned (a
        # long-lived elastic agent respawns workers for the life of
        # the job and must not accumulate an entry per incarnation)
        if self._code is None:
            self._code = self._server.consume_exit(self.pid)
        return self._code

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            code = self.poll()
            if code is not None:
                return code
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired(
                    cmd=f"forked-{self.pid}", timeout=timeout or 0
                )
            time.sleep(0.05)

    def send_signal(self, sig: int):
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


class WorkerForkServer:
    """Agent-side handle: owns the template process and the protocol."""

    def __init__(self, preload: str = ""):
        self._preload = preload or os.environ.get(
            "DLROVER_PRELOAD", DEFAULT_PRELOAD
        )
        self._proc: Optional[subprocess.Popen] = None
        self._req = None
        self._exits: Dict[int, int] = {}
        self._spawned: List[int] = []
        self._spawn_results: Dict[int, int] = {}  # req id -> pid
        self._abandoned: set = set()  # req ids whose caller timed out
        # which template GENERATION forked each pid: exit events for
        # a pid only ever come from its own template, so once that
        # template is gone (close + rebuild), liveness must be
        # probed directly or the handle polls None forever
        self._pid_generation: Dict[int, int] = {}
        # kernel start time recorded at spawn: (pid, start_time) is
        # unique across pid recycling, so the liveness fallback can
        # tell "our worker" from an unrelated process that inherited
        # the number after wraparound
        self._pid_start: Dict[int, Optional[int]] = {}
        self._generation = 0
        self._next_req = 0
        self._lock = threading.Lock()
        # spawn requests are serialized: the pipe is a shared stream
        # and matching replies by count races concurrent callers
        self._spawn_lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None

    def _ensure_template(self):
        if self._proc is not None and self._proc.poll() is None:
            return
        self._generation += 1
        req_r, req_w = os.pipe()
        ev_r, ev_w = os.pipe()
        env = dict(
            os.environ,
            DLROVER_PRELOAD=self._preload,
            # which template incarnation this is — chaos rules use it
            # (env_equals) to fault one generation and spare rebuilds
            DLROVER_FORKSERVER_GENERATION=str(self._generation),
        )
        # the template runs ``-m`` this module: the package must be
        # importable whatever the agent's working directory is
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        paths = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in paths:
            env["PYTHONPATH"] = os.pathsep.join(
                [pkg_root] + [p for p in paths if p])
        self._proc = subprocess.Popen(
            [
                sys.executable, "-m", "dlrover_tpu_torch.agent.forkserver",
                str(req_r), str(ev_w),
            ],
            env=env, pass_fds=(req_r, ev_w), close_fds=True,
        )
        os.close(req_r)
        os.close(ev_w)
        self._req = os.fdopen(req_w, "w")
        ev = os.fdopen(ev_r, "r")

        def read_events(ev=ev):
            for line in ev:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                with self._lock:
                    if msg["event"] == "spawned":
                        if msg.get("req", -1) in self._abandoned:
                            # the caller timed out waiting for this
                            # spawn: nobody will ever own the pid, so
                            # reap it here instead of leaking an
                            # unmanaged worker + a dict entry forever
                            self._abandoned.discard(msg.get("req", -1))
                            try:
                                os.kill(msg["pid"], signal.SIGKILL)
                            except (ProcessLookupError,
                                    PermissionError):
                                pass
                            continue
                        self._spawned.append(msg["pid"])
                        self._spawn_results[msg.get("req", -1)] = (
                            msg["pid"]
                        )
                    elif msg["event"] == "exit":
                        self._exits[msg["pid"]] = msg["code"]

        self._reader = threading.Thread(target=read_events, daemon=True)
        self._reader.start()

    def spawn(
        self, argv: List[str], env: Dict[str, str],
        timeout: float = 30.0,
        nice_boost: Optional[Dict] = None,
    ) -> ForkedWorkerHandle:
        """Fork the template into a worker running ``argv`` (argv[0]
        is the script path — the interpreter is already running).
        Requests carry an id echoed back in the spawned event, so
        concurrent callers each get their own pid.  ``nice_boost``
        ({"nice": N, "seconds": S}) starts the worker at scheduling
        priority N for its first S seconds — the recovery path's
        restore+retrace must not be starved by host load."""
        with self._spawn_lock:
            self._ensure_template()
            req_id = self._next_req
            self._next_req += 1
            msg = {"req": req_id, "env": env, "argv": argv}
            if nice_boost:
                msg["nice_boost"] = nice_boost
            self._req.write(json.dumps(msg) + "\n")
            self._req.flush()
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                pid = self._spawn_results.pop(req_id, None)
            if pid is not None:
                self._register_pid(pid)
                return ForkedWorkerHandle(pid, self)
            if self._proc is None or self._proc.poll() is not None:
                # the template died under us (kill mid-import, kill
                # mid-spawn): no reply is ever coming — fail NOW so
                # the caller's cold-spawn fallback runs in
                # milliseconds instead of after the full timeout
                # (the chaos warm-restart scenarios pin this path).
                # Same abandoned-req guard as the timeout path below:
                # the template may have forked the worker and written
                # the 'spawned' event just before dying — if the
                # reader delivers it after we raise, that pid must be
                # reaped, not leaked next to the cold-spawned
                # duplicate
                with self._lock:
                    late = self._spawn_results.pop(req_id, None)
                    if late is None:
                        self._abandoned.add(req_id)
                if late is not None:
                    self._register_pid(late)
                    return ForkedWorkerHandle(late, self)
                raise RuntimeError(
                    "fork template died before answering the spawn"
                )
            time.sleep(0.01)
        with self._lock:
            # the template may still complete this spawn after the
            # timeout: mark the req id abandoned so the reader thread
            # kills the late-arriving pid instead of leaking it (and
            # its _spawn_results entry) forever
            late = self._spawn_results.pop(req_id, None)
            if late is None:
                self._abandoned.add(req_id)
        if late is not None:  # landed between the last poll and now
            self._register_pid(late)
            return ForkedWorkerHandle(late, self)
        raise RuntimeError("fork server did not spawn a worker in time")

    def _register_pid(self, pid: int):
        start = self._proc_start_time(pid)
        with self._lock:
            self._pid_generation[pid] = self._generation
            self._pid_start[pid] = start

    @staticmethod
    def _proc_start_time(pid: int) -> Optional[int]:
        """Kernel start time of ``pid`` (/proc/<pid>/stat field 22,
        clock ticks since boot); None when the pid is gone."""
        from dlrover_tpu_torch.common.env_utils import proc_stat_fields

        fields = proc_stat_fields(pid)
        if fields is None:
            return None
        try:
            return int(fields[19])
        except (IndexError, ValueError):
            return None

    def exit_code(self, pid: int) -> Optional[int]:
        with self._lock:
            code = self._exits.get(pid)
        if code is not None:
            return code
        # exit events come FROM the template that forked this pid; if
        # that template died (OOM, crash) or was closed and REBUILT
        # (the current live template knows nothing of an older
        # generation's children) they never arrive — fall back to
        # direct liveness so the agent's monitor/stop paths cannot
        # wait forever on a pid that is already gone
        with self._lock:
            stale_gen = (
                self._pid_generation.get(pid, self._generation)
                != self._generation
            )
            spawn_start = self._pid_start.get(pid)
        if (stale_gen or self._proc is None
                or self._proc.poll() is not None):
            # liveness probe guarded against pid recycling: a bare
            # kill(pid, 0) says "some process with this number
            # exists" — after pid wraparound that can be a stranger,
            # and the agent would wait on it forever.  The kernel
            # start time recorded at spawn disambiguates: same pid +
            # different start time means OUR worker exited.
            now_start = self._proc_start_time(pid)
            alive = now_start is not None and (
                spawn_start is None or now_start == spawn_start
            )
            if not alive:
                with self._lock:
                    self._exits[pid] = -1
                return -1
        return None

    def consume_exit(self, pid: int) -> Optional[int]:
        """``exit_code`` that prunes the pid's bookkeeping once a
        code is returned, so entries do not grow unbounded across
        respawn rounds."""
        code = self.exit_code(pid)
        if code is not None:
            with self._lock:
                self._exits.pop(pid, None)
                self._pid_generation.pop(pid, None)
                self._pid_start.pop(pid, None)
                try:
                    self._spawned.remove(pid)
                except ValueError:
                    pass
        return code

    def close(self):
        if self._proc is None:
            return
        try:
            self._req.write(json.dumps({"event": "shutdown"}) + "\n")
            self._req.flush()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._proc = None


if __name__ == "__main__":
    _template_main(int(sys.argv[1]), int(sys.argv[2]))
