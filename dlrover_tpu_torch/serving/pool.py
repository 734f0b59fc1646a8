"""Supervised serving-replica pool.

Copy of ``dlrover_tpu/serving/pool.py`` (the port imports nothing of the JAX
package).

The process-supervision half of the serving fleet: spawns N
``python -m dlrover_tpu_torch.serving`` replica processes against one
publisher directory, respawns members that die (with
``DLROVER_SERVING_RESPAWNED=1``, the same incarnation stamp the chaos
schedules key on), and supports elastic ``resize`` — grow spawns
fresh members that self-register with the router through their
heartbeats; shrink journals a planned ``remove`` on the router before
stopping the member, so the routing table distinguishes an
operator-intended departure from a crash.

Each member gets its own event log (``events_replica<N>.jsonl``
beside the pool workdir, merged post-run like agent-shipped logs) and
its own textfile metrics dump (``replica<N>.prom``) for the master's
``DLROVER_METRICS_AGGREGATE_GLOB`` aggregation.
"""

import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class _ReplicaProc:
    replica_id: int
    proc: subprocess.Popen
    stop_file: str
    respawns: int = 0
    stopping: bool = False


class ReplicaPool:
    """Spawn/supervise/resize N replica subprocesses."""

    def __init__(
        self,
        serving_dir: str,
        workdir: str,
        router_addr: str = "",
        size: int = 1,
        poll_s: float = 0.1,
        heartbeat_s: float = 0.3,
        lookup_floor_ms: float = 0.0,
        stats_every_s: float = 0.5,
        max_respawns: int = 1,
        extra_env: Optional[Dict[str, str]] = None,
        extra_args: Optional[List[str]] = None,
        router=None,
    ):
        self._serving_dir = serving_dir
        self._workdir = workdir
        self._router_addr = router_addr
        self._poll = poll_s
        self._heartbeat = heartbeat_s
        self._lookup_floor_ms = lookup_floor_ms
        self._stats_every = stats_every_s
        self._max_respawns = max_respawns
        self._extra_env = dict(extra_env or {})
        self._extra_args = list(extra_args or [])
        self._router = router  # in-process LookupRouter (tests/bench)
        self._members: Dict[int, _ReplicaProc] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._stopping = False
        os.makedirs(workdir, exist_ok=True)
        for _ in range(size):
            self._spawn_new()

    # ------------------------------------------------------------------

    def _member_paths(self, rid: int) -> Dict[str, str]:
        return {
            "port_file": os.path.join(
                self._workdir, f"replica{rid}.port"
            ),
            "stop_file": os.path.join(
                self._workdir, f"replica{rid}.stop"
            ),
            "event_log": os.path.join(
                self._workdir, f"events_replica{rid}.jsonl"
            ),
            "prom": os.path.join(
                self._workdir, f"replica{rid}.prom"
            ),
        }

    def _cmd(self, rid: int, paths: Dict[str, str]) -> List[str]:
        cmd = [
            sys.executable, "-m", "dlrover_tpu_torch.serving",
            "--dir", self._serving_dir,
            "--poll", str(self._poll),
            "--replica-id", str(rid),
            "--serve-port", "0",
            "--port-file", paths["port_file"],
            "--stop-file", paths["stop_file"],
            "--metrics-prom", paths["prom"],
            "--stats-every", str(self._stats_every),
            # pool members serve routed traffic; the self-driving
            # synthetic loop stays off
            "--qps", "0", "--duration", "0", "--no-self-traffic",
        ]
        if self._router_addr:
            cmd += [
                "--router", self._router_addr,
                "--heartbeat", str(self._heartbeat),
            ]
        if self._lookup_floor_ms > 0:
            cmd += ["--lookup-floor-ms", str(self._lookup_floor_ms)]
        return cmd + self._extra_args

    def _env(self, rid: int, paths: Dict[str, str], respawned: bool):
        env = dict(os.environ)
        # the port's package root on PYTHONPATH, so ``-m
        # dlrover_tpu_torch.serving`` resolves wherever the pool's
        # caller runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p
        )
        env.update(self._extra_env)
        env.update({
            "DLROVER_SERVING_ROLE": "replica",
            # chaos rules target ONE member of the pool by pinning
            # this in env_equals (role alone matches every replica)
            "DLROVER_SERVING_REPLICA_ID": str(rid),
            "DLROVER_SERVING_RESPAWNED": "1" if respawned else "",
            "DLROVER_EVENT_LOG": paths["event_log"],
            "DLROVER_MASTER_ADDR": "",
        })
        return env

    def _spawn_new(self) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        self._launch(rid, respawned=False)
        return rid

    def _launch(self, rid: int, respawned: bool):
        paths = self._member_paths(rid)
        for key in ("port_file", "stop_file"):
            try:
                os.remove(paths[key])
            except OSError:
                pass
        proc = subprocess.Popen(  # noqa: S603
            self._cmd(rid, paths),
            env=self._env(rid, paths, respawned),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        member = _ReplicaProc(
            replica_id=rid, proc=proc, stop_file=paths["stop_file"],
        )
        with self._lock:
            prev = self._members.get(rid)
            if prev is not None:
                member.respawns = prev.respawns
            self._members[rid] = member
        threading.Thread(
            target=self._supervise, args=(member,), daemon=True,
            name=f"replica{rid}-sup",
        ).start()

    def _supervise(self, member: _ReplicaProc):
        rc = member.proc.wait()
        if self._stopping or member.stopping or rc == 0:
            return
        with self._lock:
            current = self._members.get(member.replica_id)
            if current is not member:
                return  # superseded by a newer incarnation
            if member.respawns >= self._max_respawns:
                logger.warning(
                    "serving replica %d died rc=%s with no respawn "
                    "budget left", member.replica_id, rc,
                )
                return
            member.respawns += 1
            respawns = member.respawns
        logger.warning(
            "serving replica %d died rc=%s; respawning (%d/%d)",
            member.replica_id, rc, respawns, self._max_respawns,
        )
        self._launch(member.replica_id, respawned=True)

    # ------------------------------------------------------------------

    @property
    def replica_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._members)

    def wait_ports(self, timeout_s: float = 30.0) -> Dict[int, int]:
        """Block until every live member has written its port file;
        ``{replica_id: port}``."""
        deadline = time.monotonic() + timeout_s
        ports: Dict[int, int] = {}
        while time.monotonic() < deadline:
            missing = False
            for rid in self.replica_ids:
                if rid in ports:
                    continue
                path = self._member_paths(rid)["port_file"]
                try:
                    with open(path) as f:
                        ports[rid] = int(f.read().strip())
                except (OSError, ValueError):
                    missing = True
            if not missing:
                return ports
            time.sleep(0.05)
        raise TimeoutError(
            f"replica ports not up within {timeout_s}s: have {ports}"
        )

    def event_logs(self) -> List[str]:
        with self._lock:
            rids = list(self._members)
        return [
            self._member_paths(rid)["event_log"] for rid in rids
        ]

    def prom_glob(self) -> str:
        return os.path.join(self._workdir, "replica*.prom")

    def kill(self, replica_id: int):
        """SIGKILL a member (chaos; supervision respawns it)."""
        with self._lock:
            member = self._members.get(replica_id)
        if member is not None:
            member.proc.kill()

    def resize(self, size: int) -> List[int]:
        """Grow by spawning fresh members, shrink by stopping the
        highest ids (router notified first so the departure is a
        journaled remove, not a shed).  Returns the live ids."""
        while len(self.replica_ids) < size:
            self._spawn_new()
        while len(self.replica_ids) > size:
            rid = self.replica_ids[-1]
            self._stop_member(rid)
        return self.replica_ids

    def _stop_member(self, rid: int):
        with self._lock:
            member = self._members.pop(rid, None)
        if member is None:
            return
        member.stopping = True

        def _notify_remove():
            if self._router is None:
                return
            try:
                self._router.remove(rid)
            except Exception:  # noqa: BLE001
                logger.exception("router remove(%d) failed", rid)

        _notify_remove()  # shift traffic before the server goes away
        with open(member.stop_file, "w") as f:
            f.write("stop")
        try:
            member.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            member.proc.terminate()
            try:
                member.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                member.proc.kill()
                member.proc.wait()
        # the member's farewell status report may have re-joined it
        # between the first remove and its exit; re-journal the
        # removal now that it can no longer report
        _notify_remove()

    def stop(self):
        self._stopping = True
        for rid in list(self.replica_ids):
            self._stop_member(rid)
