"""Fleet runner: hundreds of synthetic agents vs one real master.

The master is the PRODUCTION object — a journal-backed
:class:`~dlrover_tpu_torch.master.master.JobMaster` with its servicer,
rendezvous managers, task manager, speed monitor and (optionally)
Brain datastore — served over the real socket transport.  Only the
agents are synthetic.  The runner:

- ramps :class:`~dlrover_tpu_torch.fleet.synthetic_agent.SyntheticAgent`
  counts up/down while a
  :class:`~dlrover_tpu_torch.fleet.scoreboard.Scoreboard` watches;
- drives the master-side maintenance the run loop would do (SLO
  check, resize poll, Brain ingest) at harness cadence — same code
  paths, observable timing;
- performs the **SLO-green capacity search**: step the agent count
  until a windowed SLO rule breaches, back off one step, confirm the
  level holds green, and report the max sustained agents with the
  per-verb p99 at that capacity (emitted as a ``fleet_capacity``
  event and surfaced as the ``fleet_control_plane`` bench section);
- sweeps ``DLROVER_JOURNAL_FSYNC_WINDOW_S`` under fixed load to size
  the journal group-commit window from measured append p99.

Copy of ``dlrover_tpu/fleet/runner.py`` (the port imports nothing of the
JAX package); host code, as in the reference.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.fleet.scoreboard import Scoreboard
from dlrover_tpu_torch.fleet.synthetic_agent import (
    AgentProfile,
    SyntheticAgent,
)
from dlrover_tpu_torch.telemetry.events import emit_event

# the sweep's measured answer on the CI box (see the
# fleet_control_plane bench section): 0.05 s batches the fsync storm
# without letting a power cut eat more than 50 ms of non-terminal
# records (SIGKILL still loses nothing; DURABLE_KINDS always fsync).
# StateJournal's own default stays 0 — full per-append durability —
# so arming the window is an explicit, informed choice.
INFORMED_FSYNC_WINDOW_S = 0.05


class FleetRunner:
    """Owns one real master + a ramping population of synthetic
    agents + the scoreboard watching both."""

    def __init__(
        self,
        max_nodes: int = 512,
        profile: Optional[AgentProfile] = None,
        workdir: Optional[str] = None,
        journal: bool = True,
        fsync_window_s: Optional[float] = None,
        piggyback: bool = False,
        scoreboard_interval_s: float = 1.0,
        rules=None,
        brain_db: str = "",
        master_factory: Optional[Callable] = None,
        pack_size: int = 0,
    ):
        """``piggyback`` arms ``DLROVER_STEP_PIGGYBACK`` for every
        agent the runner creates (process-wide env — the before/after
        comparison runs two runners, not two modes in one).
        ``fsync_window_s`` sets the master journal's group-commit
        window (None = journal default, i.e. per-append fsync).
        ``master_factory`` overrides master construction for tests.
        ``pack_size`` > 0 hosts agents in SUBPROCESS packs of up to
        that many instead of in-process threads: at hundreds of
        agents the threads would fight the master for the GIL and
        the scoreboard would measure the harness, not the control
        plane."""
        self.max_nodes = int(max_nodes)
        self.profile = profile or AgentProfile()
        self._own_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(
            prefix="dlrover_fleet_"
        )
        self._env_backup: Dict[str, Optional[str]] = {}
        self._set_env(
            "DLROVER_STEP_PIGGYBACK", "1" if piggyback else ""
        )
        # the harness hammers reconnects on purpose: keep client
        # retry envelopes tight so refused requests surface as error
        # counts, not multi-second stalls
        self._set_env("DLROVER_RPC_RETRIES", "3")
        self._set_env("DLROVER_RPC_BACKOFF_BASE", "0.05")
        self._set_env("DLROVER_RPC_BACKOFF_MAX", "0.5")
        self._set_env("DLROVER_MASTER_RESYNC_TIMEOUT", "5")
        if fsync_window_s is not None:
            self._set_env(
                "DLROVER_JOURNAL_FSYNC_WINDOW_S",
                str(fsync_window_s),
            )
        if brain_db:
            self._set_env("DLROVER_BRAIN_DB", brain_db)
        journal_dir = (
            os.path.join(self.workdir, "journal") if journal else None
        )
        if master_factory is not None:
            self.master = master_factory(journal_dir)
        else:
            from dlrover_tpu_torch.master.master import JobMaster

            self.master = JobMaster(
                port=0,
                node_num=self.max_nodes,
                job_name="fleet",
                journal_dir=journal_dir,
                min_node_num=1,
            )
        # rounds re-form on a short timeout instead of waiting for
        # max_nodes: a ramping fleet keeps producing
        # rendezvous_complete rounds the way elastic churn would
        for mngr in self.master.rdzv_managers.values():
            mngr.update_rdzv_params(
                min_nodes=1,
                max_nodes=self.max_nodes,
                waiting_timeout=2.0,
            )
        self.master.prepare()
        self.addr = f"127.0.0.1:{self.master.port}"
        self.agents: List[SyntheticAgent] = []
        self.pack_size = max(0, int(pack_size))
        # pack mode: [{proc, count, stats_path}]
        self._packs: List[Dict] = []
        self._pack_seq = 0
        self.scoreboard = Scoreboard(
            interval_s=scoreboard_interval_s,
            rules=rules,
            agents_fn=lambda: (
                len(self.agents) + self._pack_counts()
            ),
        )
        self._next_node_id = 0
        self._dataset_registered = False
        self._stopped = False

    # -- env hygiene -------------------------------------------------------

    def _set_env(self, key: str, value: str):
        if key not in self._env_backup:
            self._env_backup[key] = os.environ.get(key)
        if value == "":
            os.environ.pop(key, None)
        else:
            os.environ[key] = value

    def _restore_env(self):
        for key, old in self._env_backup.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
        self._env_backup = {}

    # -- population --------------------------------------------------------

    def _register_dataset(self):
        if self._dataset_registered:
            return
        boot = SyntheticAgent(
            self.addr, node_id=10_000_000, profile=self.profile
        )
        boot.client.report_dataset_shard_params(
            batch_size=1,
            num_epochs=1_000_000,
            dataset_size=4096,
            shuffle=False,
            num_minibatches_per_shard=1,
            dataset_name=self.profile.dataset,
        )
        boot.client.close()
        self._dataset_registered = True

    # -- subprocess packs --------------------------------------------------

    def _pack_counts(self) -> int:
        # prune packs that died unexpectedly (spawn failure, OOM):
        # counting phantom agents would let a capacity probe claim a
        # level no real load ever exercised
        dead = [
            p for p in self._packs
            if p["proc"].poll() is not None
        ]
        for pack in dead:
            logger.warning(
                "agent pack (%d agents) died unexpectedly (rc=%s); "
                "pruned", pack["count"], pack["proc"].returncode,
            )
            self._packs.remove(pack)
        return sum(p["count"] for p in self._packs)

    def _spawn_pack(self, count: int, timeout_s: float = 30.0) -> bool:
        pack_id = self._pack_seq
        self._pack_seq += 1
        stats_path = os.path.join(
            self.workdir, f"pack_{pack_id}.json"
        )
        start_id = self._next_node_id
        self._next_node_id += count
        proc = subprocess.Popen(
            [
                sys.executable, "-m",
                "dlrover_tpu_torch.fleet.agent_pack",
                "--addr", self.addr,
                "--start-id", str(start_id),
                "--count", str(count),
                "--stats", stats_path,
                "--profile", json.dumps(
                    dataclasses.asdict(self.profile)
                ),
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        pack = {
            "proc": proc, "count": count, "stats_path": stats_path,
        }
        self._packs.append(pack)
        # wait until the pack reports its agents started: a level
        # probe must not begin while a pack is still importing
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            doc = self._read_pack_stats(stats_path)
            if doc and doc.get("ready"):
                return True
            if proc.poll() is not None:
                # never count a stillborn pack toward the population
                logger.warning(
                    "agent pack %s died at start (rc=%s)",
                    pack_id, proc.returncode,
                )
                self._packs.remove(pack)
                return False
            time.sleep(0.1)
        logger.warning("agent pack %s slow to start", pack_id)
        return True

    @staticmethod
    def _read_pack_stats(path: str) -> Optional[Dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _stop_pack(self, pack: Dict, timeout_s: float = 8.0):
        proc = pack["proc"]
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)

    def _ramp_packs(self, n: int):
        # shrink by whole packs (their final stats files keep the
        # cumulative op accounting), then top back up with a pack
        # sized to the exact deficit — the population always matches
        # the requested level, even when n is not a pack multiple
        while self._pack_counts() > n and self._packs:
            pack = self._packs.pop()
            self._stop_pack(pack)
        while self._pack_counts() < n:
            deficit = n - self._pack_counts()
            if not self._spawn_pack(min(self.pack_size, deficit)):
                break  # spawn failing repeatedly: do not spin

    def ramp_to(self, n: int, stagger_s: float = 0.01):
        """Grow or shrink the live agent population to ``n``.
        Starts are staggered (``stagger_s`` between agents; packs
        stagger internally) so a level change models a rolling
        deployment, not a thundering herd of simultaneous joins —
        the steady-state window is what the capacity search
        judges."""
        n = max(0, min(int(n), self.max_nodes))
        self._register_dataset()
        if self.pack_size > 0:
            self._ramp_packs(n)
            return
        while len(self.agents) > n:
            agent = self.agents.pop()
            agent.stop(join_timeout=2.0)
        started = []
        while len(self.agents) + len(started) < n:
            agent = SyntheticAgent(
                self.addr,
                node_id=self._next_node_id,
                profile=self.profile,
            )
            self._next_node_id += 1
            agent.start()
            started.append(agent)
            if stagger_s > 0:
                time.sleep(stagger_s)
        self.agents.extend(started)

    def _master_maintenance(self):
        """What the master run loop does every poll, at harness
        cadence: SLO evaluation, resize decisions, Brain ingest."""
        try:
            self.master.slo_checker.check()
        except Exception:  # noqa: BLE001
            logger.exception("fleet: SLO check failed")
        try:
            self.master.resize_coordinator.poll()
        except Exception:  # noqa: BLE001
            logger.exception("fleet: resize poll failed")
        try:
            self.master.maybe_brain_ingest()
        except Exception:  # noqa: BLE001
            logger.exception("fleet: brain ingest failed")

    def run_load(
        self, agents: int, duration_s: float,
        settle_s: float = 0.5,
    ) -> Dict:
        """Hold ``agents`` for ``duration_s`` and return the
        scoreboard summary over that window only."""
        self.ramp_to(agents)
        time.sleep(max(0.0, settle_s))
        self.scoreboard.reset_window()
        n_before = len(self.scoreboard.samples)
        deadline = time.monotonic() + duration_s
        while time.monotonic() < deadline:
            step = min(
                self.scoreboard.interval_s,
                max(0.05, deadline - time.monotonic()),
            )
            time.sleep(step)
            self.scoreboard.sample()
            self._master_maintenance()
        return self.scoreboard.summary(
            last_n=len(self.scoreboard.samples) - n_before
        )

    # -- capacity search ---------------------------------------------------

    def capacity_search(
        self,
        start: int = 25,
        step: int = 25,
        max_agents: Optional[int] = None,
        window_s: float = 4.0,
        settle_s: float = 1.0,
        deadline_s: float = 300.0,
        confirm: bool = True,
    ) -> Dict:
        """SLO-green capacity search: step the agent count until a
        windowed rule breaches, back off one step, confirm green,
        report the max sustained agents + per-verb p99 at capacity.

        A level is *green* when its whole window produced no
        windowed-quantile breach AND agent-side errors stayed under
        1% of ops (a master that answers fast by refusing work is
        not green)."""
        t0 = time.monotonic()
        max_agents = min(
            max_agents or self.max_nodes, self.max_nodes
        )
        levels: List[Dict] = []
        last_green: Optional[Dict] = None
        breached: Optional[Dict] = None
        n = start
        while n <= max_agents:
            remaining = deadline_s - (time.monotonic() - t0)
            if remaining < window_s + settle_s:
                logger.warning(
                    "fleet capacity search: deadline reached at "
                    "%d agents", n,
                )
                break
            level = self._probe_level(n, window_s, settle_s)
            levels.append(level)
            if level["green"]:
                last_green = level
                n += step
            else:
                breached = level
                break
        if confirm and breached is not None:
            # back off and hold: "green on the way up" could be a
            # warmup artifact — capacity is the level that holds
            # green AFTER the breach backed us off.  A failed
            # confirm keeps stepping DOWN (never re-promotes a
            # ramp-up green it could not reproduce)
            n_conf = last_green["agents"] if last_green else 0
            last_green = None
            while n_conf >= max(1, start):
                if (
                    deadline_s - (time.monotonic() - t0)
                    < window_s + settle_s
                ):
                    break
                lvl = self._probe_level(n_conf, window_s, settle_s)
                lvl["confirm"] = True
                levels.append(lvl)
                if lvl["green"]:
                    last_green = lvl
                    break
                n_conf -= step
        result = {
            "max_sustained_agents": (
                last_green["agents"] if last_green else 0
            ),
            "p99_at_capacity_ms": (
                last_green["worst_p99_ms"] if last_green else {}
            ),
            "rps_at_capacity": (
                last_green["mean_rps"] if last_green else 0.0
            ),
            "first_breach": (
                {
                    "agents": breached["agents"],
                    "breaches": breached["breaches"],
                }
                if breached else None
            ),
            "levels": [
                {
                    k: lvl[k] for k in (
                        "agents", "green", "mean_rps",
                        "error_ratio", "breach_count",
                    )
                }
                for lvl in levels
            ],
            "search_s": round(time.monotonic() - t0, 1),
        }
        emit_event(
            "fleet_capacity",
            max_sustained_agents=result["max_sustained_agents"],
            rps_at_capacity=result["rps_at_capacity"],
            levels=len(levels),
            search_s=result["search_s"],
            first_breach_agents=(
                breached["agents"] if breached else -1
            ),
        )
        return result

    def _probe_level(
        self, n: int, window_s: float, settle_s: float
    ) -> Dict:
        """Hold ``n`` agents and judge the level over ONE window
        spanning the whole hold (the scoreboard's per-second samples
        keep flowing for fleet_report, but a 1 s window cannot clear
        min_count for low-rate verbs — the probe window can)."""
        self.ramp_to(n)
        time.sleep(max(0.0, settle_s))
        ops_before, errs_before = self._fleet_ops()
        self.scoreboard.reset_window()
        self.scoreboard.begin_probe()
        deadline = time.monotonic() + window_s
        while time.monotonic() < deadline:
            step = min(
                self.scoreboard.interval_s,
                max(0.05, deadline - time.monotonic()),
            )
            time.sleep(step)
            self.scoreboard.sample()
            self._master_maintenance()
        probe = self.scoreboard.end_probe()
        ops_after, errs_after = self._fleet_ops()
        d_ops = max(1, ops_after - ops_before)
        d_errs = max(0, errs_after - errs_before)
        error_ratio = d_errs / (d_ops + d_errs)
        breach_count = len(probe["breaches"])
        green = breach_count == 0 and error_ratio < 0.01
        level = {
            "agents": n,
            "green": green,
            "mean_rps": round(probe["ops"] / window_s, 2),
            "worst_p99_ms": probe["worst_p99_ms"],
            "error_ratio": round(error_ratio, 4),
            "breach_count": breach_count,
            "breaches": probe["breaches"][:5],
        }
        logger.info(
            "fleet level %d agents: %s (rps=%.0f, errors=%.2f%%, "
            "breaches=%d)",
            n, "GREEN" if green else "BREACH",
            level["mean_rps"], error_ratio * 100, breach_count,
        )
        return level

    def _fleet_ops(self):
        ops = sum(a.stats.total_ops for a in self.agents)
        errs = sum(a.stats.total_errors for a in self.agents)
        for doc in self._all_pack_stats():
            ops += sum(doc.get("ops", {}).values())
            errs += sum(doc.get("errors", {}).values())
        return ops, errs

    def _all_pack_stats(self) -> List[Dict]:
        """Latest stats of every pack EVER spawned (stopped packs'
        final files included — op totals are cumulative, so deltas
        across a level stay correct through ramp-downs)."""
        out = []
        seen = set()
        for pack in self._packs:
            seen.add(pack["stats_path"])
            doc = self._read_pack_stats(pack["stats_path"])
            if doc:
                out.append(doc)
        # stopped packs left their final stats on disk
        try:
            for name in os.listdir(self.workdir):
                if not (
                    name.startswith("pack_")
                    and name.endswith(".json")
                ):
                    continue
                path = os.path.join(self.workdir, name)
                if path in seen:
                    continue
                doc = self._read_pack_stats(path)
                if doc:
                    out.append(doc)
        except OSError:
            pass
        return out

    # -- teardown ----------------------------------------------------------

    def stats(self) -> Dict:
        ops: Dict[str, int] = {}
        errs: Dict[str, int] = {}
        resyncs = 0
        for a in self.agents:
            for verb, c in a.stats.ops.items():
                ops[verb] = ops.get(verb, 0) + c
            for verb, c in a.stats.errors.items():
                errs[verb] = errs.get(verb, 0) + c
            resyncs += a.stats.resyncs
        for doc in self._all_pack_stats():
            for verb, c in doc.get("ops", {}).items():
                ops[verb] = ops.get(verb, 0) + c
            for verb, c in doc.get("errors", {}).items():
                errs[verb] = errs.get(verb, 0) + c
            resyncs += doc.get("resyncs", 0)
        return {"ops": ops, "errors": errs, "resyncs": resyncs}

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self.scoreboard.stop(final_sample=False)
        for agent in self.agents:
            agent._stop.set()
        for agent in self.agents:
            agent.stop(join_timeout=2.0)
        self.agents = []
        for pack in self._packs:
            self._stop_pack(pack)
        self._packs = []
        try:
            self.master.stop()
        except Exception:  # noqa: BLE001
            logger.exception("fleet master stop failed")
        self._restore_env()
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


def sweep_fsync_window(
    windows: Sequence[float] = (0.0, 0.01, 0.05, 0.25),
    agents: int = 50,
    duration_s: float = 4.0,
    profile: Optional[AgentProfile] = None,
    max_nodes: int = 512,
    pack_size: int = 0,
) -> Dict:
    """Size ``DLROVER_JOURNAL_FSYNC_WINDOW_S`` under fleet load: one
    fresh journal-backed master per window value, identical agent
    load, measured journal append p99 (the windowed
    ``dlrover_master_journal_fsync_seconds`` view).  Returns per-
    window numbers and the smallest window achieving within 20% of
    the best p99 — more batching than that buys latency nothing and
    only widens the power-cut exposure."""
    results: List[Dict] = []
    for w in windows:
        runner = FleetRunner(
            max_nodes=max_nodes,
            profile=profile,
            fsync_window_s=w,
            pack_size=pack_size,
        )
        try:
            summary = runner.run_load(agents, duration_s)
            results.append({
                "window_s": w,
                "append_p99_ms": summary.get(
                    "journal_append_p99_ms", 0.0
                ),
                "lock_wait_p99_ms": summary.get(
                    "journal_lock_wait_p99_ms", 0.0
                ),
                "mean_rps": summary.get("mean_rps", 0.0),
            })
        finally:
            runner.stop()
    measured = [
        r for r in results if r["append_p99_ms"] > 0
    ] or results
    best = min(r["append_p99_ms"] for r in measured)
    chosen = measured[0]["window_s"]
    for r in measured:
        if r["append_p99_ms"] <= best * 1.2:
            chosen = r["window_s"]
            break
    return {
        "windows": results,
        "chosen_window_s": chosen,
        "informed_default_s": INFORMED_FSYNC_WINDOW_S,
    }
