"""Chaos harness: drive a mini-cluster through a scenario and verify
recovery invariants from the telemetry event log alone.

:func:`run_scenario` launches the same supervision tree production
uses — the launcher (``python -m dlrover_tpu_torch.run``) spawns a
local master subprocess, runs the elastic agent in-process, and the
agent spawns/monitors the toy train loop — with ``DLROVER_CHAOS``
exported so every process of the job arms the scenario, and
``DLROVER_EVENT_LOG`` collecting one JSONL stream from all of them.
Afterwards the :class:`Invariant` checkers read ONLY that event log
(plus a /proc scan for the orphan check): if an invariant cannot be
decided from telemetry, the telemetry is the bug.

Copy of ``dlrover_tpu/chaos/harness.py``, cut to the single-node path
and the invariants its scenarios need:

- :class:`WorkerRestarted` — the fault produced a supervised restart.
- :class:`RendezvousReconverged` — an elastic-training rendezvous
  completed AFTER the fault, within a bound.
- :class:`BoundedStepLoss` — steps lost across the fault ≤ one
  checkpoint interval (from ``train_step`` + ``chaos_inject`` events).
- :class:`TrainingCompleted` / :class:`FinalStepCommitted` — the step
  budget finished and the final checkpoint committed.
- :class:`LossTrajectoryMatches` — every reported loss equals an
  uninterrupted control's, with at least one step replayed.
- :class:`RestoredFromTier` — the first post-fault restore's tier.
- :class:`HangDiagnosed` / :class:`OnlyCulpritRestarted` — the hang
  diagnosis trail.
- :class:`GoodputConservation` / :class:`GoodputLossAttributed` — the
  goodput ledger closes and names its losses.
- :class:`DeterministicTimeline` — the ``chaos_inject`` sequence
  matches a reference timeline (cross-run determinism).
- :class:`EventRecorded` — an event type was recorded.
- :class:`NoOrphanProcesses` — nothing spawned for the job outlives
  it (forkserver children included).

The multi-agent, elastic-resize and serving runners come with slices
4 and 9 of the port, the sparse, RL and compile-cache invariants with
slices 6, 7 and 8.
"""

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.chaos.scenarios import (
    CHAOS_TRAIN_SCRIPT,
    CKPT_EVERY_ENV,
    DISK_EVERY_ENV,
    RUN_OPTIONS,
    TOTAL_STEPS_ENV,
)
from dlrover_tpu_torch.chaos.schedule import load_scenario
from dlrover_tpu_torch.common.env_utils import proc_stat_fields
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import timeline as flight
from dlrover_tpu_torch.telemetry.events import (
    EVENT_LOG_ENV,
    collect_events,
)

CHAOS_EVENT = "chaos_inject"


@dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def __bool__(self):
        return self.ok


class Invariant:
    """Base checker: decide pass/fail from the job's event list."""

    name = "invariant"

    def check(self, events: List[dict],
              run: "ChaosRunReport") -> InvariantResult:
        raise NotImplementedError


def _injections(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("type") == CHAOS_EVENT]


def _first_fault_ts(events: List[dict]) -> Optional[float]:
    inj = _injections(events)
    return inj[0]["ts"] if inj else None


class WorkerRestarted(Invariant):
    name = "worker_restarted"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        restarts = [
            e for e in events
            if e.get("type") == "worker_restart"
            and e["ts"] >= fault_ts
        ]
        if not restarts:
            return InvariantResult(
                self.name, False, "no worker_restart after the fault"
            )
        return InvariantResult(
            self.name, True,
            f"{len(restarts)} restart(s) after fault",
        )


class RendezvousReconverged(Invariant):
    """An elastic-training rendezvous completed after the fault, and
    the gap stayed under ``within_s``."""

    name = "rendezvous_reconverged"

    def __init__(self, within_s: float = 120.0):
        self.within_s = within_s

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        rounds = [
            e for e in events
            if e.get("type") == "rendezvous_complete"
            and e.get("rdzv") == "elastic-training"
            and e["ts"] > fault_ts
        ]
        if not rounds:
            return InvariantResult(
                self.name, False,
                "no elastic-training rendezvous completed after the "
                "fault",
            )
        gap = rounds[0]["ts"] - fault_ts
        if gap > self.within_s:
            return InvariantResult(
                self.name, False,
                f"reconverged after {gap:.1f}s > bound {self.within_s}s",
            )
        return InvariantResult(
            self.name, True, f"reconverged in {gap:.1f}s"
        )


class BoundedStepLoss(Invariant):
    """Steps lost across the fault ≤ one checkpoint interval, computed
    from telemetry only: the highest ``train_step`` of the first
    incarnation vs the first ``train_step`` of a respawned one."""

    name = "bounded_step_loss"

    def __init__(self, ckpt_interval: int):
        self.ckpt_interval = ckpt_interval

    def check(self, events, run):
        first = [
            e["step"] for e in events
            if e.get("type") == "train_step"
            and e.get("restart_count", 0) == 0
        ]
        resumed = [
            e["step"] for e in events
            if e.get("type") == "train_step"
            and e.get("restart_count", 0) > 0
        ]
        if not first:
            return InvariantResult(
                self.name, False, "no train_step events at all"
            )
        if not resumed:
            return InvariantResult(
                self.name, False,
                "no post-restart train_step events (recovery never "
                "stepped)",
            )
        last_before = max(first)
        resume_at = min(resumed)
        lost = last_before - (resume_at - 1)
        if lost > self.ckpt_interval:
            return InvariantResult(
                self.name, False,
                f"lost {lost} step(s) (last pre-fault {last_before}, "
                f"resumed at {resume_at}) > interval "
                f"{self.ckpt_interval}",
            )
        if lost < 0:
            return InvariantResult(
                self.name, False,
                f"resumed AHEAD of progress (last pre-fault "
                f"{last_before}, resumed at {resume_at})",
            )
        return InvariantResult(
            self.name, True,
            f"lost {lost} step(s) ≤ interval {self.ckpt_interval} "
            f"(resumed at {resume_at} after {last_before})",
        )


class TrainingCompleted(Invariant):
    """The job stepped through its full budget and committed the final
    checkpoint."""

    name = "training_completed"

    def __init__(self, total_steps: int):
        self.total_steps = total_steps

    def check(self, events, run):
        steps = [
            e["step"] for e in events if e.get("type") == "train_step"
        ]
        commits = [
            e["step"] for e in events
            if e.get("type") == "checkpoint_commit"
        ]
        if not steps or max(steps) < self.total_steps:
            return InvariantResult(
                self.name, False,
                f"highest step {max(steps) if steps else None} < "
                f"budget {self.total_steps}",
            )
        if self.total_steps not in commits:
            return InvariantResult(
                self.name, False,
                f"final step {self.total_steps} never committed "
                f"(commits: {sorted(set(commits))})",
            )
        return InvariantResult(
            self.name, True,
            f"stepped to {max(steps)}, committed {self.total_steps}",
        )



class HangDiagnosed(Invariant):
    """Deep-diagnosis invariant: within ``within_s`` of the injected
    stall, the master reached a *hung* verdict that carries captured
    stack evidence and a measured stall duration, fed by at least one
    agent ``hang_evidence`` capture (stacks present)."""

    name = "hang_diagnosed"

    def __init__(self, within_s: float = 30.0):
        self.within_s = within_s

    def check(self, events, run):
        stalls = [
            e for e in _injections(events)
            if e.get("action") == "stall"
        ]
        if not stalls:
            return InvariantResult(
                self.name, False, "no stall injection recorded"
            )
        t0 = stalls[0]["ts"]
        evidence = [
            e for e in events
            if e.get("type") == "hang_evidence" and e["ts"] >= t0
        ]
        if not evidence:
            return InvariantResult(
                self.name, False,
                "no hang_evidence capture after the stall (agent "
                "watchdog never fired)",
            )
        if not any(e.get("stacks") for e in evidence):
            return InvariantResult(
                self.name, False,
                "hang_evidence carries no stacks",
            )
        verdicts = [
            e for e in events
            if e.get("type") == "diagnosis_verdict"
            and e.get("hung") and e["ts"] >= t0
        ]
        if not verdicts:
            return InvariantResult(
                self.name, False,
                "no hung diagnosis_verdict after the stall",
            )
        v = verdicts[0]
        gap = v["ts"] - t0
        stall_s = v.get("stall_s")
        if not isinstance(stall_s, (int, float)) or stall_s <= 0:
            return InvariantResult(
                self.name, False,
                f"verdict carries no measured stall ({stall_s!r})",
            )
        if not v.get("evidence"):
            return InvariantResult(
                self.name, False,
                "verdict carries no evidence excerpt",
            )
        if gap > self.within_s:
            return InvariantResult(
                self.name, False,
                f"diagnosed after {gap:.1f}s > bound "
                f"{self.within_s}s",
            )
        return InvariantResult(
            self.name, True,
            f"hung verdict in {gap:.1f}s (stall {stall_s:.1f}s, "
            f"{len(evidence)} evidence capture(s))",
        )


class OnlyCulpritRestarted(Invariant):
    """A hang verdict must restart exactly the culprit node: at least
    one restart happened, every restart is on ``culprit_rank``, and
    the job was never aborted for the hang."""

    def __init__(self, culprit_rank: int = 0):
        self.culprit_rank = culprit_rank
        self.name = f"only_culprit_node{culprit_rank}_restarted"

    def check(self, events, run):
        restarts = [
            e for e in events if e.get("type") == "worker_restart"
        ]
        if not restarts:
            return InvariantResult(
                self.name, False,
                "no worker_restart (culprit never relaunched)",
            )
        strays = [
            e for e in restarts
            if e.get("node_rank") != self.culprit_rank
        ]
        if strays:
            return InvariantResult(
                self.name, False,
                f"{len(strays)} restart(s) on non-culprit nodes: "
                f"{sorted({e.get('node_rank') for e in strays})}",
            )
        aborted = [
            e for e in events
            if e.get("type") == "master_exit"
            and e.get("exit_reason") == "hang_error"
        ]
        if aborted:
            return InvariantResult(
                self.name, False,
                "job aborted for the hang instead of a targeted "
                "restart",
            )
        return InvariantResult(
            self.name, True,
            f"{len(restarts)} restart(s), all on culprit node "
            f"{self.culprit_rank}",
        )



class LossTrajectoryMatches(Invariant):
    """Resharded-restore correctness, decided from the event log
    alone: every reported ``train_step`` loss must equal the
    uninterrupted-control trajectory at that step (the resize train
    loop derives its batch from the step index, so the control is a
    pure recomputation), AND at least one step must carry records
    from two distinct incarnations/nodes — the proof that replay /
    cross-node agreement was actually exercised, not vacuously
    skipped.  A restore that resharded the params wrong diverges at
    the first replayed step."""

    name = "loss_trajectory_matches_control"

    def __init__(self, expected: Sequence[float],
                 rtol: float = 1e-3, atol: float = 1e-5):
        self.expected = list(expected)
        self.rtol = rtol
        self.atol = atol

    def check(self, events, run):
        by_step = {}
        for e in events:
            if e.get("type") != "train_step":
                continue
            loss = e.get("loss")
            if not isinstance(loss, (int, float)):
                continue
            step = int(e.get("step", 0))
            by_step.setdefault(step, []).append(
                (e.get("node_rank"), e.get("restart_count"), loss)
            )
        if not by_step:
            return InvariantResult(
                self.name, False, "no train_step events carry a loss"
            )
        mismatches = []
        for step, recs in sorted(by_step.items()):
            if not (1 <= step <= len(self.expected)):
                mismatches.append(f"step {step} outside control")
                continue
            want = self.expected[step - 1]
            for rank, count, loss in recs:
                if abs(loss - want) > self.atol + self.rtol * abs(want):
                    mismatches.append(
                        f"step {step} node{rank} r{count}: "
                        f"{loss:.6g} != control {want:.6g}"
                    )
        if mismatches:
            return InvariantResult(
                self.name, False,
                f"{len(mismatches)} loss divergence(s): "
                f"{mismatches[:5]}",
            )
        multi = [
            step for step, recs in by_step.items()
            if len({(r, c) for r, c, _ in recs}) > 1
        ]
        if not multi:
            return InvariantResult(
                self.name, False,
                "no step was reported by more than one incarnation/"
                "node — the cross-check never ran",
            )
        return InvariantResult(
            self.name, True,
            f"{len(by_step)} step(s) match control "
            f"({len(multi)} with multi-incarnation agreement)",
        )



class DeterministicTimeline(Invariant):
    """The run's fault timeline equals a reference timeline (usually a
    prior run of the same scenario+seed)."""

    name = "deterministic_timeline"

    def __init__(self, reference: Sequence[Tuple]):
        self.reference = [tuple(r) for r in reference]

    def check(self, events, run):
        timeline = timeline_from_events(events)
        if timeline != self.reference:
            return InvariantResult(
                self.name, False,
                f"timeline {timeline} != reference {self.reference}",
            )
        return InvariantResult(
            self.name, True, f"{len(timeline)} injection(s) identical"
        )


class RestoredFromTier(Invariant):
    """The first post-fault restore came from the expected tier —
    e.g. a torn/corrupted shm snapshot must be refused and recovery
    must fall back to the storage tier.  Decided entirely from the
    ``checkpoint_restore`` event's ``tier`` field (shm / storage /
    orbax), which the engine stamps on every successful restore."""

    name = "restored_from_tier"

    def __init__(self, tier: str):
        self.tier = tier

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        restores = [
            e for e in events
            if e.get("type") == "checkpoint_restore"
            and e["ts"] >= fault_ts
        ]
        if not restores:
            return InvariantResult(
                self.name, False,
                "no checkpoint_restore event after the fault",
            )
        tiers = [e.get("tier") for e in restores]
        if tiers[0] != self.tier:
            return InvariantResult(
                self.name, False,
                f"first post-fault restore came from tier "
                f"{tiers[0]!r}, expected {self.tier!r} "
                f"(all: {tiers})",
            )
        return InvariantResult(
            self.name, True,
            f"restored from {self.tier!r} tier (step "
            f"{restores[0].get('step')})",
        )



class EventRecorded(Invariant):
    """At least ``min_count`` events of ``event_type`` exist (e.g. a
    ``warm_fork_fallback`` proving the cold-spawn path ran)."""

    def __init__(self, event_type: str, min_count: int = 1):
        self.event_type = event_type
        self.min_count = min_count
        self.name = f"event_recorded[{event_type}]"

    def check(self, events, run):
        hits = [e for e in events if e.get("type") == self.event_type]
        if len(hits) < self.min_count:
            return InvariantResult(
                self.name, False,
                f"{len(hits)} {self.event_type!r} event(s) < "
                f"required {self.min_count}",
            )
        return InvariantResult(
            self.name, True, f"{len(hits)} event(s)"
        )



class FinalStepCommitted(Invariant):
    """The job's last reached step ended up durably committed (the
    shard-driven loops derive their budget from the dataset, so the
    bound is 'whatever the trainer actually reached')."""

    name = "final_step_committed"

    def check(self, events, run):
        steps = [
            e["step"] for e in events if e.get("type") == "train_step"
        ]
        commits = [
            e.get("step") for e in events
            if e.get("type") == "checkpoint_commit"
        ]
        if not steps:
            return InvariantResult(
                self.name, False, "no train_step events"
            )
        final = max(steps)
        if final not in commits:
            return InvariantResult(
                self.name, False,
                f"final step {final} never committed "
                f"(commits: {sorted(set(commits))})",
            )
        return InvariantResult(
            self.name, True, f"final step {final} committed"
        )



class GoodputLossAttributed(Invariant):
    """Flight-recorder invariant: the assembled timeline's
    goodput-loss diagnosis must attribute at least
    ``min_attributed_frac`` of the measured non-training wall-clock
    to NAMED causes (rendezvous / restore / master recovery /
    straggler) — an unattributed majority means the telemetry lost
    the causal trail.  Reads the ready-made ``run.attribution``
    instead of re-parsing raw events; runs with no measurable loss
    pass vacuously."""

    name = "goodput_loss_attributed"

    def __init__(self, min_attributed_frac: float = 0.5,
                 expect_cause: str = ""):
        self.min_attributed_frac = min_attributed_frac
        self.expect_cause = expect_cause

    def check(self, events, run):
        attr = run.attribution
        if attr is None:
            tl = flight.assemble(events)
            attr = flight.attribute_goodput_loss(tl)
        loss = attr["loss_s"]
        if loss <= 0:
            return InvariantResult(
                self.name, True, "no non-training time to attribute"
            )
        named = sum(
            v for k, v in attr["buckets"].items()
            if k != flight.CAUSE_UNATTRIBUTED
        )
        frac = named / loss
        if self.expect_cause and (
            attr["buckets"].get(self.expect_cause, 0.0) <= 0
        ):
            return InvariantResult(
                self.name, False,
                f"expected cause {self.expect_cause!r} got 0s "
                f"(buckets: {attr['buckets']})",
            )
        if frac < self.min_attributed_frac:
            return InvariantResult(
                self.name, False,
                f"only {frac:.0%} of {loss:.3f}s lost attributed "
                f"(buckets: {attr['buckets']})",
            )
        return InvariantResult(
            self.name, True,
            f"{frac:.0%} of {loss:.3f}s lost attributed "
            f"({ {k: round(v, 3) for k, v in attr['buckets'].items()} })",
        )


class GoodputConservation(Invariant):
    """Goodput-ledger invariant: the per-incarnation wall-clock
    partition must CLOSE — every incarnation's attributed categories
    sum to its measured wall clock within ``eps`` (default 2%).  An
    attribution the ledger cannot explain is a bug, not a rounding
    error.  With ``named_floor`` > 0 the scenario additionally proves
    causality: at least that fraction of total non-productive time
    must land in NAMED categories (not ``idle_unattributed``) — the
    worker-kill scenarios assert 90%, i.e. the death-witness ->
    rendezvous -> restore -> first-step chain was actually observed.
    Runs whose ledger has no incarnations (no step/restart telemetry
    at all) pass vacuously; the floor is only enforced once there is
    ``min_loss_s`` of non-productive time to explain."""

    name = "goodput_conservation"

    def __init__(self, eps: float = 0.02,
                 named_floor: float = 0.0,
                 min_loss_s: float = 1.0):
        self.eps = eps
        self.named_floor = named_floor
        self.min_loss_s = min_loss_s

    def check(self, events, run):
        from dlrover_tpu_torch.telemetry import goodput as _goodput

        ledger = _goodput.build_ledger(events)
        if not ledger.incarnations:
            return InvariantResult(
                self.name, True, "no incarnations in ledger"
            )
        errors = ledger.conservation_errors(self.eps)
        if errors:
            return InvariantResult(
                self.name, False,
                "conservation violated: " + "; ".join(errors),
            )
        loss = ledger.loss_totals()
        nonprod = sum(loss.values())
        detail = (
            f"{len(ledger.incarnations)} incarnation(s) close "
            f"within {self.eps:.0%}"
        )
        if self.named_floor > 0 and nonprod >= self.min_loss_s:
            named = nonprod - loss.get(_goodput.IDLE, 0.0)
            frac = named / nonprod
            if frac < self.named_floor:
                return InvariantResult(
                    self.name, False,
                    f"only {frac:.0%} of {nonprod:.3f}s "
                    f"non-productive time named (< "
                    f"{self.named_floor:.0%}; totals: "
                    f"{ {k: round(v, 3) for k, v in loss.items() if v > 0} })",
                )
            detail += (
                f"; {frac:.0%} of {nonprod:.3f}s non-productive "
                f"time named"
            )
        return InvariantResult(self.name, True, detail)



class NoOrphanProcesses(Invariant):
    """No process whose cmdline or environment references the job's
    workdir survives the run — catches leaked trainers, forkserver
    children whose template died, and the local master (matched via
    its inherited env)."""

    name = "no_orphan_processes"

    def __init__(self, marker: str, grace_s: float = 5.0):
        self.marker = marker
        self.grace_s = grace_s

    def check(self, events, run):
        deadline = time.time() + self.grace_s
        leftovers = scan_processes(self.marker)
        while leftovers and time.time() < deadline:
            time.sleep(0.2)  # freshly-killed procs may linger a beat
            leftovers = scan_processes(self.marker)
        if leftovers:
            return InvariantResult(
                self.name, False, f"orphans: {leftovers}"
            )
        return InvariantResult(self.name, True, "no survivors")


def _ancestors(pid: int) -> List[int]:
    """pid plus its ppid chain up to init (a shell wrapper invoking
    the harness carries the workdir in ITS cmdline and must never be
    reported as an orphan)."""
    chain = []
    while pid > 1 and len(chain) < 64:
        chain.append(pid)
        fields = proc_stat_fields(pid)
        if fields is None:
            break
        try:
            pid = int(fields[1])  # ppid
        except (IndexError, ValueError):
            break
    chain.append(pid)
    return chain


def scan_processes(marker: str) -> List[int]:
    """Live (non-zombie) pids whose cmdline OR environment contains
    ``marker``, excluding this process and its ancestors.  The environ
    check is what catches a leaked local master: its argv carries no
    workdir, but it inherits ``DLROVER_SHARED_DIR=<workdir>/sock``."""
    skip = set(_ancestors(os.getpid()))
    out: List[int] = []
    marker_b = marker.encode()
    # stdlib runtime infrastructure legitimately outlives a run and
    # inherits the run's env (the harness's own multiprocessing
    # resource tracker, spawned lazily mid-run) — never an orphan
    infra = (b"resource_tracker", b"semaphore_tracker",
             b"multiprocessing.forkserver")
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        if pid in skip:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
            if any(tag in cmdline for tag in infra):
                continue
            matched = marker_b in cmdline
            if not matched:
                try:
                    with open(f"/proc/{pid}/environ", "rb") as f:
                        matched = marker_b in f.read()
                except OSError:  # other-user process: environ hidden
                    pass
            if not matched:
                continue
            fields = proc_stat_fields(pid)
            if fields is not None and fields[0] != b"Z":
                out.append(pid)
        except OSError:
            continue
    return out


def timeline_from_events(events: List[dict]) -> List[Tuple]:
    """Cross-run-comparable fault timeline from the event log:
    ``(seq, point, rule, action, step)`` per injection, ordered by
    emitting source then per-process seq (with step as tiebreak).
    Caveat: two processes with the SAME source both injecting (e.g. a
    future multi-agent partition) collide on (source, seq) — such
    scenarios need a per-process discriminator in the key before
    their timelines compare stably across runs."""
    inj = _injections(events)
    inj.sort(
        key=lambda e: (
            e.get("source", ""), e.get("seq", 0), e.get("step") or 0,
        )
    )
    return [
        (
            e.get("seq"), e.get("point"), e.get("rule"),
            e.get("action"), e.get("step"),
        )
        for e in inj
    ]


@dataclass
class ChaosRunReport:
    scenario: str
    seed: int
    rc: int
    workdir: str
    event_log: str
    events: List[dict] = field(default_factory=list)
    timeline: List[Tuple] = field(default_factory=list)
    invariants: List[InvariantResult] = field(default_factory=list)
    # flight recorder: the assembled job timeline + goodput-loss
    # attribution, ready-made for invariants and post-mortems (no
    # re-parsing of raw events)
    job_timeline: Optional[flight.JobTimeline] = None
    attribution: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.rc == 0 and all(r.ok for r in self.invariants)

    def summary(self) -> str:
        lines = [
            f"scenario {self.scenario!r} seed={self.seed} rc={self.rc}",
            f"events: {len(self.events)}  injections: "
            f"{len(self.timeline)}",
        ]
        for t in self.timeline:
            lines.append(f"  inject {t}")
        if self.attribution and self.attribution["loss_s"] > 0:
            lines.append(
                f"  goodput {self.attribution['goodput']:.4f}  "
                f"lost {self.attribution['loss_s']:.3f}s "
                f"{self.attribution['buckets']}"
            )
        for r in self.invariants:
            mark = "PASS" if r.ok else "FAIL"
            lines.append(f"  [{mark}] {r.name}: {r.detail}")
        lines.append("RESULT: " + ("PASS" if self.ok else "FAIL"))
        return "\n".join(lines)


class _patched_env:
    """Set env vars for the run, restore the previous values after —
    the harness runs inside long-lived test processes."""

    def __init__(self, values: Dict[str, str]):
        self._values = values
        self._saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        for k, v in self._values.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False


def _build_report(
    scenario, rc: int, workdir: str, event_log: str,
    extra_sources: Optional[List[str]] = None,
) -> ChaosRunReport:
    """Collect the run's event stream (master log + any agent-shipped
    logs), assemble the flight-recorder timeline and goodput-loss
    attribution, and wrap everything in a report — the single
    post-run ingestion path both harness flavours share."""
    sources = [event_log] + list(extra_sources or [])
    events = collect_events(sources)
    report = ChaosRunReport(
        scenario=scenario.name,
        seed=scenario.seed,
        rc=rc,
        workdir=workdir,
        event_log=event_log,
        events=events,
        timeline=timeline_from_events(events),
    )
    try:
        report.job_timeline = flight.assemble(events)
        report.attribution = flight.attribute_goodput_loss(
            report.job_timeline
        )
    except Exception:  # noqa: BLE001 - assembly bug must not hide
        # the raw events from the invariants
        logger.exception("flight-recorder assembly failed")
    return report


def default_invariants(
    total_steps: int, ckpt_every: int, workdir: str,
    goodput_named_floor: float = 0.0,
) -> List[Invariant]:
    """The full recovery set — appropriate for scenarios whose fault
    is expected to crash a worker.  Every recovery scenario also
    proves its goodput accounting CLOSES (conservation within 2% per
    incarnation); pass ``goodput_named_floor`` to additionally demand
    that fraction of non-productive time land in named categories."""
    return [
        WorkerRestarted(),
        RendezvousReconverged(),
        BoundedStepLoss(ckpt_interval=ckpt_every),
        TrainingCompleted(total_steps=total_steps),
        NoOrphanProcesses(marker=workdir),
        GoodputConservation(named_floor=goodput_named_floor),
    ]


# scenarios whose fault kills a worker and therefore must show the
# full restart/reconverge/step-loss trail; every other scenario's
# DESIRED outcome is "the job rides it out with no restart at all",
# so only completion + no-orphans apply
RECOVERY_SCENARIOS = frozenset({
    "kill-worker-midstep", "sigterm-worker-midstep",
})


def invariants_for_scenario(
    name: str, total_steps: int, ckpt_every: int, workdir: str,
    disk_every: Optional[int] = None,
) -> List[Invariant]:
    """The reference's selection, for the scenarios the port has."""
    if name in ("warm-template-import-kill",
                "warm-template-midspawn-kill"):
        return [
            EventRecorded("warm_fork_fallback"),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "shm-corrupt-storage-fallback":
        # full recovery trail PLUS the tier assertion; step loss is
        # bounded by the DISK interval (the shm interval's snapshot
        # was deliberately torn).  ``disk_every`` is the interval the
        # run ACTUALLY used (run_scenario passes its resolved value);
        # standalone callers fall back to the scenario's RUN_OPTIONS
        if not disk_every:
            disk_every = RUN_OPTIONS.get(name, {}).get("disk_every", 0)
        return [
            WorkerRestarted(),
            RendezvousReconverged(),
            BoundedStepLoss(ckpt_interval=max(ckpt_every, disk_every)),
            RestoredFromTier("storage"),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "trainer-hang-detected":
        # the deep-diagnosis trail: evidence captured, hung verdict
        # with stacks + measured stall, ONLY the culprit restarted,
        # bounded loss, completion — and the loss attribution books
        # the stall under the hang bucket with real durations
        return [
            HangDiagnosed(within_s=30.0),
            OnlyCulpritRestarted(culprit_rank=0),
            BoundedStepLoss(ckpt_interval=ckpt_every),
            TrainingCompleted(total_steps=total_steps),
            GoodputLossAttributed(
                min_attributed_frac=0.75,
                expect_cause=flight.CAUSE_HANG,
            ),
            NoOrphanProcesses(marker=workdir),
        ]
    if name in RECOVERY_SCENARIOS:
        # the worker-kill trail must also NAME >=90% of its
        # non-productive time (death witness -> rendezvous ->
        # restore -> first step), not dump it in idle_unattributed
        return default_invariants(
            total_steps, ckpt_every, workdir,
            goodput_named_floor=0.9,
        )
    return [
        TrainingCompleted(total_steps=total_steps),
        NoOrphanProcesses(marker=workdir),
    ]


def check_invariants(
    report: ChaosRunReport, checks: Sequence[Invariant]
) -> ChaosRunReport:
    """Evaluate ``checks`` on the report's events into
    ``report.invariants`` (a checker that crashes is a FAIL)."""
    for inv in checks:
        try:
            report.invariants.append(inv.check(report.events, report))
        except Exception as e:  # noqa: BLE001 - a checker bug is a FAIL
            logger.exception("invariant %s crashed", inv.name)
            report.invariants.append(
                InvariantResult(inv.name, False, f"checker crashed: {e}")
            )
    return report


def scenario_env(
    scenario, workdir: str, total_steps: int, ckpt_every: int,
    disk_every: int = 0,
    extra_env: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, str], str]:
    """The env a run of ``scenario`` under ``workdir`` exports (the
    scenario file, the event log, the loop's knobs, a socket dir and
    metrics file of the run's own, no ambient master) and the event
    log's path.  Writes the scenario file."""
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    event_log = os.path.join(workdir, "events.jsonl")
    opts = RUN_OPTIONS.get(scenario.name, {})
    env = {
        _chaos.CHAOS_ENV: spec_path,
        EVENT_LOG_ENV: event_log,
        TOTAL_STEPS_ENV: str(total_steps),
        CKPT_EVERY_ENV: str(ckpt_every),
        "DLROVER_SHARED_DIR": os.path.join(workdir, "sock"),
        "DLROVER_METRICS_FILE": os.path.join(workdir, "metrics.json"),
        # isolation: an ambient master address (a previous in-process
        # run, an outer job) must not hijack this mini-cluster — empty
        # means "spawn a fresh local master"
        "DLROVER_MASTER_ADDR": "",
    }
    if disk_every:
        env[DISK_EVERY_ENV] = str(disk_every)
    env.update(opts.get("extra_env", {}))
    if extra_env:
        env.update(extra_env)
    return env, event_log


def launch(
    scenario, env: Dict[str, str], script_argv: List[str],
    max_restarts: int = 2, monitor_interval: float = 0.3,
    warm_restart: bool = False,
) -> int:
    """Run ``script_argv`` (the script and its arguments) under the
    launcher in this process with ``env`` exported and ``scenario``
    armed here too (the agent, its saver and monitors run in this
    process, and their hook points must see the scenario; ``None``
    arms nothing here); returns the launcher's exit code."""
    argv = [
        "--nproc_per_node=1",
        f"--max_restarts={max_restarts}",
        f"--monitor_interval={monitor_interval}",
    ]
    if warm_restart:
        argv.append("--warm-restart")
    argv += list(script_argv)

    from dlrover_tpu_torch import run as launcher

    with _patched_env(env):
        if scenario is not None:
            _chaos.install(scenario)
        try:
            return launcher.main(argv)
        finally:
            _chaos.uninstall()


def run_scenario(
    scenario,
    workdir: str,
    total_steps: Optional[int] = None,
    ckpt_every: Optional[int] = None,
    max_restarts: int = 2,
    monitor_interval: float = 0.3,
    warm_restart: bool = False,
    invariants: Optional[List[Invariant]] = None,
    disk_every: Optional[int] = None,
    extra_env: Optional[Dict[str, str]] = None,
) -> ChaosRunReport:
    """Run ``scenario`` against a fresh single-node mini-cluster under
    ``workdir`` and evaluate the invariants.  With ``invariants=None``
    the set is chosen by scenario name (recovery scenarios get the
    full restart trail, ride-it-out scenarios completion+no-orphans);
    pass ``invariants=[]`` to skip checking entirely.

    ``total_steps``/``ckpt_every``/``disk_every`` (durable mid-run
    saves), ``warm_restart`` and ``extra_env`` default to the
    scenario's entry in :data:`scenarios.RUN_OPTIONS`, so named
    scenarios run correctly from the CLI and tests alike.  The
    reference re-measures a run once when only its wall-clock-ceiling
    invariants failed; those invariants (the compile-cache ones) come
    with slice 8 of the port."""
    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    if total_steps is None:
        total_steps = int(opts.get("total_steps", 10))
    if ckpt_every is None:
        ckpt_every = int(opts.get("ckpt_every", 2))
    if disk_every is None:
        disk_every = int(opts.get("disk_every", 0))
    warm_restart = warm_restart or bool(opts.get("warm_restart"))
    env, event_log = scenario_env(
        scenario, workdir, total_steps, ckpt_every,
        disk_every=disk_every, extra_env=extra_env,
    )
    # the reference selects among its toy loops by RUN_OPTIONS'
    # "train_script"; the sparse, resize, serving and RL loops come with
    # later slices of the port, so every scenario runs the GPT loop
    script = os.path.join(workdir, "chaos_train.py")
    with open(script, "w") as f:
        f.write(CHAOS_TRAIN_SCRIPT)
    rc = launch(
        scenario, env, [script, os.path.join(workdir, "ckpt")],
        max_restarts=max_restarts, monitor_interval=monitor_interval,
        warm_restart=warm_restart,
    )
    report = _build_report(scenario, rc, workdir, event_log)
    checks = (
        invariants if invariants is not None
        else invariants_for_scenario(
            scenario.name, total_steps, ckpt_every, workdir,
            disk_every=disk_every,
        )
    )
    return check_invariants(report, checks)
