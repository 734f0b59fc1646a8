"""Job flight recorder: assemble per-process event streams into one
causally-ordered timeline, render it, and diagnose goodput loss.

Copy of ``dlrover_tpu/telemetry/timeline.py`` (the port imports
nothing of the JAX package).

PRs 1–4 made every subsystem *emit* — spans, schema-versioned JSONL
events, ``node_rank``-tagged multinode streams — but a stalled
rendezvous or a goodput dip under churn is only debuggable from the
*assembled* picture.  This module is that assembly step (role of the
reference's diagnosis/"Brain" layer turning raw runtime signals into
decisions):

- :func:`~dlrover_tpu_torch.telemetry.events.collect_events` ingests the
  master's event log plus every agent log matching
  ``DLROVER_EVENTS_AGGREGATE_GLOB`` (agents ship event JSONL the same
  way textfile metric dumps ride ``DLROVER_METRICS_AGGREGATE_GLOB``);
- :func:`assemble` derives *slices* (timed intervals: rendezvous
  rounds, restart recoveries, checkpoint save/persist/restore tiers,
  shard leases, master crash recoveries) and *instants* (chaos
  injections, preemption notices, loss spikes) per node and
  incarnation;
- :func:`to_chrome_trace` renders Chrome trace-event JSON loadable in
  Perfetto / ``chrome://tracing``; :func:`to_report` a plain-text
  incident report; the master serves both at ``/timeline`` next to
  ``/metrics``;
- :func:`attribute_goodput_loss` runs the rule pass that attributes
  every non-training second of the ``[first_step, last_step]`` window
  to a cause bucket (``rendezvous`` / ``restore`` /
  ``master_recovery`` / ``straggler`` / ``unattributed``), emits the
  ``goodput_attribution`` event + ``dlrover_goodput_loss_seconds``
  gauges, and feeds the Brain datastore
  (:func:`dlrover_tpu_torch.brain.cluster_monitor.record_goodput_attribution`)
  so diagnosis consumes the same numbers the operator sees.

CLI::

    python -m dlrover_tpu_torch.telemetry.timeline events.jsonl \
        --glob '/shared/events_node*.jsonl' --chrome trace.json
"""

import json
import os
import statistics
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.telemetry.events import (
    EVENT_LOG_ENV,
    EVENTS_AGGREGATE_ENV,
    collect_events,
    emit_event,
    iter_collect_events,
)
from dlrover_tpu_torch.telemetry.metrics import get_registry

# cause buckets, in attribution priority order: when slices overlap a
# lost interval, the more specific cause wins the overlap.  A resize
# window (decision -> first step of the re-formed world) claims FIRST:
# the restores/rendezvous/restarts inside it happened BECAUSE of the
# resize, and booking them separately would hide what capacity changes
# actually cost.
CAUSE_RESIZE = "resize"
CAUSE_RESTORE = "restore"
CAUSE_MASTER_RECOVERY = "master_recovery"
CAUSE_HANG = "hang"
CAUSE_RENDEZVOUS = "rendezvous"
CAUSE_STRAGGLER = "straggler"
CAUSE_UNATTRIBUTED = "unattributed"
CAUSE_PRIORITY = (
    CAUSE_RESIZE, CAUSE_RESTORE, CAUSE_MASTER_RECOVERY, CAUSE_HANG,
    CAUSE_RENDEZVOUS, CAUSE_STRAGGLER,
)
# resize phases as they appear on the assembled timeline (the
# dlrover_resize_seconds breakdown): derived per resize_decision from
# the raw event trail
RESIZE_PHASES = (
    "decide", "drain", "rendezvous", "reshard_restore", "first_step",
)

# span name -> cause category for span-derived slices
_SPAN_CATEGORIES = {
    "rdzv.join": CAUSE_RENDEZVOUS,
    "node_check": CAUSE_RENDEZVOUS,
    "ckpt.restore": CAUSE_RESTORE,
    "journal.replay": CAUSE_MASTER_RECOVERY,
}
# a restart-recovery window that is not restore/rendezvous is loss
# with no finer-grained witness; it stays in its own display category
CAT_RESTART = "restart"
CAT_CHECKPOINT = "checkpoint"
CAT_SHARD = "shard_lease"
CAT_STEP = "train_step"
# serving plane (train-to-serve publication): publish slices on the
# trainer side, ingest slices on the replica side — display
# categories (serving work is not training goodput loss)
CAT_SERVING = "serving"
# elastic RL plane: per-iteration phase anatomy (rollout / score /
# gae / train) from rl_iteration events — a DISPLAY category outside
# CAUSE_PRIORITY (RL phases are productive work, not loss; recovery
# seconds stay booked under restart/restore/rendezvous)
CAT_RL = "rl_phase"
# phase order of one PPO iteration, laid backward from the event ts
RL_PHASES = ("rollout", "score", "gae", "train")
# the measured death->first-step budget from the trainer-side
# RecoveryProfiler: per-phase sub-slices of a restart window.  A
# DISPLAY category, deliberately outside CAUSE_PRIORITY: the same
# seconds are already claimed by the restart/restore/rendezvous
# buckets, and attributing them again would double-book the loss.
CAT_RECOVERY_PHASE = "recovery_phase"
# phase order of one recovery budget (mirrors
# dlrover_recovery_phase_seconds{phase})
RECOVERY_PHASES = (
    "spawn", "import", "restore", "aot", "retrace", "first_step",
)

# how long after master_recovered a session resync still counts as
# part of the same recovery (parked clients trickle back)
_RESYNC_WINDOW_S = 30.0


@dataclass
class Slice:
    """One timed interval on a track."""

    name: str
    cat: str
    start: float
    end: float
    track: str
    meta: Dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)


@dataclass
class JobTimeline:
    """The assembled flight-recorder view of one job."""

    events: List[Dict] = field(default_factory=list)
    slices: List[Slice] = field(default_factory=list)
    instants: List[Dict] = field(default_factory=list)
    # per-node-track sorted train_step timestamps
    steps_by_track: Dict[str, List[float]] = field(
        default_factory=dict
    )
    # (first train_step ts, last train_step ts) across all nodes
    window: Optional[Tuple[float, float]] = None
    master_incarnations: int = 0

    def slices_by_cat(self, cat: str) -> List[Slice]:
        return [s for s in self.slices if s.cat == cat]


def _track_of(e: Dict) -> str:
    source = e.get("source") or "unknown"
    if source == "master":
        return "master"
    rank = e.get("node_rank")
    if rank is None:
        return source
    return f"{source} node{rank}"


def _num(value, default=0.0) -> float:
    return (
        float(value) if isinstance(value, (int, float)) else default
    )


def assemble(events: Iterable[Dict]) -> JobTimeline:
    """Merge an event stream (already ts-ordered; see
    :func:`collect_events`) into slices + instants."""
    tl = JobTimeline(events=list(events))
    ev = tl.events
    steps: Dict[str, List[float]] = {}
    incarnation = 0  # master incarnations seen so far

    # pass 1: instants, step tracks, simple duration-carrying events
    for e in ev:
        etype = e.get("type")
        ts = _num(e.get("ts"))
        track = _track_of(e)
        if etype == "train_step":
            steps.setdefault(track, []).append(ts)
            continue
        if etype in ("chaos_inject", "loss_spike",
                     "diagnosis_verdict", "hang_evidence",
                     "rpc_slo_breach", "compile_cache", "aot_cache",
                     "fleet_report", "fleet_capacity",
                     "serving_freshness", "serving_lookup_stats",
                     "replica_status"):
            tl.instants.append(e)
            continue
        if etype == "serving_route":
            # one routed-traffic window on the serving fleet track:
            # the router emits at window END with the window length
            win = _num(e.get("window_s"))
            tl.slices.append(Slice(
                name=(
                    f"route window {e.get('count')} lookups "
                    f"gen>={e.get('generation_floor')}"
                ),
                cat=CAT_SERVING,
                start=ts - win, end=ts, track="serving fleet",
                meta={k: e.get(k) for k in (
                    "count", "qps", "p50_ms", "p99_ms", "ok",
                    "rerouted", "stale", "failed", "members_up",
                    "members_draining", "members_suspect",
                    "generation_floor", "hedged",
                ) if e.get(k) is not None},
            ))
            continue
        if etype in ("serving_publish", "serving_ingest"):
            secs = _num(e.get("seconds"))
            side = (
                "publish" if etype == "serving_publish" else "ingest"
            )
            name = (
                f"serving {side}[{e.get('kind')}] "
                f"gen {e.get('generation')}"
            )
            tl.slices.append(Slice(
                name=name,
                cat=CAT_SERVING,
                start=ts - secs, end=ts,
                track=(
                    "serving replica" if side == "ingest" else track
                ),
                meta={k: e.get(k) for k in (
                    "generation", "kind", "rows", "dead_rows",
                    "step", "freshness_s", "delta_ratio",
                ) if e.get(k) is not None},
            ))
            continue
        if etype == "rl_iteration":
            # emitted when a PPO iteration's train phase completes:
            # lay the phase slices end-to-end BACKWARD from the event
            # timestamp (train abuts ts, gae/score/rollout precede
            # it), one slice per phase that measured nonzero
            end = ts
            for phase in reversed(RL_PHASES):
                secs = _num(e.get(f"{phase}_s"))
                if secs <= 0:
                    continue
                tl.slices.append(Slice(
                    name=f"rl[{phase}] iter {e.get('iteration')}",
                    cat=CAT_RL,
                    start=end - secs, end=end,
                    track=track,
                    meta={k: e.get(k) for k in (
                        "iteration", "leases", "actor_loss",
                        "critic_loss", "restart_count",
                    ) if e.get(k) is not None},
                ))
                end -= secs
            continue
        if etype == "recovery_phase":
            # emitted at phase END with the measured duration: the
            # recovery-breakdown slice set under the restart window
            secs = _num(e.get("seconds"))
            tl.slices.append(Slice(
                name=(
                    f"recovery[{e.get('phase')}] "
                    f"#{e.get('restart_count')}"
                ),
                cat=CAT_RECOVERY_PHASE,
                start=ts - secs, end=ts, track=track,
                meta={
                    "phase": e.get("phase"),
                    "restart_count": e.get("restart_count"),
                    "node_rank": e.get("node_rank"),
                },
            ))
            continue
        if etype == "span":
            name = str(e.get("name", ""))
            dur = _num(e.get("duration_s"))
            cat = _SPAN_CATEGORIES.get(name)
            if cat is None or dur <= 0:
                continue
            # span events are emitted at completion: ts is the end
            tl.slices.append(Slice(
                name=name, cat=cat, start=ts - dur, end=ts,
                track=track,
                meta={k: e.get(k) for k in (
                    "trace_id", "span_id", "parent_id", "status",
                )},
            ))
            continue
        if etype == "rendezvous_complete":
            wait = _num(e.get("wait_s"))
            tl.slices.append(Slice(
                name=f"rdzv {e.get('rdzv')} round {e.get('round')}",
                cat=CAUSE_RENDEZVOUS,
                start=ts - wait, end=ts, track="master",
                meta={"nodes": e.get("nodes"),
                      "round": e.get("round")},
            ))
            continue
        if etype == "checkpoint_restore":
            total = _num(e.get("total_s"))
            # sparse restores carry a kv stage (KvVariable import /
            # cross-world reshard) — surface it on the slice so a
            # sparse job's recovery breakdown shows where the hash
            # table went back in
            kv_rows = e.get("kv_rows")
            name = f"restore[{e.get('tier')}] step {e.get('step')}"
            if kv_rows:
                name += " +kv"
            tl.slices.append(Slice(
                name=name,
                cat=CAUSE_RESTORE,
                start=ts - total, end=ts, track=track,
                meta={k: e.get(k) for k in (
                    "tier", "step", "read_s", "assemble_s", "h2d_s",
                    "kv_s", "kv_rows", "kv_resharded",
                ) if e.get(k) is not None},
            ))
            continue
        if etype == "checkpoint_shm_save":
            total = _num(e.get("total_s"))
            tl.slices.append(Slice(
                name=f"shm save step {e.get('step')}",
                cat=CAT_CHECKPOINT,
                start=ts - total, end=ts, track=track,
                meta={"step": e.get("step")},
            ))
            continue
        if etype == "checkpoint_persist":
            secs = _num(e.get("seconds"))
            tl.slices.append(Slice(
                name=f"persist step {e.get('step')} "
                f"({'ok' if e.get('ok') else 'FAILED'})",
                cat=CAT_CHECKPOINT,
                start=ts - secs, end=ts, track=track,
                meta={"step": e.get("step"), "ok": e.get("ok")},
            ))
            continue

    # pass 2: paired intervals that need lookahead
    _assemble_restarts(ev, tl)
    _assemble_master_recoveries(ev, tl)
    _assemble_shard_leases(ev, tl)
    _assemble_resizes(ev, tl)

    tl.steps_by_track = {k: sorted(v) for k, v in steps.items()}
    all_steps = sorted(
        ts for track in tl.steps_by_track.values() for ts in track
    )
    if all_steps:
        tl.window = (all_steps[0], all_steps[-1])
    tl.master_incarnations = 1 + sum(
        1 for e in ev if e.get("type") == "master_recovered"
    )
    tl.slices.sort(key=lambda s: (s.start, s.track))
    return tl


def _assemble_restarts(ev: List[Dict], tl: JobTimeline):
    """``worker_restart`` → first ``train_step`` of that incarnation
    on the same node = the data-plane recovery window."""
    for i, e in enumerate(ev):
        if e.get("type") != "worker_restart":
            continue
        rank = e.get("node_rank")
        count = e.get("restart_count")
        start = _num(e.get("ts"))
        end = None
        for later in ev[i + 1:]:
            if (
                later.get("type") == "train_step"
                and later.get("node_rank") == rank
                and later.get("restart_count") == count
            ):
                end = _num(later.get("ts"))
                break
        tl.slices.append(Slice(
            name=f"restart #{count} node{rank}",
            cat=CAT_RESTART,
            start=start,
            end=end if end is not None else start,
            track=f"agent node{rank}" if rank is not None else "agent",
            meta={"restart_count": count, "node_rank": rank,
                  "resumed": end is not None},
        ))


def _assemble_master_recoveries(ev: List[Dict], tl: JobTimeline):
    """Control-plane outage window per ``master_recovered``: from the
    last witness of the dying master (its kill injection, the
    watchdog's respawn record, or a graceful ``master_exit``) to the
    recovery — extended over the session-resync trickle of parked
    clients."""
    for i, e in enumerate(ev):
        if e.get("type") != "master_recovered":
            continue
        rec_ts = _num(e.get("ts"))
        start = rec_ts
        for earlier in reversed(ev[:i]):
            etype = earlier.get("type")
            ts = _num(earlier.get("ts"))
            if etype == "master_recovered":
                break  # an older recovery's territory
            # NOT time-bounded: a long outage (respawn backoff, big
            # journal replay) must still find its death witness, or
            # the whole gap lands in 'unattributed'
            if etype in ("master_respawn", "master_exit") or (
                etype == "chaos_inject"
                and earlier.get("action") == "kill"
                and str(earlier.get("point", "")).startswith("master.")
            ):
                # keep scanning: the EARLIEST witness of the death
                # (the kill injection precedes the watchdog's respawn
                # record) bounds the true outage
                start = min(start, ts)
        end = rec_ts
        for later in ev[i + 1:]:
            ts = _num(later.get("ts"))
            if ts - rec_ts > _RESYNC_WINDOW_S:
                break
            if later.get("type") in ("agent_resync", "master_resync"):
                end = max(end, ts)
        tl.slices.append(Slice(
            name=f"master recovery #{e.get('recoveries')}",
            cat=CAUSE_MASTER_RECOVERY,
            start=min(start, rec_ts), end=end, track="master",
            meta={
                "recoveries": e.get("recoveries"),
                "entries": e.get("entries"),
                "requeued": e.get("requeued"),
                "incarnation": e.get("incarnation"),
            },
        ))


def _assemble_resizes(ev: List[Dict], tl: JobTimeline):
    """Per ``resize_decision``: the five-phase breakdown of one
    elastic world-resize, derived from the raw event trail —

    - **decide**: lost node's last sign of life (``detected_ts``) →
      the decision event;
    - **drain**: decision → the last ``worker_restart`` before the
      round completes (survivors stopping their old-world workers);
    - **rendezvous**: drain end → the first elastic-training
      ``rendezvous_complete`` whose world has exactly ``target``
      nodes;
    - **reshard_restore**: round completion → the last
      ``checkpoint_restore`` of the re-formed world (the shards being
      re-distributed onto the new mesh);
    - **first_step**: restore end → the first ``train_step`` after it.

    This is the timeline face of ``dlrover_resize_seconds``; the
    master's coordinator observes decide/rendezvous/first_step live,
    the agent/trainer-side phases only exist here."""
    for i, e in enumerate(ev):
        if e.get("type") != "resize_decision":
            continue
        target = e.get("target")
        decided = _num(e.get("ts"))
        detected = _num(e.get("detected_ts"), decided) or decided
        # the resize ends at the round that reconverged at target
        round_ts = None
        for later in ev[i + 1:]:
            if later.get("type") == "resize_decision":
                break  # superseded before completing
            if (
                later.get("type") == "rendezvous_complete"
                and later.get("rdzv") == "elastic-training"
                and len(later.get("nodes") or []) == target
            ):
                round_ts = _num(later.get("ts"))
                break
        end_of = {"decide": decided}
        bound = round_ts if round_ts is not None else float("inf")
        drain_end = decided
        for later in ev[i + 1:]:
            ts = _num(later.get("ts"))
            if ts > bound:
                break
            if later.get("type") == "resize_decision":
                break  # superseded: later restarts belong to it
            if later.get("type") == "worker_restart":
                drain_end = max(drain_end, ts)
        if drain_end > decided:
            end_of["drain"] = drain_end
        if round_ts is not None:
            end_of["rendezvous"] = round_ts
            restore_end = round_ts
            step_ts = None
            for later in ev[i + 1:]:
                ts = _num(later.get("ts"))
                if ts <= round_ts:
                    continue
                etype = later.get("type")
                if etype == "resize_decision":
                    break
                if etype == "checkpoint_restore" and step_ts is None:
                    restore_end = max(restore_end, ts)
                elif etype == "train_step" and ts >= restore_end:
                    step_ts = ts
                    break
            if restore_end > round_ts:
                end_of["reshard_restore"] = restore_end
            if step_ts is not None:
                end_of["first_step"] = step_ts
        start = detected
        for phase in RESIZE_PHASES:
            end = end_of.get(phase)
            if end is None:
                continue
            tl.slices.append(Slice(
                name=f"resize[{phase}] →{target}",
                cat=CAUSE_RESIZE,
                start=min(start, end), end=end, track="master",
                meta={
                    "phase": phase,
                    "target": target,
                    "from_world": e.get("from_world"),
                    "reason": e.get("reason"),
                },
            ))
            start = end


def recovery_budgets(
    events: Iterable[Dict],
) -> Dict[Tuple[int, int], Dict]:
    """Per-incarnation recovery budget from the raw event stream:
    ``{(node_rank, restart_count): {phase: seconds, ...,
    "compile_cache_hit": bool?, "retrace_s": float?}}`` — the single
    ingestion path the incident report, bench.py and the chaos
    cache-hit invariants all read, so they can never disagree about
    what was measured."""
    out: Dict[Tuple[int, int], Dict] = {}
    for e in events:
        etype = e.get("type")
        if etype == "recovery_phase":
            key = (
                int(_num(e.get("node_rank"), -1)),
                int(_num(e.get("restart_count"), -1)),
            )
            out.setdefault(key, {})[str(e.get("phase"))] = _num(
                e.get("seconds")
            )
        elif etype == "compile_cache":
            key = (
                int(_num(e.get("node_rank"), -1)),
                int(_num(e.get("restart_count"), -1)),
            )
            rec = out.setdefault(key, {})
            rec["compile_cache_hit"] = bool(e.get("hit"))
            if e.get("status") is not None:
                rec["compile_cache_status"] = str(e.get("status"))
            if e.get("retrace_s") is not None:
                rec["retrace_s"] = _num(e.get("retrace_s"))
        elif etype == "aot_cache":
            key = (
                int(_num(e.get("node_rank"), -1)),
                int(_num(e.get("restart_count"), -1)),
            )
            rec = out.setdefault(key, {})
            rec["aot_cache_hit"] = bool(e.get("hit"))
            if e.get("load_s") is not None:
                rec["aot_load_s"] = _num(e.get("load_s"))
    return out


def _assemble_shard_leases(ev: List[Dict], tl: JobTimeline):
    """``shard_dispatch`` → matching ``shard_ack`` lease windows (the
    master's view of outstanding work)."""
    open_leases: Dict[Tuple[str, int], Dict] = {}
    for e in ev:
        etype = e.get("type")
        if etype == "shard_dispatch":
            key = (str(e.get("dataset")), int(_num(e.get("task_id"))))
            open_leases[key] = e
        elif etype == "shard_ack":
            key = (str(e.get("dataset")), int(_num(e.get("task_id"))))
            d = open_leases.pop(key, None)
            if d is None:
                continue
            tl.slices.append(Slice(
                name=f"shard {key[1]} w{e.get('worker')}",
                cat=CAT_SHARD,
                start=_num(d.get("ts")), end=_num(e.get("ts")),
                track="master",
                meta={
                    "dataset": key[0], "task_id": key[1],
                    "worker": e.get("worker"),
                    "success": e.get("success"),
                },
            ))


def assemble_windows(
    sources,
    window_s: float = 3600.0,
    reorder_window: int = 1024,
) -> "Iterable[Tuple[float, JobTimeline]]":
    """Windowed assembly for multi-day logs: stream the merged event
    logs (:func:`~dlrover_tpu_torch.telemetry.events.iter_collect_events`)
    and yield ``(window_start_ts, JobTimeline)`` per ``window_s``
    chunk — peak memory is one window's events, never the whole
    history.

    ``sources`` is a list of paths/globs, or any iterator of event
    dicts (already ts-ordered).  Pairings that span a window boundary
    (a restart recovering in the next window, an unacked shard lease)
    degrade to open-ended slices inside their window — the price of
    bounded memory; pick ``window_s`` well above the longest recovery
    you care about."""
    if hasattr(sources, "__next__"):
        it = sources
    elif sources and isinstance(next(iter(sources), None), dict):
        it = iter(sources)
    else:
        it = iter_collect_events(
            sources, reorder_window=reorder_window
        )
    buf: List[Dict] = []
    w_start: Optional[float] = None
    for e in it:
        ts = _num(e.get("ts"))
        if w_start is None:
            w_start = ts
        if ts - w_start >= window_s and buf:
            yield w_start, assemble(buf)
            buf = []
            w_start = ts
        buf.append(e)
    if buf:
        yield w_start or 0.0, assemble(buf)


# -- interval arithmetic (attribution) -------------------------------------


def _union(intervals: List[Tuple[float, float]]):
    out: List[Tuple[float, float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect(xs, ys):
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys):
    out = []
    for a, b in xs:
        cur = a
        for c, d in ys:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _total(xs) -> float:
    return sum(b - a for a, b in xs)


def attribute_goodput_loss(tl: JobTimeline) -> Dict:
    """The rule pass: every non-training second of the
    ``[first_step, last_step]`` window lands in exactly one cause
    bucket, so the buckets sum to the measured loss.

    Training coverage = the union over nodes of inter-step intervals
    whose gap is ≤ 3× that node's median step gap (the same
    silence-detection rule the master's SpeedMonitor uses); the
    window's complement is lost time.  Cause slices claim their
    overlap in priority order (restore > master recovery > rendezvous
    > straggler); the remainder is ``unattributed``."""
    buckets = {c: 0.0 for c in CAUSE_PRIORITY}
    buckets[CAUSE_UNATTRIBUTED] = 0.0
    out = {
        "window_start": 0.0, "window_end": 0.0, "window_s": 0.0,
        "training_s": 0.0, "loss_s": 0.0, "goodput": 1.0,
        "buckets": buckets,
    }
    if tl.window is None:
        return out
    w0, w1 = tl.window
    out["window_start"], out["window_end"] = w0, w1
    out["window_s"] = round(w1 - w0, 6)
    if w1 <= w0:
        return out
    training: List[Tuple[float, float]] = []
    for track_steps in tl.steps_by_track.values():
        gaps = [
            b - a for a, b in zip(track_steps, track_steps[1:])
            if b > a
        ]
        if not gaps:
            continue
        med = statistics.median(gaps)
        cutoff = 3.0 * med if med > 0 else 0.0
        for a, b in zip(track_steps, track_steps[1:]):
            if b - a <= cutoff:
                training.append((a, b))
    training = _intersect(_union(training), [(w0, w1)])
    lost = _subtract([(w0, w1)], training)
    loss_total = _total(lost)
    out["training_s"] = round(_total(training), 6)
    out["loss_s"] = round(loss_total, 6)
    out["goodput"] = round(
        _total(training) / (w1 - w0), 4
    ) if w1 > w0 else 1.0
    # straggler/hang witnesses carry MEASURED durations now: the
    # verdict's duration_s (excess time for a straggler, stall for a
    # hang) and the agent watchdog's stall_s give real claim windows
    # ending at the event; a legacy verdict/injection without a
    # duration falls back to a nominal 1 s
    straggler_iv = []
    hang_iv = []
    for e in tl.events:
        etype = e.get("type")
        ts = _num(e.get("ts"))
        if etype == "diagnosis_verdict":
            dur = _num(e.get("duration_s")) or _num(
                e.get("stall_s")
            )
            if e.get("hung"):
                if dur > 0:
                    hang_iv.append((ts - dur, ts))
            elif e.get("action") == "isolate":
                straggler_iv.append((ts - (dur or 1.0), ts))
        elif etype == "hang_evidence":
            stall = _num(e.get("stall_s"))
            if stall > 0:
                hang_iv.append((ts - stall, ts))
        elif (
            etype == "chaos_inject" and e.get("action") == "slow"
        ):
            straggler_iv.append((ts - 1.0, ts))
    cause_iv = {
        CAUSE_RESIZE: [
            (s.start, s.end) for s in tl.slices_by_cat(CAUSE_RESIZE)
        ],
        CAUSE_RESTORE: [
            (s.start, s.end) for s in tl.slices_by_cat(CAUSE_RESTORE)
        ],
        CAUSE_MASTER_RECOVERY: [
            (s.start, s.end)
            for s in tl.slices_by_cat(CAUSE_MASTER_RECOVERY)
        ],
        CAUSE_HANG: hang_iv,
        CAUSE_RENDEZVOUS: [
            (s.start, s.end)
            for s in tl.slices_by_cat(CAUSE_RENDEZVOUS)
        ] + [
            # a restart-recovery window is rendezvous-bound loss
            # between the worker death and the re-join completing
            (s.start, s.end) for s in tl.slices_by_cat(CAT_RESTART)
        ],
        CAUSE_STRAGGLER: straggler_iv,
    }
    remaining = lost
    for cause in CAUSE_PRIORITY:
        claimed = _intersect(_union(cause_iv[cause]), remaining)
        buckets[cause] = round(_total(claimed), 6)
        remaining = _subtract(remaining, claimed)
    buckets[CAUSE_UNATTRIBUTED] = round(_total(remaining), 6)
    return out


def publish_attribution(attr: Dict, registry=None) -> None:
    """Write the diagnosis where operators and the control plane both
    read it: ``dlrover_goodput_loss_seconds{cause}`` gauges + the
    ``goodput_attribution`` event."""
    reg = registry or get_registry()
    gauge = reg.gauge(
        "dlrover_goodput_loss_seconds",
        "Non-training seconds of the [first_step, last_step] window "
        "by attributed cause",
    )
    for cause, seconds in attr["buckets"].items():
        gauge.set(seconds, cause=cause)
    emit_event(
        "goodput_attribution",
        window_start=attr["window_start"],
        window_end=attr["window_end"],
        window_s=attr["window_s"],
        training_s=attr["training_s"],
        loss_s=attr["loss_s"],
        goodput=attr["goodput"],
        buckets=attr["buckets"],
    )


# -- renderers -------------------------------------------------------------


def _describe_instant(e: Dict) -> str:
    """One-line description of an instant event for both renderers."""
    etype = e.get("type")
    if etype == "chaos_inject":
        return (
            f"{e.get('action')}@{e.get('point')} step={e.get('step')}"
        )
    if etype == "diagnosis_verdict":
        kind = e.get("verdict") or e.get("action")
        out = f"verdict={kind} culprit={e.get('culprit_node')}"
        stall = e.get("stall_s") or e.get("duration_s")
        if isinstance(stall, (int, float)) and stall > 0:
            out += f" {stall:.1f}s"
        return out
    if etype == "hang_evidence":
        return (
            f"stall={_num(e.get('stall_s')):.1f}s "
            f"last_step={e.get('last_step')}"
        )
    if etype == "rpc_slo_breach":
        return (
            f"{e.get('verb')} {e.get('quantile')}="
            f"{_num(e.get('observed_s')):.3f}s > "
            f"{_num(e.get('threshold_s')):.3f}s"
        )
    if etype == "compile_cache":
        status = e.get("status")
        return (
            f"{'HIT' if e.get('hit') else 'MISS'} "
            + (f"({status}) " if status else "")
            + f"restart#{e.get('restart_count')} "
            f"retrace={_num(e.get('retrace_s')):.3f}s "
            f"entries {e.get('entries_before')}->"
            f"{e.get('entries_after')}"
        )
    if etype == "aot_cache":
        return (
            f"{'HIT' if e.get('hit') else 'MISS'} "
            f"restart#{e.get('restart_count')} "
            f"load={_num(e.get('load_s')):.3f}s "
            f"trace={_num(e.get('trace_s')):.3f}s "
            f"wrote={bool(e.get('wrote'))}"
        )
    if etype == "serving_freshness":
        return (
            f"gen {e.get('generation')} servable "
            f"{_num(e.get('freshness_s')):.3f}s after train commit "
            f"(lag {e.get('lag_generations', 0)} gen)"
        )
    if etype == "serving_lookup_stats":
        return (
            f"{e.get('count')} lookup batch(es) "
            f"p50={_num(e.get('p50_ms')):.2f}ms "
            f"p99={_num(e.get('p99_ms')):.2f}ms "
            f"@ {_num(e.get('qps')):.0f} batch/s "
            f"gen {e.get('generation')}"
        )
    if etype == "replica_status":
        return (
            f"replica {e.get('replica_id')} "
            f"{e.get('state')} gen {e.get('generation')}"
            + (" (respawned)" if e.get("respawned") else "")
        )
    if etype == "fleet_report":
        return (
            f"{e.get('agents')} agents {_num(e.get('rps')):.0f} "
            f"rps breaches={e.get('breaches', 0)} "
            f"inflight={_num(e.get('inflight')):.0f} "
            f"journal_p99={_num(e.get('journal_append_p99_ms')):.1f}"
            "ms"
        )
    if etype == "fleet_capacity":
        return (
            f"max sustained {e.get('max_sustained_agents')} agents "
            f"@ {_num(e.get('rps_at_capacity')):.0f} rps "
            f"(first breach at {e.get('first_breach_agents')})"
        )
    return f"step={e.get('step')}"


def to_chrome_trace(
    tl: JobTimeline, attribution: Optional[Dict] = None
) -> Dict:
    """Chrome trace-event JSON (object form), loadable in Perfetto.
    Slices are ``X`` (complete) events, injections/spikes are ``i``
    (instant) events; tracks map to pids with ``process_name``
    metadata."""
    tracks: Dict[str, int] = {}

    def pid(track: str) -> int:
        if track not in tracks:
            tracks[track] = len(tracks) + 1
        return tracks[track]

    t0 = None
    for e in tl.events:
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            t0 = ts if t0 is None else min(t0, ts)
    for s in tl.slices:
        t0 = s.start if t0 is None else min(t0, s.start)
    t0 = t0 or 0.0

    def us(ts: float) -> int:
        return int(round((ts - t0) * 1e6))

    trace_events: List[Dict] = []
    for s in tl.slices:
        trace_events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": us(s.start), "dur": max(1, us(s.end) - us(s.start)),
            "pid": pid(s.track), "tid": 0,
            "args": {
                k: v for k, v in s.meta.items() if v is not None
            },
        })
    for track, step_ts in tl.steps_by_track.items():
        for i, ts in enumerate(step_ts):
            prev = step_ts[i - 1] if i else ts
            trace_events.append({
                "name": "step", "cat": CAT_STEP, "ph": "X",
                "ts": us(prev), "dur": max(1, us(ts) - us(prev)),
                "pid": pid(track), "tid": 1, "args": {},
            })
    for e in tl.instants:
        name = (
            f"{e.get('action')}@{e.get('point')}"
            if e.get("type") == "chaos_inject"
            else str(e.get("type"))
        )
        trace_events.append({
            "name": name, "cat": str(e.get("type")), "ph": "i",
            "ts": us(_num(e.get("ts"))), "pid": pid(_track_of(e)),
            "tid": 0, "s": "g",
            "args": {"detail": _describe_instant(e)},
        })
    # goodput track: the ledger's per-incarnation category partition
    # as one Perfetto row per node (lazy import: goodput.py imports
    # this module for its interval arithmetic)
    try:
        from dlrover_tpu_torch.telemetry import goodput as _goodput

        ledger = _goodput.build_ledger(tl.events)
        for inc in ledger.incarnations:
            for cat in _goodput.CATEGORIES:
                for a, b in inc.intervals.get(cat, []):
                    trace_events.append({
                        "name": cat, "cat": "goodput", "ph": "X",
                        "ts": us(a), "dur": max(1, us(b) - us(a)),
                        "pid": pid("goodput"), "tid": inc.node,
                        "args": {"incarnation": inc.incarnation},
                    })
    except Exception:  # noqa: BLE001 - a ledger bug must not cost
        pass  # the rest of the trace
    for track, p in tracks.items():
        trace_events.append({
            "ph": "M", "name": "process_name", "pid": p,
            "args": {"name": track},
        })
    out = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "dlrover_tpu_torch.telemetry.timeline",
            "epoch_origin": t0,
            "master_incarnations": tl.master_incarnations,
        },
    }
    if attribution is not None:
        out["otherData"]["goodput_attribution"] = attribution
    return out


def to_report(
    tl: JobTimeline, attribution: Optional[Dict] = None
) -> str:
    """Plain-text incident report: the job window, the attribution
    table, then the chronological incident trail."""
    lines: List[str] = []
    attribution = (
        attribution if attribution is not None
        else attribute_goodput_loss(tl)
    )
    lines.append("=== job flight recorder ===")
    lines.append(
        f"events: {len(tl.events)}  slices: {len(tl.slices)}  "
        f"master incarnation(s): {tl.master_incarnations}"
    )
    if tl.window:
        w0, w1 = tl.window
        lines.append(
            f"training window: {w1 - w0:.3f}s "
            f"[{w0:.3f} .. {w1:.3f}]"
        )
    lines.append(
        f"goodput {attribution['goodput']:.4f}  "
        f"training {attribution['training_s']:.3f}s  "
        f"lost {attribution['loss_s']:.3f}s"
    )
    lines.append("goodput-loss attribution:")
    loss = attribution["loss_s"] or 0.0
    for cause, seconds in attribution["buckets"].items():
        pct = (100.0 * seconds / loss) if loss > 0 else 0.0
        lines.append(f"  {cause:<16} {seconds:8.3f}s  {pct:5.1f}%")
    budgets = recovery_budgets(tl.events)
    if budgets:
        lines.append(
            "recovery budgets (death->first-step, per restart):"
        )
        for (rank, count), phases in sorted(budgets.items()):
            total = sum(
                v for k, v in phases.items()
                if k in RECOVERY_PHASES
            )
            parts = "  ".join(
                f"{p}={phases[p]:.3f}s" for p in RECOVERY_PHASES
                if p in phases
            )
            cache = phases.get("compile_cache_hit")
            cache_txt = (
                "  cache=HIT" if cache is True
                else "  cache=MISS" if cache is False else ""
            )
            aot = phases.get("aot_cache_hit")
            aot_txt = (
                "  aot=HIT" if aot is True
                else "  aot=MISS" if aot is False else ""
            )
            lines.append(
                f"  node{rank} restart#{count}: {total:.3f}s  "
                f"({parts}){cache_txt}{aot_txt}"
            )
    rl = tl.slices_by_cat(CAT_RL)
    if rl:
        iters = {
            s.meta.get("iteration") for s in rl
            if s.meta.get("iteration") is not None
        }
        by_phase = {}
        for s in rl:
            for p in RL_PHASES:
                if s.name.startswith(f"rl[{p}]"):
                    by_phase[p] = by_phase.get(p, 0.0) + s.duration
        parts = "  ".join(
            f"{p}={by_phase[p]:.3f}s" for p in RL_PHASES
            if p in by_phase
        )
        lines.append(
            f"rl plane: {len(iters)} iteration(s)  ({parts})"
        )
    serving = tl.slices_by_cat(CAT_SERVING)
    if serving:
        publishes = [
            s for s in serving if s.name.startswith("serving publish")
        ]
        ingests = [
            s for s in serving if s.name.startswith("serving ingest")
        ]
        fresh = [
            _num(s.meta.get("freshness_s")) for s in ingests
            if s.meta.get("freshness_s") is not None
        ]
        line = (
            f"serving plane: {len(publishes)} publish(es), "
            f"{len(ingests)} ingest(s)"
        )
        if fresh:
            line += (
                f", freshness max {max(fresh):.3f}s "
                f"last {fresh[-1]:.3f}s"
            )
        lines.append(line)
    slo_breaches = [
        e for e in tl.instants if e.get("type") == "rpc_slo_breach"
    ]
    if slo_breaches:
        lines.append("rpc SLO breach onsets:")
        lines.extend(
            "  " + _describe_instant(e) for e in slo_breaches
        )
    # goodput-ledger section: per-incarnation category partition +
    # conservation verdict (lazy import — see to_chrome_trace)
    try:
        from dlrover_tpu_torch.telemetry import goodput as _goodput

        ledger = _goodput.build_ledger(tl.events)
        if ledger.incarnations:
            lines.extend(_goodput.report_lines(ledger))
    except Exception:  # noqa: BLE001 - a ledger bug must not cost
        pass  # the rest of the report
    lines.append("incidents:")
    incidents = [
        (s.start, f"[{s.cat}] {s.track}: {s.name} "
         f"({s.duration:.3f}s)")
        for s in tl.slices if s.cat != CAT_SHARD
    ] + [
        (_num(e.get("ts")),
         f"[{e.get('type')}] {_track_of(e)}: "
         + _describe_instant(e))
        for e in tl.instants
    ]
    for _ts, line in sorted(incidents, key=lambda x: x[0]):
        lines.append("  " + line)
    return "\n".join(lines) + "\n"


def default_sources() -> List[str]:
    """The process-env view of where the job's events live: the local
    event log plus the agent-shipping glob."""
    return [
        os.environ.get(EVENT_LOG_ENV, ""),
        os.environ.get(EVENTS_AGGREGATE_ENV, ""),
    ]


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Assemble a job timeline from telemetry event "
        "logs: Chrome trace JSON, incident report, goodput-loss "
        "attribution",
    )
    parser.add_argument(
        "sources", nargs="*",
        help="event JSONL files (default: DLROVER_EVENT_LOG + "
        "DLROVER_EVENTS_AGGREGATE_GLOB)",
    )
    parser.add_argument(
        "--glob", action="append", default=[],
        help="additional event-log glob(s), e.g. the agents' "
        "shipped logs",
    )
    parser.add_argument(
        "--chrome", default="",
        help="write Chrome trace-event JSON here ('-' = stdout)",
    )
    parser.add_argument(
        "--report", action="store_true",
        help="print the plain-text incident report (default when no "
        "--chrome is given)",
    )
    parser.add_argument(
        "--emit", action="store_true",
        help="publish the attribution (goodput_attribution event + "
        "dlrover_goodput_loss_seconds gauges)",
    )
    args = parser.parse_args(argv)
    sources = list(args.sources) + list(args.glob)
    if not sources:
        sources = default_sources()
    events = collect_events(sources)
    if not events:
        print(
            f"no events found in {sources!r}", file=sys.stderr
        )
        return 1
    tl = assemble(events)
    attribution = attribute_goodput_loss(tl)
    if args.emit:
        publish_attribution(attribution)
    if args.chrome:
        doc = json.dumps(
            to_chrome_trace(tl, attribution), default=str
        )
        if args.chrome == "-":
            print(doc)
        else:
            with open(args.chrome, "w") as f:
                f.write(doc)
            print(
                f"wrote {args.chrome} "
                f"({len(tl.slices)} slices)", file=sys.stderr,
            )
    if args.report or not args.chrome:
        print(to_report(tl, attribution), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
