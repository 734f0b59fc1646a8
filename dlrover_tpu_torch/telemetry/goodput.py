"""Goodput ledger: causal attribution of every lost second, with a
conservation invariant.

Copy of ``dlrover_tpu/telemetry/goodput.py`` (the port imports nothing
of the JAX package).

The SpeedMonitor reports goodput as one scalar ratio; when it drops
from 96.8% to 91% nothing says *where* the seconds went.  This module
fuses the job's JSONL event logs (master, agents, trainers, checkpoint
engine, chaos harness — the same streams the timeline assembles) into
a **per-incarnation partition of wall clock** over exclusive
categories:

- ``productive_step`` — inter-step intervals whose gap passes the
  SpeedMonitor's own silence rule (≤ 3× the rolling 64-gap median,
  credited at the gap END where the step actually computed);
- ``compile_trace`` — retrace / AOT resolve windows
  (``recovery_phase`` aot+retrace, ``compile_cache``, ``aot_cache``);
- ``restore`` — checkpoint restore windows (``checkpoint_restore``,
  ``recovery_phase`` restore, ``ckpt.restore`` spans);
- ``rendezvous`` — rendezvous rounds + node checks;
- ``drain_resize`` — elastic-resize decide + drain windows;
- ``respawn_gap`` — spawn/import phases PLUS whatever remains of a
  death-witnessed recovery head (death witness → first step) that no
  finer-grained witness claimed;
- ``checkpoint_stall`` — save/persist/export windows not overlapped
  by step progress;
- ``straggler_wait`` — measured hang/straggler verdict windows;
- ``idle_unattributed`` — the remainder.  An attribution the ledger
  cannot explain is a bug, not a rounding error.

An *incarnation* is one (node, restart_count) lifetime.  Its window
opens at the death witness (the kill injection when one precedes the
agent's ``worker_restart``, mirroring the causal chain death-witness →
rendezvous → restore → first-step) and closes at the next
incarnation's birth; the categories are claimed by interval
subtraction in priority order, so they partition the window *by
construction* — the **conservation invariant** (categories sum to
wall clock within ε, default 2%) therefore detects assembly bugs, and
:class:`dlrover_tpu_torch.chaos.harness.GoodputConservation` enforces it on
every tier-1 chaos scenario.

Surfaces: ``dlrover_goodput_seconds_total{category}`` counters via
:mod:`dlrover_tpu_torch.master.goodput_ledger`, a ``goodput`` track in
:mod:`dlrover_tpu_torch.telemetry.timeline`, and the CLI reporter::

    python -m dlrover_tpu_torch.telemetry.goodput <event-dir-or-jsonl> ...
"""

import json
import os
import statistics
import sys
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.telemetry.events import collect_events
from dlrover_tpu_torch.telemetry.timeline import (
    _intersect,
    _num,
    _subtract,
    _total,
    _union,
    default_sources,
)

PRODUCTIVE = "productive_step"
COMPILE = "compile_trace"
RESTORE = "restore"
RENDEZVOUS = "rendezvous"
DRAIN = "drain_resize"
RESPAWN = "respawn_gap"
CKPT_STALL = "checkpoint_stall"
STRAGGLER = "straggler_wait"
IDLE = "idle_unattributed"

CATEGORIES = (
    PRODUCTIVE, COMPILE, RESTORE, RENDEZVOUS, DRAIN, RESPAWN,
    CKPT_STALL, STRAGGLER, IDLE,
)
# overlap resolution among loss categories (productive always claims
# first, idle takes the remainder): the finer-grained witness wins —
# a restore inside a rendezvous-bound recovery head is restore time
_CLAIM_PRIORITY = (
    RESTORE, COMPILE, RENDEZVOUS, DRAIN, CKPT_STALL, STRAGGLER,
)

DEFAULT_EPS = 0.02

# SpeedMonitor's silence-detection constants, mirrored so the ledger's
# productive accounting agrees with ``SpeedMonitor.goodput()`` (the
# cross-check that emits ``goodput_divergence`` above 1%)
_GAP_EXCLUDE_S = 300.0
_FIRST_GAP_CAP_S = 60.0
_GAP_MEDIAN_FACTOR = 3.0
_GAP_WINDOW = 64

_KILL_ACTIONS = frozenset({"kill", "sigterm", "terminate"})


def _node_of(e: Dict) -> Optional[int]:
    for key in ("node_rank", "rank"):
        v = e.get(key)
        if isinstance(v, int) and not isinstance(v, bool):
            return v
    return None


def _productive_intervals(
    step_ts: List[float],
) -> List[Tuple[float, float]]:
    """SpeedMonitor's gap accounting as intervals: each new step earns
    ``min(gap, 3 x rolling-median)`` seconds, credited at the gap END
    (where the step computed — the head of a long gap is the
    death/respawn the loss categories claim)."""
    ivs: List[Tuple[float, float]] = []
    gaps: deque = deque(maxlen=_GAP_WINDOW)
    for a, b in zip(step_ts, step_ts[1:]):
        gap = b - a
        if not (0 < gap < _GAP_EXCLUDE_S):
            continue
        if gaps:
            credit = min(
                gap, _GAP_MEDIAN_FACTOR * statistics.median(gaps)
            )
        else:
            credit = min(gap, _FIRST_GAP_CAP_S)
        ivs.append((b - credit, b))
        gaps.append(gap)
    return _union(ivs)


@dataclass
class IncarnationLedger:
    """One (node, restart_count) lifetime's wall-clock partition."""

    node: int
    incarnation: int
    start: float
    end: float
    # birth observed through a death witness (kill injection or the
    # agent's worker_restart) — job start is not a respawn
    witnessed: bool = False
    first_step_ts: Optional[float] = None
    steps: int = 0
    intervals: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict
    )
    seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def wall(self) -> float:
        return max(0.0, self.end - self.start)

    @property
    def attributed_s(self) -> float:
        return sum(self.seconds.get(c, 0.0) for c in CATEGORIES)

    @property
    def residual_frac(self) -> float:
        if self.wall <= 0:
            return 0.0
        return abs(self.wall - self.attributed_s) / self.wall


@dataclass
class GoodputLedger:
    """The assembled ledger for one job: per-incarnation partitions
    plus the global training window they roll up into."""

    incarnations: List[IncarnationLedger] = field(
        default_factory=list
    )
    # (first train_step ts, last train_step ts) across all nodes
    window: Optional[Tuple[float, float]] = None
    totals: Dict[str, float] = field(default_factory=dict)
    productive_by_node: Dict[int, List[Tuple[float, float]]] = field(
        default_factory=dict
    )

    @property
    def window_s(self) -> float:
        if self.window is None:
            return 0.0
        return max(0.0, self.window[1] - self.window[0])

    @property
    def wall_s(self) -> float:
        return sum(inc.wall for inc in self.incarnations)

    def goodput(self) -> float:
        """Productive fraction of the global ``[first_step,
        last_step]`` window (some node making step progress) — the
        SpeedMonitor-comparable ratio."""
        if self.window is None or self.window_s <= 0:
            return 0.0
        prod = _union([
            iv for ivs in self.productive_by_node.values()
            for iv in ivs
        ])
        covered = _total(_intersect(prod, [self.window]))
        return min(1.0, round(covered / self.window_s, 6))

    def attributed_pct(self) -> float:
        """Share of total incarnation wall clock landing in NAMED
        categories (everything but ``idle_unattributed``)."""
        wall = self.wall_s
        if wall <= 0:
            return 100.0
        idle = self.totals.get(IDLE, 0.0)
        return round(100.0 * max(0.0, 1.0 - idle / wall), 6)

    def loss_totals(self) -> Dict[str, float]:
        return {
            c: self.totals.get(c, 0.0)
            for c in CATEGORIES if c != PRODUCTIVE
        }

    def top_loss_causes(self, n: int = 3) -> List[Tuple[str, float]]:
        ranked = sorted(
            (
                (cat, secs) for cat, secs in
                self.loss_totals().items() if secs > 0
            ),
            key=lambda kv: (-kv[1], kv[0]),
        )
        return ranked[:n]

    def conservation_errors(
        self, eps: float = DEFAULT_EPS
    ) -> List[str]:
        """Incarnations whose categories do NOT sum to wall clock
        within ``eps`` — empty means the accounting closes."""
        errors: List[str] = []
        for inc in self.incarnations:
            frac = inc.residual_frac
            if frac > eps:
                errors.append(
                    f"node{inc.node} inc#{inc.incarnation}: "
                    f"attributed {inc.attributed_s:.3f}s of "
                    f"{inc.wall:.3f}s wall "
                    f"(residual {100.0 * frac:.2f}% > "
                    f"{100.0 * eps:.2f}%)"
                )
        return errors


def _scan(events: List[Dict]):
    """One pass over the ts-ordered stream: step tracks, incarnation
    birth witnesses, and the per-category claim intervals (per-node
    where the event names a node, global otherwise)."""
    steps: Dict[int, List[Tuple[float, int]]] = {}
    births: Dict[int, Dict[int, float]] = {}
    restarts: Dict[int, List[Tuple[float, int]]] = {}
    kills: Dict[int, List[float]] = {}
    node_end: Dict[int, float] = {}
    node_claims: Dict[int, Dict[str, List[Tuple[float, float]]]] = {}
    global_claims: Dict[str, List[Tuple[float, float]]] = {}

    def claim(cat, a, b, node=None):
        if b <= a:
            return
        if node is None:
            global_claims.setdefault(cat, []).append((a, b))
        else:
            node_claims.setdefault(node, {}).setdefault(
                cat, []
            ).append((a, b))

    resize_at: List[int] = []
    for i, e in enumerate(events):
        etype = e.get("type")
        ts = _num(e.get("ts"))
        node = _node_of(e)
        inc = e.get("restart_count")
        inc = inc if isinstance(inc, int) else None
        if node is not None:
            node_end[node] = max(node_end.get(node, ts), ts)
            if inc is not None:
                known = births.setdefault(node, {}).get(inc)
                births[node][inc] = (
                    ts if known is None else min(known, ts)
                )
        if etype == "train_step":
            if node is not None:
                steps.setdefault(node, []).append((ts, inc or 0))
        elif etype == "worker_restart":
            if node is not None and inc is not None:
                restarts.setdefault(node, []).append((ts, inc))
        elif etype == "chaos_inject":
            if (
                e.get("action") in _KILL_ACTIONS
                and node is not None
                and not str(e.get("point", "")).startswith("master.")
            ):
                kills.setdefault(node, []).append(ts)
        elif etype == "rendezvous_complete":
            claim(RENDEZVOUS, ts - _num(e.get("wait_s")), ts)
        elif etype == "node_check":
            claim(RENDEZVOUS, ts - _num(e.get("elapsed_s")), ts)
        elif etype == "span":
            dur = _num(e.get("duration_s"))
            name = str(e.get("name", ""))
            if name in ("rdzv.join", "node_check"):
                claim(RENDEZVOUS, ts - dur, ts, node)
            elif name == "ckpt.restore":
                claim(RESTORE, ts - dur, ts, node)
        elif etype == "checkpoint_restore":
            claim(RESTORE, ts - _num(e.get("total_s")), ts, node)
        elif etype == "recovery_phase":
            dur = _num(e.get("seconds"))
            phase = str(e.get("phase"))
            # the startup/recovery pipeline's measured phases, each
            # booked to the cause a capacity planner would act on:
            # XLA work (trace/AOT/jitted state init, and the cold
            # first step those dominate) vs restore vs process spawn
            cat = {
                "restore": RESTORE, "ckpt_init": RESTORE,
                "aot": COMPILE, "retrace": COMPILE,
                "model_build": COMPILE, "state_build": COMPILE,
                "first_step": COMPILE,
                "spawn": RESPAWN, "import": RESPAWN,
                "loop_setup": RESPAWN,
            }.get(phase)
            if cat is not None:
                claim(cat, ts - dur, ts, node)
        elif etype == "shm_prefetch":
            dur = _num(e.get("seconds"))
            if dur > 0:
                claim(RESTORE, ts - dur, ts, node)
        elif etype == "compile_cache":
            retrace = _num(e.get("retrace_s"))
            if retrace > 0:
                claim(COMPILE, ts - retrace, ts, node)
        elif etype == "aot_cache":
            dur = (
                _num(e.get("load_s")) + _num(e.get("trace_s"))
            ) or _num(e.get("seconds"))
            if dur > 0:
                claim(COMPILE, ts - dur, ts, node)
        elif etype == "checkpoint_shm_save":
            claim(CKPT_STALL, ts - _num(e.get("total_s")), ts, node)
        elif etype == "checkpoint_persist":
            claim(CKPT_STALL, ts - _num(e.get("seconds")), ts)
        elif etype == "kv_checkpoint":
            if e.get("stage") == "export":
                claim(
                    CKPT_STALL, ts - _num(e.get("seconds")), ts, node
                )
        elif etype == "diagnosis_verdict":
            dur = _num(e.get("duration_s")) or _num(e.get("stall_s"))
            culprit = e.get("culprit_node")
            who = (
                culprit if isinstance(culprit, int)
                and not isinstance(culprit, bool) and culprit >= 0
                else None
            )
            if dur > 0 and (
                e.get("hung") or e.get("action") == "isolate"
            ):
                claim(STRAGGLER, ts - dur, ts, who)
        elif etype == "hang_evidence":
            stall = _num(e.get("stall_s"))
            if stall > 0:
                claim(STRAGGLER, ts - stall, ts, node)
        elif etype == "resize_decision":
            resize_at.append(i)

    # resize decide + drain windows need lookahead: detected -> the
    # decision, then the decision -> the last old-world worker_restart
    # before the re-formed world's rendezvous round (same derivation
    # as the timeline's resize phases)
    for i in resize_at:
        e = events[i]
        decided = _num(e.get("ts"))
        detected = _num(e.get("detected_ts"), decided) or decided
        target = e.get("target")
        bound = float("inf")
        for later in events[i + 1:]:
            if later.get("type") == "resize_decision":
                bound = _num(later.get("ts"))
                break
            if (
                later.get("type") == "rendezvous_complete"
                and later.get("rdzv") == "elastic-training"
                and len(later.get("nodes") or []) == target
            ):
                bound = _num(later.get("ts"))
                break
        drain_end = decided
        for later in events[i + 1:]:
            ts = _num(later.get("ts"))
            if ts > bound:
                break
            if later.get("type") == "worker_restart":
                drain_end = max(drain_end, ts)
        claim(DRAIN, min(detected, decided), drain_end)

    return (
        steps, births, restarts, kills, node_end, node_claims,
        global_claims,
    )


def build_ledger(events: Iterable[Dict]) -> GoodputLedger:
    """Assemble the ledger from a (not necessarily ordered) event
    stream.  Pure function of the events — replaying the same event
    dir yields a byte-identical report."""
    ev = sorted(
        (e for e in events if isinstance(e, dict)),
        key=lambda e: _num(e.get("ts")),
    )
    (
        steps, births, restarts, kills, node_end, node_claims,
        global_claims,
    ) = _scan(ev)

    ledger = GoodputLedger()
    all_steps = sorted(
        ts for lst in steps.values() for ts, _ in lst
    )
    if all_steps:
        ledger.window = (all_steps[0], all_steps[-1])

    nodes = sorted(set(steps) | set(births))
    totals = {cat: 0.0 for cat in CATEGORIES}
    for node in nodes:
        step_list = sorted(steps.get(node, []))
        prod = _productive_intervals([ts for ts, _ in step_list])
        ledger.productive_by_node[node] = prod
        incs = dict(births.get(node, {}))
        for ts, inc in step_list:
            incs[inc] = min(incs.get(inc, ts), ts)
        if not incs:
            continue
        witnessed = {inc for _, inc in restarts.get(node, [])}
        # pull a witnessed birth back to its death witness: the
        # latest kill injection landing between the previous
        # incarnation's birth and the agent's restart record
        node_kills = sorted(kills.get(node, []))
        order = sorted(incs)
        for idx, inc in enumerate(order):
            if inc not in witnessed:
                continue
            floor = incs[order[idx - 1]] if idx > 0 else float("-inf")
            prior = [
                t for t in node_kills if floor < t <= incs[inc]
            ]
            if prior:
                incs[inc] = prior[-1]
        last_end = max(
            node_end.get(node, incs[order[-1]]),
            incs[order[-1]],
        )
        merged_claims = node_claims.get(node, {})
        prev_end = float("-inf")
        for idx, inc in enumerate(order):
            start = max(incs[inc], prev_end)
            end = (
                max(incs[order[idx + 1]], start)
                if idx + 1 < len(order) else max(last_end, start)
            )
            prev_end = end
            rec = IncarnationLedger(
                node=node, incarnation=inc, start=start, end=end,
                witnessed=inc in witnessed,
            )
            inc_steps = [
                ts for ts, i in step_list
                if i == inc and start <= ts <= end
            ]
            rec.steps = len(inc_steps)
            rec.first_step_ts = (
                min(inc_steps) if inc_steps else None
            )
            window = [(start, end)] if end > start else []
            claimed_prod = _intersect(prod, window)
            remaining = _subtract(window, claimed_prod)
            rec.intervals[PRODUCTIVE] = claimed_prod
            for cat in _CLAIM_PRIORITY:
                iv = _union(
                    list(merged_claims.get(cat, []))
                    + list(global_claims.get(cat, []))
                )
                claimed = _intersect(iv, remaining)
                rec.intervals[cat] = claimed
                remaining = _subtract(remaining, claimed)
            # respawn: the measured spawn/import phases, plus — for a
            # death-witnessed birth — whatever remains of the
            # recovery head (death witness -> first step) that no
            # finer-grained witness claimed
            respawn_iv = _union(
                list(merged_claims.get(RESPAWN, []))
                + list(global_claims.get(RESPAWN, []))
            )
            claimed = _intersect(respawn_iv, remaining)
            remaining = _subtract(remaining, claimed)
            if rec.witnessed:
                head = [(
                    start,
                    rec.first_step_ts
                    if rec.first_step_ts is not None else end,
                )]
                extra = _intersect(remaining, head)
                claimed = _union(claimed + extra)
                remaining = _subtract(remaining, extra)
            rec.intervals[RESPAWN] = claimed
            rec.intervals[IDLE] = remaining
            rec.seconds = {
                cat: round(_total(rec.intervals.get(cat, [])), 6)
                for cat in CATEGORIES
            }
            for cat in CATEGORIES:
                totals[cat] += rec.seconds[cat]
            ledger.incarnations.append(rec)
    ledger.totals = {
        cat: round(secs, 6) for cat, secs in totals.items()
    }
    ledger.incarnations.sort(
        key=lambda r: (r.start, r.node, r.incarnation)
    )
    return ledger


def to_dict(ledger: GoodputLedger) -> Dict:
    """Machine-readable summary (the bench section + the master's
    ``goodput_ledger`` event both serialize this)."""
    top = ledger.top_loss_causes(3)
    return {
        "goodput": ledger.goodput(),
        "attributed_pct": round(ledger.attributed_pct(), 2),
        "incarnations": len(ledger.incarnations),
        "wall_s": round(ledger.wall_s, 3),
        "window_s": round(ledger.window_s, 3),
        "totals": {
            cat: round(ledger.totals.get(cat, 0.0), 3)
            for cat in CATEGORIES
        },
        "top_loss_causes": [
            {"cause": cat, "seconds": round(secs, 3)}
            for cat, secs in top
        ],
        "top_loss_cause": top[0][0] if top else "",
    }


def report_lines(
    ledger: GoodputLedger, eps: float = DEFAULT_EPS
) -> List[str]:
    """Deterministic plain-text rendering: per-incarnation table +
    top-3 loss causes + the conservation verdict."""
    lines = ["=== goodput ledger ==="]
    lines.append(
        f"incarnations: {len(ledger.incarnations)}  "
        f"wall {ledger.wall_s:.3f}s  "
        f"window {ledger.window_s:.3f}s  "
        f"goodput {ledger.goodput():.4f}  "
        f"attributed {ledger.attributed_pct():.1f}%"
    )
    if ledger.incarnations:
        lines.append(
            "per-incarnation attribution "
            "(* = death-witnessed birth):"
        )
    for inc in ledger.incarnations:
        parts = "  ".join(
            f"{cat}={inc.seconds.get(cat, 0.0):.3f}s"
            for cat in CATEGORIES if inc.seconds.get(cat, 0.0) > 0
        )
        mark = "*" if inc.witnessed else ""
        lines.append(
            f"  node{inc.node} inc#{inc.incarnation}{mark}  "
            f"wall {inc.wall:9.3f}s  steps {inc.steps:4d}  {parts}"
        )
    top = ledger.top_loss_causes(3)
    if top:
        loss = sum(ledger.loss_totals().values())
        lines.append("top loss causes:")
        for i, (cat, secs) in enumerate(top, 1):
            pct = 100.0 * secs / loss if loss > 0 else 0.0
            lines.append(
                f"  {i}. {cat:<18} {secs:9.3f}s  {pct:5.1f}%"
            )
    errors = ledger.conservation_errors(eps)
    worst = max(
        (inc.residual_frac for inc in ledger.incarnations),
        default=0.0,
    )
    lines.append(
        f"conservation: max residual {100.0 * worst:.2f}% "
        f"(eps {100.0 * eps:.2f}%) "
        + ("FAIL" if errors else "OK")
    )
    lines.extend(f"  VIOLATION: {err}" for err in errors)
    return lines


def to_report(ledger: GoodputLedger, eps: float = DEFAULT_EPS) -> str:
    return "\n".join(report_lines(ledger, eps)) + "\n"


def _expand_sources(args: List[str]) -> List[str]:
    """CLI convenience: a directory argument means 'every *.jsonl in
    it' (the chaos workdir / shared event dir layout)."""
    out: List[str] = []
    for src in args:
        if os.path.isdir(src):
            out.append(os.path.join(src, "*.jsonl"))
        else:
            out.append(src)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Goodput ledger: per-incarnation attribution of "
        "wall-clock time from the job's event logs, with a "
        "conservation check",
    )
    parser.add_argument(
        "sources", nargs="*",
        help="event JSONL files, globs, or directories (default: "
        "DLROVER_EVENT_LOG + DLROVER_EVENTS_AGGREGATE_GLOB)",
    )
    parser.add_argument(
        "--eps", type=float, default=DEFAULT_EPS,
        help="conservation tolerance as a fraction of wall clock "
        "(default 0.02)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="print the machine-readable summary instead of the "
        "table",
    )
    args = parser.parse_args(argv)
    sources = _expand_sources(list(args.sources)) or default_sources()
    events = collect_events(sources)
    if not events:
        print(f"no events found in {sources!r}", file=sys.stderr)
        return 1
    ledger = build_ledger(events)
    if args.json:
        print(json.dumps(to_dict(ledger), sort_keys=True))
    else:
        print(to_report(ledger, eps=args.eps), end="")
    return 0 if not ledger.conservation_errors(args.eps) else 2


if __name__ == "__main__":
    raise SystemExit(main())
