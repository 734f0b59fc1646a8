"""Declarative latency SLOs over registry histograms.

Copy of ``dlrover_tpu/telemetry/slo.py`` (the port imports nothing of
the JAX package).

The control plane now times every servicer dispatch into
``dlrover_rpc_seconds{verb}``; this module holds those series to
declared bounds and surfaces breaches where operators already look:
the ``/metrics`` exposition (``dlrover_rpc_slo_breach`` /
``dlrover_rpc_quantile_seconds`` gauges) and the flight-recorder
incident report (``rpc_slo_breach`` events assemble into it).

An SLO is ``(verb glob, quantile, threshold seconds)``.  Defaults
cover the two servicer verbs; ``DLROVER_RPC_SLO`` overrides them with
``"<glob>:p<q>:<seconds>[,...]"`` — e.g.
``"get.*:p99:0.5,report.*:p95:0.2"``.

Quantiles are estimated from the histogram buckets by linear
interpolation inside the target bucket — the standard
Prometheus ``histogram_quantile`` estimate, computed in-process so
the master needs no query engine to police itself.
"""

import fnmatch
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import metrics as _metrics
from dlrover_tpu_torch.telemetry.events import emit_event

RPC_SLO_ENV = "DLROVER_RPC_SLO"
RPC_METRIC = "dlrover_rpc_seconds"

# a handful of samples proves nothing: quantile estimates over tiny
# counts flap, and a one-request verb breaching its p99 is noise
DEFAULT_MIN_COUNT = 10


@dataclass(frozen=True)
class SloRule:
    """One declarative bound: the ``quantile`` of every verb matching
    ``verb_pattern`` must stay under ``threshold_s``."""

    verb_pattern: str
    quantile: float
    threshold_s: float

    def matches(self, verb: str) -> bool:
        return fnmatch.fnmatchcase(verb, self.verb_pattern)

    @property
    def quantile_label(self) -> str:
        return f"p{self.quantile * 100:g}"


DEFAULT_RPC_SLOS: Tuple[SloRule, ...] = (
    # request/response paths (rendezvous joins, shard gets) may do
    # real work; fire-and-ack reports must stay cheap
    SloRule("get.*", 0.99, 1.0),
    SloRule("report.*", 0.99, 0.5),
)


def parse_slo_spec(spec: str) -> List[SloRule]:
    """``"get.*:p99:1.0,report.*:p95:0.2"`` -> rules.  Malformed
    entries are skipped with a warning — a typo in an env var must
    not take down the master."""
    rules: List[SloRule] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.rsplit(":", 2)
        try:
            pattern, q_str, thr = parts[0], parts[1], float(parts[2])
            q = float(q_str.lstrip("pP")) / 100.0
            if not (0.0 < q < 1.0) or thr <= 0:
                raise ValueError(entry)
            rules.append(SloRule(pattern, q, thr))
        except (IndexError, ValueError):
            logger.warning("ignoring malformed SLO entry %r", entry)
    return rules


def rules_from_env() -> List[SloRule]:
    spec = os.environ.get(RPC_SLO_ENV, "").strip()
    if not spec:
        return list(DEFAULT_RPC_SLOS)
    return parse_slo_spec(spec) or list(DEFAULT_RPC_SLOS)


def estimate_quantile(
    bounds: Sequence[float],
    bucket_counts: Sequence[int],
    q: float,
) -> float:
    """Quantile estimate from per-bucket (non-cumulative) counts;
    ``bucket_counts`` carries one extra entry for +Inf.  Linear
    interpolation within the target bucket; the +Inf bucket clamps to
    its lower edge (the estimate cannot exceed observed knowledge)."""
    total = sum(bucket_counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    lower = 0.0
    for i, count in enumerate(bucket_counts):
        upper = bounds[i] if i < len(bounds) else math.inf
        prev_cum = cum
        cum += count
        if cum >= rank and count > 0:
            if upper == math.inf:
                return lower  # unbounded bucket: clamp to lower edge
            frac = (rank - prev_cum) / count
            return lower + (upper - lower) * frac
        lower = upper if upper != math.inf else lower
    return lower


class HistogramWindow:
    """Windowed-delta tracker over a cumulative histogram: remembers
    the previous cumulative bucket counts per label set and yields
    per-window (non-cumulative) counts on demand.  THE shared
    windowing primitive — the fleet Scoreboard, the serving replica's
    lookup stats, and the lookup router's route stats all window the
    same way, and :func:`estimate_quantile` reads the windows, so
    every p50/p99 in the system is one implementation."""

    def __init__(self):
        self._prev: Dict[Tuple, Tuple[List[int], float]] = {}

    def deltas(self, collected) -> Dict[Tuple, Dict]:
        """{label_key: {labels, bounds, counts, count, sum_s}} of
        everything observed since the previous call."""
        out: Dict[Tuple, Dict] = {}
        seen = set()
        for labels, snap in collected:
            key = tuple(sorted(labels.items()))
            seen.add(key)
            counts = list(snap["bucket_counts"])
            total = float(snap["sum"])
            prev_counts, prev_sum = self._prev.get(
                key, ([0] * len(counts), 0.0)
            )
            if len(prev_counts) != len(counts):
                prev_counts = [0] * len(counts)
                prev_sum = 0.0
            d_counts = [
                max(0, c - p) for c, p in zip(counts, prev_counts)
            ]
            out[key] = {
                "labels": dict(labels),
                "bounds": list(snap["bounds"]),
                "counts": d_counts,
                "count": sum(d_counts),
                "sum_s": max(0.0, total - prev_sum),
            }
            self._prev[key] = (counts, total)
        # label sets that vanished (registry reset) drop silently
        for key in list(self._prev):
            if key not in seen:
                del self._prev[key]
        return out

    def reset(self, collected):
        """Re-baseline without producing a window (a config change
        mid-run must not mix two regimes into one window)."""
        self.deltas(collected)


def window_quantiles_ms(
    window: Dict, qs: Sequence[float] = (0.5, 0.99)
) -> Dict[str, float]:
    """``{"p50_ms": ..., "p99_ms": ...}`` from one
    :meth:`HistogramWindow.deltas` entry — the event-facing shape the
    serving stats emitters share."""
    return {
        f"p{q * 100:g}_ms": round(
            estimate_quantile(window["bounds"], window["counts"], q)
            * 1e3,
            4,
        )
        for q in qs
    }


@dataclass
class SloBreach:
    verb: str
    quantile: str
    threshold_s: float
    observed_s: float
    count: int

    def describe(self) -> str:
        return (
            f"{self.verb} {self.quantile}="
            f"{self.observed_s * 1000:.1f}ms > SLO "
            f"{self.threshold_s * 1000:.0f}ms "
            f"({self.count} samples)"
        )


@dataclass
class SloChecker:
    """Periodic SLO evaluation over one histogram metric.

    ``check()`` walks every ``{verb}`` series of ``metric_name``,
    matches it against the rules, publishes
    ``dlrover_rpc_quantile_seconds{verb,quantile}`` and
    ``dlrover_rpc_slo_breach{verb}`` (1 breaching / 0 healthy) and
    emits one ``rpc_slo_breach`` event per breach *onset* (clearing
    re-arms), so the incident report records when the control plane
    degraded without one event per poll."""

    rules: List[SloRule] = field(default_factory=rules_from_env)
    registry: Optional[_metrics.MetricsRegistry] = None
    metric_name: str = RPC_METRIC
    min_count: int = DEFAULT_MIN_COUNT
    _breaching: Dict[Tuple[str, str], bool] = field(
        default_factory=dict
    )

    def __post_init__(self):
        reg = self.registry or _metrics.get_registry()
        self.registry = reg
        self._quantile_gauge = reg.gauge(
            "dlrover_rpc_quantile_seconds",
            "Estimated RPC latency quantiles per verb (from "
            "dlrover_rpc_seconds buckets)",
        )
        self._breach_gauge = reg.gauge(
            "dlrover_rpc_slo_breach",
            "1 while the verb's quantile breaches its declared "
            "latency SLO",
        )

    def check(self, emit: bool = True) -> List[SloBreach]:
        metric = self.registry.get(self.metric_name)
        if not isinstance(metric, _metrics.Histogram):
            return []
        breaches: List[SloBreach] = []
        for labels, snap in metric.collect():
            verb = labels.get("verb", "")
            count = int(snap["count"])
            for rule in self.rules:
                if not rule.matches(verb):
                    continue
                observed = estimate_quantile(
                    snap["bounds"], snap["bucket_counts"],
                    rule.quantile,
                )
                key = (verb, rule.quantile_label)
                self._quantile_gauge.set(
                    observed, verb=verb,
                    quantile=rule.quantile_label,
                )
                if count < self.min_count:
                    continue
                breached = observed > rule.threshold_s
                # keyed like the internal state — two rules on the
                # same verb (p99 AND p50) must not overwrite each
                # other's breach series
                self._breach_gauge.set(
                    1.0 if breached else 0.0, verb=verb,
                    quantile=rule.quantile_label,
                )
                was = self._breaching.get(key, False)
                self._breaching[key] = breached
                if not breached:
                    continue
                breach = SloBreach(
                    verb=verb,
                    quantile=rule.quantile_label,
                    threshold_s=rule.threshold_s,
                    observed_s=round(observed, 6),
                    count=count,
                )
                breaches.append(breach)
                if emit and not was:
                    emit_event(
                        "rpc_slo_breach",
                        verb=breach.verb,
                        quantile=breach.quantile,
                        threshold_s=breach.threshold_s,
                        observed_s=breach.observed_s,
                        count=breach.count,
                    )
                    logger.warning(
                        "RPC SLO breach: %s", breach.describe()
                    )
        return breaches

    def report_lines(self) -> List[str]:
        """Current-state SLO block for the incident report endpoint
        (live registry view; historical onsets come from the
        ``rpc_slo_breach`` events in the log)."""
        breaches = self.check(emit=False)
        if not breaches:
            return ["rpc SLOs: all within bounds"]
        return ["rpc SLO breaches:"] + [
            "  " + b.describe() for b in breaches
        ]
