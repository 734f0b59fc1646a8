"""Live control-plane scoreboard over the telemetry registry.

The registry's histograms are *cumulative* — fine for a Prometheus
scrape, useless for a capacity search, where early healthy samples
would dilute a breach at the current agent count forever.  The
scoreboard therefore works in **windows**: every sample it diffs each
``dlrover_rpc_seconds{verb}`` series' bucket counts against the
previous sample and estimates quantiles from the delta alone, so a
p99 always describes *the load level being tested right now*.

Each sample also reads the fan-in instrumentation this PR added —
``dlrover_master_connections`` (accepted/active/peak),
``dlrover_rpc_inflight`` per verb, the journal's append lock-wait
split, its batched-fsync depth under ``DLROVER_JOURNAL_FSYNC_WINDOW_S``
and the mirror queue — and emits a ``fleet_report`` event, the
timeline/report pipeline's view of the run.

Copy of ``dlrover_tpu/fleet/scoreboard.py`` (the port imports nothing of
the JAX package); host code, as in the reference.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import metrics as _metrics
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.slo import (
    HistogramWindow,
    SloRule,
    estimate_quantile,
    rules_from_env,
)

RPC_METRIC = "dlrover_rpc_seconds"

# verbs reported inline in fleet_report events, most-traffic first;
# the rest are folded into the aggregate numbers so a wide verb mix
# cannot bloat the event log
MAX_VERBS_PER_REPORT = 8


def _collect_histogram(registry, name: str):
    metric = registry.get(name)
    if not isinstance(metric, _metrics.Histogram):
        return []
    return metric.collect()


def _gauge_map(registry, name: str) -> Dict[str, float]:
    metric = registry.get(name)
    if not isinstance(metric, _metrics.Gauge):
        return {}
    out = {}
    for labels, value in metric.collect():
        key = ",".join(
            v for _, v in sorted(labels.items())
        ) or "_"
        out[key] = float(value)
    return out


# windowed-delta tracking moved to telemetry.slo.HistogramWindow so
# the serving replica/router stats share the exact implementation;
# the old private name stays as an alias for in-tree callers
_VerbWindow = HistogramWindow


class Scoreboard:
    """Samples the registry on a cadence; keeps windowed per-verb
    views; emits ``fleet_report`` events."""

    def __init__(
        self,
        registry: Optional[_metrics.MetricsRegistry] = None,
        interval_s: float = 1.0,
        rules: Optional[List[SloRule]] = None,
        min_count: int = 10,
        agents_fn=None,
        emit_reports: bool = True,
    ):
        """``agents_fn``: zero-arg callable returning the live agent
        count (the runner wires its own); ``rules``: SLO rules the
        windowed breach check evaluates (default: the same
        ``DLROVER_RPC_SLO`` rules the master's checker uses)."""
        self.registry = registry or _metrics.get_registry()
        self.interval_s = max(0.05, float(interval_s))
        self.rules = rules if rules is not None else rules_from_env()
        self.min_count = int(min_count)
        self._agents_fn = agents_fn or (lambda: 0)
        self._emit_reports = emit_reports
        self._rpc_window = _VerbWindow()
        self._journal_window = _VerbWindow()
        self._lock_window = _VerbWindow()
        self._server_window = _VerbWindow()
        self._last_sample_ts = 0.0
        self.samples: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ----------------------------------------------------------

    def reset_window(self):
        """Drop accumulated deltas: the next sample measures only
        what happens after this call."""
        self._rpc_window.reset(
            _collect_histogram(self.registry, RPC_METRIC)
        )
        self._journal_window.reset(_collect_histogram(
            self.registry, "dlrover_master_journal_fsync_seconds"
        ))
        self._lock_window.reset(_collect_histogram(
            self.registry, "dlrover_master_journal_lock_wait_seconds"
        ))
        self._server_window.reset(_collect_histogram(
            self.registry, "dlrover_rpc_server_seconds"
        ))
        self._last_sample_ts = time.monotonic()

    def _window_quantiles(self, window: Dict[Tuple, Dict]) -> Dict:
        verbs: Dict[str, Dict] = {}
        for entry in window.values():
            verb = entry["labels"].get("verb", "_")
            if entry["count"] <= 0:
                continue
            verbs[verb] = {
                "count": entry["count"],
                "mean_ms": round(
                    entry["sum_s"] / entry["count"] * 1000.0, 3
                ),
                "p50_ms": round(estimate_quantile(
                    entry["bounds"], entry["counts"], 0.50
                ) * 1000.0, 3),
                "p99_ms": round(estimate_quantile(
                    entry["bounds"], entry["counts"], 0.99
                ) * 1000.0, 3),
                "_bounds": entry["bounds"],
                "_counts": entry["counts"],
            }
        return verbs

    def sample(self) -> Dict:
        """One scoreboard observation window; appended to
        :attr:`samples` and (optionally) emitted as a
        ``fleet_report`` event."""
        now = time.monotonic()
        window_s = (
            now - self._last_sample_ts
            if self._last_sample_ts else self.interval_s
        )
        self._last_sample_ts = now
        verbs = self._window_quantiles(self._rpc_window.deltas(
            _collect_histogram(self.registry, RPC_METRIC)
        ))
        total_count = sum(v["count"] for v in verbs.values())
        rps = total_count / window_s if window_s > 0 else 0.0
        breaches = self._windowed_breaches(verbs)

        journal = self._window_quantiles(self._journal_window.deltas(
            _collect_histogram(
                self.registry,
                "dlrover_master_journal_fsync_seconds",
            )
        )).get("_", {})
        lock_wait = self._window_quantiles(self._lock_window.deltas(
            _collect_histogram(
                self.registry,
                "dlrover_master_journal_lock_wait_seconds",
            )
        )).get("_", {})
        server = self._window_quantiles(self._server_window.deltas(
            _collect_histogram(
                self.registry, "dlrover_rpc_server_seconds"
            )
        ))

        conns = _gauge_map(
            self.registry, "dlrover_master_connections"
        )
        inflight = _gauge_map(self.registry, "dlrover_rpc_inflight")
        pending_fsync = _gauge_map(
            self.registry, "dlrover_master_journal_pending_fsync"
        ).get("_", 0.0)
        mirror_queue = _gauge_map(
            self.registry, "dlrover_master_journal_mirror_queue"
        ).get("_", 0.0)

        sample = {
            "ts": time.time(),
            "window_s": round(window_s, 3),
            "agents": int(self._agents_fn()),
            "rps": round(rps, 2),
            "ops": total_count,
            "verbs": {
                v: {
                    k: val for k, val in d.items()
                    if not k.startswith("_")
                }
                for v, d in verbs.items()
            },
            "server_verbs": {
                v: {
                    k: val for k, val in d.items()
                    if not k.startswith("_")
                }
                for v, d in server.items()
            },
            "breaches": [
                {
                    "verb": b[0], "quantile": b[1],
                    "observed_s": round(b[2], 6),
                    "threshold_s": b[3], "count": b[4],
                }
                for b in breaches
            ],
            "connections": conns,
            "inflight_total": round(
                sum(inflight.values()), 1
            ),
            "journal_append_p99_ms": journal.get("p99_ms", 0.0),
            "journal_append_count": journal.get("count", 0),
            "journal_lock_wait_p99_ms": lock_wait.get(
                "p99_ms", 0.0
            ),
            "journal_pending_fsync": pending_fsync,
            "journal_mirror_queue": mirror_queue,
        }
        self.samples.append(sample)
        if self._emit_reports:
            self._emit_report(sample)
        return sample

    # -- level-wide probe window (capacity search) -------------------------
    #
    # the per-sample windows are ~1 s: right for live fleet_report
    # cadence, too small to judge a low-rate verb's p99 (a 3-request
    # window never clears min_count).  A capacity probe therefore
    # opens ONE window spanning the whole level and judges that.

    def begin_probe(self):
        self._probe = _VerbWindow()
        self._probe.reset(
            _collect_histogram(self.registry, RPC_METRIC)
        )

    def end_probe(self) -> Dict:
        """Quantiles + SLO verdict over everything since
        :meth:`begin_probe`."""
        verbs = self._window_quantiles(self._probe.deltas(
            _collect_histogram(self.registry, RPC_METRIC)
        ))
        breaches = self._windowed_breaches(verbs)
        return {
            "verbs": {
                v: {
                    k: val for k, val in d.items()
                    if not k.startswith("_")
                }
                for v, d in verbs.items()
            },
            "ops": sum(d["count"] for d in verbs.values()),
            "worst_p99_ms": {
                v: d["p99_ms"] for v, d in sorted(verbs.items())
            },
            "breaches": [
                {
                    "verb": b[0], "quantile": b[1],
                    "observed_s": round(b[2], 6),
                    "threshold_s": b[3], "count": b[4],
                }
                for b in breaches
            ],
        }

    def _windowed_breaches(
        self, verbs: Dict[str, Dict]
    ) -> List[Tuple[str, str, float, float, int]]:
        """(verb, quantile_label, observed_s, threshold_s, count)
        for every rule the CURRENT window breaches.  min_count gates
        exactly like the master's checker: a two-request window
        proves nothing."""
        out = []
        for verb, d in verbs.items():
            if d["count"] < self.min_count:
                continue
            for rule in self.rules:
                if not rule.matches(verb):
                    continue
                observed = estimate_quantile(
                    d["_bounds"], d["_counts"], rule.quantile
                )
                if observed > rule.threshold_s:
                    out.append((
                        verb, rule.quantile_label, observed,
                        rule.threshold_s, d["count"],
                    ))
        return out

    def _emit_report(self, sample: Dict):
        verbs = sample["verbs"]
        top = dict(sorted(
            verbs.items(),
            key=lambda kv: -kv[1]["count"],
        )[:MAX_VERBS_PER_REPORT])
        emit_event(
            "fleet_report",
            agents=sample["agents"],
            rps=sample["rps"],
            window_s=sample["window_s"],
            ops=sample["ops"],
            verbs=top,
            breaches=len(sample["breaches"]),
            conns_active=sample["connections"].get("active", 0.0),
            conns_peak=sample["connections"].get("peak", 0.0),
            inflight=sample["inflight_total"],
            journal_append_p99_ms=sample["journal_append_p99_ms"],
            journal_lock_wait_p99_ms=(
                sample["journal_lock_wait_p99_ms"]
            ),
            journal_pending_fsync=sample["journal_pending_fsync"],
            journal_mirror_queue=sample["journal_mirror_queue"],
        )

    # -- summary -----------------------------------------------------------

    def summary(self, last_n: Optional[int] = None) -> Dict:
        """Aggregate view over the last ``last_n`` samples (all by
        default): worst windowed p99 per verb, peak rps, breach
        count — what the bench section and the smoke test read."""
        samples = (
            self.samples[-last_n:] if last_n else list(self.samples)
        )
        if not samples:
            return {"samples": 0}
        worst: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for s in samples:
            for verb, d in s["verbs"].items():
                worst[verb] = max(
                    worst.get(verb, 0.0), d["p99_ms"]
                )
                counts[verb] = counts.get(verb, 0) + d["count"]
        return {
            "samples": len(samples),
            "agents": samples[-1]["agents"],
            "peak_rps": max(s["rps"] for s in samples),
            "mean_rps": round(
                sum(s["rps"] for s in samples) / len(samples), 2
            ),
            "worst_p99_ms": {
                v: round(p, 3) for v, p in sorted(worst.items())
            },
            "verb_counts": counts,
            "breaches": sum(len(s["breaches"]) for s in samples),
            "conns_peak": max(
                s["connections"].get("peak", 0.0) for s in samples
            ),
            "journal_append_p99_ms": max(
                s["journal_append_p99_ms"] for s in samples
            ),
            "journal_lock_wait_p99_ms": max(
                s["journal_lock_wait_p99_ms"] for s in samples
            ),
        }

    # -- background sampling ----------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self.reset_window()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-scoreboard", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - observation must not
                logger.exception("scoreboard sample failed")  # kill

    def stop(self, final_sample: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_sample:
            try:
                self.sample()
            except Exception:  # noqa: BLE001
                logger.exception("final scoreboard sample failed")
