"""Master-side goodput-ledger service.

Copy of ``dlrover_tpu/master/goodput_ledger.py`` (the port imports
nothing of the JAX package).

Periodically re-assembles the goodput ledger
(:mod:`dlrover_tpu_torch.telemetry.goodput`) from the job's event logs and
publishes it live:

- ``dlrover_goodput_seconds_total{category}`` counters on the
  master's ``/metrics`` endpoint (monotonic: per-category deltas are
  clamped at >= 0 because a ledger re-assembly can legitimately
  shrink a category — e.g. a recovery head re-attributed from
  ``respawn_gap`` once the first step lands);
- ``SpeedMonitor.goodput()`` re-derived from the ledger via
  ``set_ledger_goodput`` (the step-gap ratio stays exported on
  ``dlrover_goodput_ratio_monitor`` as a cross-check; divergence
  above 1% emits a ``goodput_divergence`` event);
- a periodic ``goodput_ledger`` summary event for the flight
  recorder / bench post-mortems.
"""

import os
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.telemetry.events import collect_events, emit_event
from dlrover_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    get_registry,
)

GOODPUT_LEDGER_INTERVAL_ENV = "DLROVER_GOODPUT_LEDGER_INTERVAL_S"
DEFAULT_INTERVAL_S = 30.0
# ledger vs step-gap monitor tolerance before the divergence event
DIVERGENCE_EPS = 0.01
# the ledger ratio only overrides the monitor once it has seen a
# meaningful training window (two steps)
_MIN_STEPS = 2


class GoodputLedgerService:
    def __init__(
        self,
        speed_monitor=None,
        sources: Optional[List[str]] = None,
        interval: Optional[float] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.speed_monitor = speed_monitor
        self._sources = sources
        if interval is None:
            try:
                interval = float(
                    os.environ.get(GOODPUT_LEDGER_INTERVAL_ENV, "")
                )
            except ValueError:
                interval = DEFAULT_INTERVAL_S
        self.interval = interval
        reg = registry or get_registry()
        self._seconds_counter = reg.counter(
            "dlrover_goodput_seconds_total",
            "Wall-clock seconds attributed by the goodput ledger, "
            "by category",
        )
        self._last_tick = 0.0
        self._last_seconds: Dict[str, float] = {}
        self.last_summary: Optional[Dict] = None

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        now = now or time.time()
        if now - self._last_tick < self.interval:
            return False
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> bool:
        """Assemble + publish once.  Returns True when a ledger was
        built (False = no events yet)."""
        from dlrover_tpu_torch.telemetry import goodput as _goodput
        from dlrover_tpu_torch.telemetry.timeline import default_sources

        self._last_tick = now or time.time()
        events = collect_events(self._sources or default_sources())
        if not events:
            return False
        ledger = _goodput.build_ledger(events)
        for cat in _goodput.CATEGORIES:
            total = ledger.totals.get(cat, 0.0)
            delta = total - self._last_seconds.get(cat, 0.0)
            if delta > 0:
                self._seconds_counter.inc(delta, category=cat)
            self._last_seconds[cat] = max(
                total, self._last_seconds.get(cat, 0.0)
            )
        summary = _goodput.to_dict(ledger)
        self.last_summary = summary
        total_steps = sum(inc.steps for inc in ledger.incarnations)
        if (
            self.speed_monitor is not None
            and ledger.window is not None
            and ledger.window_s > 0
            and total_steps >= _MIN_STEPS
        ):
            ratio = ledger.goodput()
            monitor = self.speed_monitor.legacy_goodput()
            self.speed_monitor.set_ledger_goodput(
                ratio, self._last_tick
            )
            divergence = abs(ratio - monitor)
            if monitor > 0 and divergence > DIVERGENCE_EPS:
                emit_event(
                    "goodput_divergence",
                    ledger=round(ratio, 6),
                    monitor=round(monitor, 6),
                    divergence=round(divergence, 6),
                )
        emit_event(
            "goodput_ledger",
            goodput=summary["goodput"],
            attributed_pct=summary["attributed_pct"],
            incarnations=summary["incarnations"],
            window_s=summary["window_s"],
            wall_s=summary["wall_s"],
            top_loss_cause=summary["top_loss_cause"],
            totals=summary["totals"],
        )
        return True
