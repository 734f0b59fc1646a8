"""Training-speed accounting on the master.

Copy of ``dlrover_tpu/master/speed_monitor.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/monitor/speed_monitor.py``: agents
report the trainer's global step; the master derives steps/sec and
samples/sec over a sliding window, tracks the globally completed step
(used by hang detection and checkpoint naming), and exposes windows in
which worker membership changed so throughput comparisons skip them.

The derived signals are written through the telemetry registry
(``dlrover_global_step``, ``dlrover_steps_per_second``,
``dlrover_goodput_ratio``, ``dlrover_running_workers``) so the
Prometheus endpoint, diagnosis and any in-process consumer read the
same numbers this monitor computes — one source of truth instead of
private state plus ad-hoc log lines.
"""

import statistics
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Set, Tuple

from dlrover_tpu_torch.telemetry.metrics import MetricsRegistry, get_registry


class SpeedMonitor:
    def __init__(
        self, window: int = 50,
        registry: Optional[MetricsRegistry] = None,
    ):
        self._lock = threading.Lock()
        reg = registry or get_registry()
        self._step_gauge = reg.gauge(
            "dlrover_global_step", "Globally completed training step"
        )
        self._speed_gauge = reg.gauge(
            "dlrover_steps_per_second",
            "Training speed over the sample window",
        )
        self._goodput_gauge = reg.gauge(
            "dlrover_goodput_ratio",
            "Fraction of wall-clock spent making step progress",
        )
        self._workers_gauge = reg.gauge(
            "dlrover_running_workers", "Workers currently registered"
        )
        # step-gap ratio kept as a cross-check against the
        # ledger-derived goodput (divergence >1% is an event)
        self._monitor_goodput_gauge = reg.gauge(
            "dlrover_goodput_ratio_monitor",
            "Step-gap goodput ratio (pre-ledger cross-check)",
        )
        # a fresh monitor is a fresh job: zero the registry view
        self._step_gauge.set(0)
        self._speed_gauge.set(0.0)
        self._goodput_gauge.set(0.0)
        self._workers_gauge.set(0)
        # (timestamp, global_step) samples
        self._samples: Deque[Tuple[float, int]] = deque(maxlen=window)
        self._global_step = 0
        # goodput wall-clock starts at the FIRST step report: master/
        # agent startup idle is not churn loss, and measuring
        # [first_step, last_step] matches bench.py's churn-window
        # accounting (0.0 = no step seen yet)
        self._start_time = 0.0
        self._last_step_time = time.time()
        self._batch_size = 0
        self._worker_adjustment_time = 0.0
        self._running_workers: Set[int] = set()
        # goodput/MFU accounting (the north-star metric: BASELINE.md
        # targets >=95% goodput under churn; reference README:55-57)
        self._flops_per_sample = 0.0
        self._peak_flops = 0.0
        self._productive_seconds = 0.0
        self._last_productive_mark = 0.0
        # rolling window of RAW step gaps: a restart/rendezvous
        # silence is detected as a gap far above the typical step
        # time (3x the window median) and only a step's worth of it
        # counts as productive — without this, a 20 s recovery gap
        # under churn would be booked as productive (only >300 s
        # silences were excluded) and goodput would read ~100% no
        # matter how often the job dies.  The window holds raw gaps
        # (outliers included): a lone restart barely moves the
        # median, while a legitimate regime change (scale-down makes
        # steps 4x slower) shifts it within a window's worth of steps
        # — an EMA that skips outliers would freeze instead
        self._gap_window: Deque[float] = deque(maxlen=64)
        # event-log goodput ledger override: when the master's ledger
        # service has a fresh cross-process attribution, goodput() is
        # re-derived from it (the step-gap ratio stays available as
        # legacy_goodput() and on the *_monitor gauge)
        self._ledger_goodput: Optional[float] = None
        self._ledger_goodput_ts = 0.0
        self._ledger_ttl = 120.0

    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_model_flops(
        self, flops_per_sample: float, peak_flops: float
    ):
        """Enable MFU: per-sample model FLOPs (~6N x seq for a decoder
        LM) and the cluster's aggregate peak FLOP/s."""
        with self._lock:
            self._flops_per_sample = flops_per_sample
            self._peak_flops = peak_flops

    def collect_global_step(self, step: int, timestamp: float = 0.0):
        ts = timestamp or time.time()
        with self._lock:
            if step > self._global_step:
                # productive time: gaps between consecutive NEW-step
                # reports.  A gap well above the typical step time
                # (restart, rendezvous, recompute of lost steps) is
                # capped at ~one step's worth; the rest is lost time.
                if self._last_productive_mark:
                    gap = ts - self._last_productive_mark
                    if 0 < gap < 300.0:
                        if self._gap_window:
                            med = statistics.median(self._gap_window)
                            self._productive_seconds += min(
                                gap, 3.0 * med
                            )
                        else:
                            # no baseline yet: allow a generous
                            # first-step/compile gap but never book a
                            # whole restart silence as productive
                            self._productive_seconds += min(gap, 60.0)
                        self._gap_window.append(gap)
                self._last_productive_mark = ts
                if not self._start_time:
                    self._start_time = ts
                self._global_step = step
                self._last_step_time = ts
                self._samples.append((ts, step))
                # write-through: registry readers (endpoint, textfile,
                # diagnosis) see exactly what this monitor computed
                self._step_gauge.set(step)
                self._speed_gauge.set(self._running_speed_locked())
                self._goodput_gauge.set(self._goodput_locked())

    @property
    def completed_global_step(self) -> int:
        # the instance field stays authoritative (registry gauges are
        # process-global, so a second monitor in the same process —
        # another job, a test — would alias reads through them); the
        # write-through keeps the export surface in lockstep
        with self._lock:
            return self._global_step

    @property
    def last_step_time(self) -> float:
        with self._lock:
            return self._last_step_time

    def note_recovery_action(self):
        """The master just acted on a hang verdict (culprit restart):
        reset the silence clock so the recovering trainer gets one
        full hang window to produce a step before it can be
        re-convicted."""
        with self._lock:
            self._last_step_time = time.time()

    def _running_speed_locked(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        (t0, s0), (t1, s1) = self._samples[0], self._samples[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)

    def running_speed(self) -> float:
        """Steps/sec over the sample window."""
        with self._lock:
            return self._running_speed_locked()

    def samples_per_second(self) -> float:
        return self.running_speed() * self._batch_size

    def mfu(self) -> float:
        """Model FLOPs utilization over the sample window (0 when
        ``set_model_flops`` was never called)."""
        if not self._peak_flops or not self._flops_per_sample:
            return 0.0
        return (
            self.samples_per_second() * self._flops_per_sample
            / self._peak_flops
        )

    def _goodput_locked(self) -> float:
        """Productive fraction of the TRAINING window [first step,
        last step] — the post-training tail (final persist, agent
        shutdown) is not churn loss and must not dilute the ratio the
        churn invariants assert on."""
        if not self._start_time:
            return 0.0
        wall = self._last_step_time - self._start_time
        if wall <= 0:
            return 0.0
        return min(1.0, self._productive_seconds / wall)

    def legacy_goodput(self) -> float:
        """The monitor's own step-gap ratio, bypassing any ledger
        override — the cross-check side of the divergence event."""
        with self._lock:
            return self._goodput_locked()

    def set_ledger_goodput(
        self, ratio: float, ts: Optional[float] = None
    ):
        """Install the event-log ledger's goodput as the value
        ``goodput()`` reports.  The override expires after
        ``_ledger_ttl`` seconds without refresh, so a dead ledger
        service degrades back to the step-gap ratio instead of
        freezing the metric."""
        with self._lock:
            self._ledger_goodput = max(0.0, min(1.0, float(ratio)))
            self._ledger_goodput_ts = ts or time.time()

    def goodput(self) -> float:
        """Fraction of training wall-clock spent making step progress
        — the north-star metric under churn (reference claim: 69% ->
        95% with fault tolerance + flash ckpt, README.md:55-57).
        Re-derived from the goodput ledger when the master's ledger
        service keeps it fresh; the step-gap ratio otherwise."""
        with self._lock:
            monitor = self._goodput_locked()
            self._monitor_goodput_gauge.set(monitor)
            ratio = monitor
            if self._ledger_goodput is not None and (
                time.time() - self._ledger_goodput_ts
                <= self._ledger_ttl
            ):
                ratio = self._ledger_goodput
            self._goodput_gauge.set(ratio)
            return ratio

    # -- membership-change windows ----------------------------------------

    def add_running_worker(self, node_id: int):
        with self._lock:
            self._running_workers.add(node_id)
            self._worker_adjustment_time = time.time()
            self._workers_gauge.set(len(self._running_workers))

    def remove_running_worker(self, node_id: int):
        with self._lock:
            self._running_workers.discard(node_id)
            self._worker_adjustment_time = time.time()
            self._workers_gauge.set(len(self._running_workers))

    @property
    def running_workers(self) -> Set[int]:
        with self._lock:
            return set(self._running_workers)

    def worker_adjustment_finished(self, settle_seconds: float = 60.0) -> bool:
        with self._lock:
            if not self._worker_adjustment_time:
                return True
            return time.time() - self._worker_adjustment_time > settle_seconds

    def all_worker_hanged(self, timeout: float = 1800.0) -> bool:
        """No step progress for ``timeout`` seconds despite running
        workers (feeds ``dist_master`` hang polling)."""
        with self._lock:
            if not self._running_workers or not self._samples:
                return False
            return time.time() - self._last_step_time > timeout
