"""Agent-side fault-diagnosis data collection.

Reference: ``DiagnosisMonitor`` + collectors
(``dlrover/python/elastic_agent/monitor/diagnosis.py:37``,
``elastic_agent/datacollector/{cuda_log_collector,log_collector,
metrics_collector}.py``): periodically collect stack traces of the
training processes, tail training logs, and sample chip metrics, and
report everything to the master so it can diagnose hangs and faults.
The CUDA-stack collector becomes a Python-stack collector
(``faulthandler``/py-spy-style via SIGUSR-free /proc sampling is not
portable, so we use faulthandler dumps for our own process tree and
``/proc/<pid>/`` state for supervised workers).

Copy of ``dlrover_tpu/agent/diagnosis.py``.  The chip-metrics
collector asks ``torch.cuda`` for memory stats, and only where this
process already holds a CUDA context: the agent never creates one (a
context takes memory on the training card), and reads no NVML either,
as the reference's collector reads only the devices its process owns.
"""

import faulthandler
import io
import json
import os
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

# agent-side no-step-progress threshold (seconds) before the watchdog
# captures hang flight data and ships it to the master; production
# default is minutes-scale, chaos/bench runs shrink it
HANG_THRESHOLD_ENV = "DLROVER_HANG_THRESHOLD_S"
DEFAULT_HANG_THRESHOLD = 300.0
# cap on the stack/proc evidence shipped per capture (event log line
# + RPC payload stay bounded no matter how many threads are alive)
_EVIDENCE_LIMIT = 8192

_HANG_CAPTURES_TOTAL = get_registry().counter(
    "dlrover_hang_evidence_captures_total",
    "Hang flight-data captures performed by the agent watchdog",
)


class DataCollector:
    data_type = "generic"

    def collect(self) -> str:
        raise NotImplementedError


class StackCollector(DataCollector):
    """All-thread Python stacks of this process (the agent) and the
    run-state of supervised worker pids (reference:
    cuda_log_collector's py-spy-style dump)."""

    data_type = "stack"

    def __init__(self, worker_pids_fn=None):
        self._worker_pids_fn = worker_pids_fn or (lambda: [])

    def collect(self) -> str:
        import sys

        parts = []
        for tid, frame in sys._current_frames().items():
            parts.append(f"Thread {tid}:")
            parts.extend(
                line.rstrip()
                for line in traceback.format_stack(frame)
            )
        for pid in self._worker_pids_fn():
            parts.append(self._proc_state(pid))
        return "\n".join(parts)

    @staticmethod
    def _proc_state(pid: int) -> str:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().split()
            state = fields[2] if len(fields) > 2 else "?"
            with open(f"/proc/{pid}/wchan") as f:
                wchan = f.read().strip()
            return f"worker pid {pid}: state={state} wchan={wchan}"
        except OSError:
            return f"worker pid {pid}: gone"


class LogCollector(DataCollector):
    """Tail of the training log file (reference: log_collector.py)."""

    data_type = "log"

    def __init__(self, log_path: str, tail_bytes: int = 16384):
        self._path = log_path
        self._tail = tail_bytes

    def collect(self) -> str:
        try:
            size = os.path.getsize(self._path)
            with open(self._path, "rb") as f:
                f.seek(max(0, size - self._tail))
                return f.read().decode(errors="replace")
        except OSError:
            return ""


class ChipMetricsCollector(DataCollector):
    """Device memory stats from ``torch.cuda`` when this process owns
    a CUDA context (reference: metrics_collector.py chip metrics).  It
    never makes one: without an initialised context in this process
    (the agent's case) it answers the reference's "unavailable"
    line."""

    data_type = "chip_metrics"

    def collect(self) -> str:
        try:
            import sys

            torch = sys.modules.get("torch")
            if torch is None or not torch.cuda.is_initialized():
                raise RuntimeError(
                    "no CUDA context in this process (the agent "
                    "never creates one)"
                )
            lines = []
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                limit = torch.cuda.get_device_properties(i).total_memory
                lines.append(
                    f"cuda:{i}: in_use="
                    f"{stats.get('allocated_bytes.all.current', 0)} "
                    f"limit={limit}"
                )
            return "\n".join(lines)
        except Exception as e:  # noqa: BLE001
            return f"chip metrics unavailable: {e}"


class StepTimeCollector(DataCollector):
    """Per-step wall time derived from the trainer's metrics file
    (successive polls: delta timestamp / delta step).  The master's
    straggler operator compares these ACROSS nodes — the reference's
    >2x-median rule needs a per-node step-duration signal."""

    data_type = "step_time"

    def __init__(self, metrics_path: Optional[str] = None):
        from dlrover_tpu_torch.agent.monitor import TrainingMonitor

        self._path = (
            metrics_path or TrainingMonitor.default_metrics_path()
        )
        self._last: Optional[tuple] = None  # (step, timestamp)

    def collect(self) -> str:
        import json
        import os

        try:
            if not os.path.exists(self._path):
                return ""
            with open(self._path) as f:
                record = json.load(f)
            step = int(record.get("global_step", -1))
            ts = float(record.get("timestamp", 0.0))
        except (OSError, ValueError):
            return ""
        prev, self._last = self._last, (step, ts)
        if prev and step > prev[0] and ts > prev[1]:
            return f"{(ts - prev[1]) / (step - prev[0]):.4f}"
        return ""  # no progress between polls: nothing to report


class StepPhaseCollector(DataCollector):
    """Rolling per-phase step breakdown from the trainer's metrics
    file (the :class:`~dlrover_tpu_torch.trainer.elastic_trainer
    .StepPhaseProfiler` writes ``record["phases"]``).  The master's
    data-starved operator reads these to tell an input-bound trainer
    from a compute-bound one."""

    data_type = "step_phases"

    def __init__(self, metrics_path: Optional[str] = None,
                 window: int = 8):
        from dlrover_tpu_torch.agent.monitor import TrainingMonitor

        self._path = (
            metrics_path or TrainingMonitor.default_metrics_path()
        )
        self._window = max(1, window)
        self._recent: List[Dict] = []
        self._last_step = -1

    def collect(self) -> str:
        from dlrover_tpu_torch.agent.monitor import read_metrics_record

        record = read_metrics_record(self._path)
        if not record:
            return ""
        step = int(record.get("global_step", -1))
        phases = record.get("phases")
        if step <= self._last_step or not isinstance(phases, dict):
            return ""
        self._last_step = step
        self._recent.append(phases)
        del self._recent[: -self._window]
        keys = {k for p in self._recent for k in p}
        mean = {
            k: round(
                sum(float(p.get(k, 0.0)) for p in self._recent)
                / len(self._recent), 6,
            )
            for k in keys
        }
        mean["n"] = len(self._recent)
        mean["step"] = step
        return json.dumps(mean)


# -- hang flight data --------------------------------------------------------


def _proc_tree(pid: int, depth: int = 0) -> List[str]:
    """``state/wchan/threads`` lines for ``pid`` and its descendants
    (``/proc/<pid>/task/*/children``) — the whole worker tree, so a
    dataloader child stuck in D-state is visible even when the main
    trainer thread looks idle."""
    lines: List[str] = []
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().split()
        state = fields[2] if len(fields) > 2 else "?"
        comm = fields[1].strip("()") if len(fields) > 1 else "?"
    except OSError:
        return [f"{'  ' * depth}pid {pid}: gone"]
    wchan = ""
    try:
        with open(f"/proc/{pid}/wchan") as f:
            wchan = f.read().strip()
    except OSError:
        pass
    threads = 0
    children: List[int] = []
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            threads += 1
            try:
                with open(
                    f"/proc/{pid}/task/{tid}/children"
                ) as f:
                    children.extend(
                        int(c) for c in f.read().split()
                    )
            except (OSError, ValueError):
                pass
    except OSError:
        pass
    lines.append(
        f"{'  ' * depth}pid {pid} ({comm}): state={state} "
        f"wchan={wchan or '-'} threads={threads}"
    )
    if depth < 4:
        for child in children:
            lines.extend(_proc_tree(child, depth + 1))
    return lines


def capture_hang_evidence(
    worker_pids: Optional[List[int]] = None,
) -> Dict[str, str]:
    """One hang flight-data capture: faulthandler all-thread stacks of
    THIS process (the agent — its monitor/RPC threads are part of the
    picture) plus the ``/proc`` state of the supervised worker tree.
    Pure collection, no thresholds; the watchdog decides when."""
    stacks = ""
    try:
        # faulthandler writes through a real fd; a temp file keeps the
        # capture signal-safe-adjacent and bounded
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            stacks = f.read()
    except Exception:  # noqa: BLE001 - degraded capture beats none
        buf = io.StringIO()
        import sys

        for tid, frame in sys._current_frames().items():
            buf.write(f"Thread {tid}:\n")
            buf.write("".join(traceback.format_stack(frame)))
        stacks = buf.getvalue()
    proc_lines: List[str] = []
    for pid in worker_pids or []:
        proc_lines.extend(_proc_tree(int(pid)))
    return {
        "stacks": stacks[-_EVIDENCE_LIMIT:],
        "workers": "\n".join(proc_lines)[:_EVIDENCE_LIMIT],
    }


class HangWatchdog:
    """No-step-progress detector on the agent (reference: the hang
    half of ``elastic_agent/monitor/diagnosis.py`` feeding
    ``check_training_hang_operator``).

    Tails the trainer-written metrics file; when the global step has
    not advanced for ``threshold`` seconds it captures hang flight
    data (:func:`capture_hang_evidence`), emits a ``hang_evidence``
    training event and ships the same payload to the master as
    ``DiagnosisData(data_type="hang_evidence")`` so the inference
    chain diagnoses with *stacks in hand* instead of silence alone.
    Re-captures are rate-limited to one per threshold window; step
    progress re-arms."""

    def __init__(
        self,
        metrics_path: Optional[str] = None,
        worker_pids_fn: Optional[Callable[[], List[int]]] = None,
        threshold: Optional[float] = None,
        interval: Optional[float] = None,
        client: Optional[MasterClient] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from dlrover_tpu_torch.agent.monitor import TrainingMonitor

        self._path = (
            metrics_path or TrainingMonitor.default_metrics_path()
        )
        self._worker_pids_fn = worker_pids_fn or (lambda: [])
        if threshold is None:
            threshold = env_utils._get_float(
                HANG_THRESHOLD_ENV, DEFAULT_HANG_THRESHOLD
            )
        self.threshold = max(0.1, float(threshold))
        self._interval = (
            interval if interval is not None
            else max(0.25, min(self.threshold / 4.0, 15.0))
        )
        self._client = client
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_step = -1
        self._last_progress = clock()
        self._last_capture = 0.0
        # armed only after the trainer PROVED progress since the last
        # (re)start: a cold start (interpreter + torch import + restore)
        # legitimately exceeds any useful threshold and must not read
        # as a hang — the master's guarded silence rule owns startup
        self._armed = False
        self.captures = 0

    def reset(self):
        """Re-baseline after a worker (re)start: the recovery window
        is not a stall, and pre-restart state must not convict the
        fresh incarnation."""
        self._last_progress = self._clock()
        self._last_capture = 0.0
        self._armed = False

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="hang-watchdog"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - the watchdog must
                # outlive any single bad poll
                logger.warning("hang watchdog poll failed: %s", e)

    def poll_once(self) -> Optional[Dict]:
        """One progress check; returns the evidence payload when a
        capture fired (tests drive this directly)."""
        from dlrover_tpu_torch.agent.monitor import read_metrics_record

        now = self._clock()
        record = read_metrics_record(self._path) or {}
        try:
            step = int(record.get("global_step", -1))
        except (TypeError, ValueError):
            step = -1
        if step > self._last_step:
            self._last_step = step
            self._last_progress = now
            self._last_capture = 0.0  # progress re-arms the watchdog
            self._armed = True
            return None
        if not self._armed:
            return None  # no progress witnessed yet: startup window
        stall = now - self._last_progress
        if stall < self.threshold:
            return None
        if (
            self._last_capture
            and now - self._last_capture < self.threshold
        ):
            return None  # rate limit: one capture per threshold window
        self._last_capture = now
        evidence = capture_hang_evidence(self._worker_pids_fn())
        payload = {
            "node_rank": env_utils.get_node_rank(),
            "stall_s": round(stall, 3),
            "last_step": self._last_step,
            "stacks": evidence["stacks"],
            "workers": evidence["workers"],
        }
        self.captures += 1
        _HANG_CAPTURES_TOTAL.inc()
        logger.warning(
            "hang watchdog: no step progress for %.1fs (last step "
            "%s); capturing flight data", stall, self._last_step,
        )
        emit_event("hang_evidence", **payload)
        client = self._client
        if client is None:
            try:
                client = MasterClient.singleton()
            except RuntimeError:
                client = None  # no master in this process: event only
        if client is not None:
            try:
                client.report_diagnosis_data(
                    "hang_evidence", json.dumps(payload)
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "hang evidence report to master failed: %s", e
                )
        return payload


class DiagnosisMonitor:
    """Periodic collection + report loop (reference:
    diagnosis.py:37,106)."""

    def __init__(
        self,
        collectors: Optional[List[DataCollector]] = None,
        interval: float = 60.0,
        client: Optional[MasterClient] = None,
        worker_pids_fn: Optional[Callable[[], List[int]]] = None,
    ):
        self._collectors = collectors if collectors is not None else [
            StackCollector(worker_pids_fn=worker_pids_fn),
            ChipMetricsCollector(),
            StepTimeCollector(),
            StepPhaseCollector(),
        ]
        self._interval = interval
        self._client = client or MasterClient.singleton()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_collector(self, collector: DataCollector):
        self._collectors.append(collector)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="diagnosis"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def report_once(self):
        for collector in self._collectors:
            try:
                content = collector.collect()
                if content:
                    self._client.report_diagnosis_data(
                        collector.data_type, content
                    )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "collector %s failed: %s", collector.data_type, e
                )

    def _run(self):
        while not self._stop.wait(self._interval):
            self.report_once()
