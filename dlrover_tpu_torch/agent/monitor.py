"""Agent-side monitors: node resources, training progress, heartbeats.

Copy of ``dlrover_tpu/agent/monitor.py`` (the port imports nothing of
the JAX package).

Reference: ``dlrover/python/elastic_agent/monitor/resource.py:86``
(``ResourceMonitor``), ``monitor/training.py:77``
(``TorchTrainingMonitor``).  The resource monitor samples host
CPU/memory (psutil if available, /proc fallback) and reports to the
master; the training monitor tails the runtime-metrics file written by
the trainer and feeds the master's SpeedMonitor; heartbeats feed the
master's dead-node detection.
"""

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.metrics import get_registry

try:
    import psutil
except ImportError:  # pragma: no cover - psutil is normally present
    psutil = None

_REG = get_registry()
_REPORT_SECONDS = _REG.histogram(
    "dlrover_agent_report_seconds",
    "One monitor report cycle (sample + RPC to the master)",
)
_REPORT_ERRORS_TOTAL = _REG.counter(
    "dlrover_agent_report_errors_total",
    "Monitor report cycles that failed",
)
_HOST_CPU_GAUGE = _REG.gauge(
    "dlrover_host_cpu_percent", "Host CPU utilization sampled by the agent"
)
_HOST_MEM_GAUGE = _REG.gauge(
    "dlrover_host_memory_mb", "Host memory in use sampled by the agent"
)


def read_metrics_record(path: str) -> Optional[Dict]:
    """One atomic read of the trainer-written runtime-metrics file
    (written via tmp+rename, so a whole JSON object or nothing).
    Shared by the training monitor, the step-phase collector and the
    hang watchdog; None when absent/unparsable."""
    try:
        if not os.path.exists(path):
            return None
        with open(path) as f:
            record = json.load(f)
        return record if isinstance(record, dict) else None
    except (OSError, ValueError):
        return None


def get_host_stats() -> Dict[str, float]:
    """CPU percent + used memory MB for this host."""
    if psutil is not None:
        mem = psutil.virtual_memory()
        return {
            "cpu_percent": psutil.cpu_percent(),
            "memory_mb": mem.used / (1024 * 1024),
        }
    # /proc fallback
    try:
        with open("/proc/meminfo") as f:
            info = dict(
                line.split(":")[0:1] + [line.split()[1]]
                for line in f
                if ":" in line
            )
        total = float(info.get("MemTotal", 0))
        avail = float(info.get("MemAvailable", 0))
        return {
            "cpu_percent": float(os.getloadavg()[0]),
            "memory_mb": (total - avail) / 1024,
        }
    except OSError:
        return {"cpu_percent": 0.0, "memory_mb": 0.0}


def get_chip_stats() -> List[Dict[str, float]]:
    """Per-accelerator stats: none yet, as in the reference (whose TPU
    has no pynvml); the GPU's come from NVML in slice 8 of the port.
    The agent must not initialise CUDA for them: a context would hold
    memory on the training card."""
    return []


class ResourceMonitor:
    """Periodic host-stats reporter (reference: resource.py:86)."""

    def __init__(self, interval: float = 15.0,
                 client: Optional[MasterClient] = None):
        self._interval = interval
        self._client = client or MasterClient.singleton()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="resource-monitor"
            )
            self._thread.start()

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                with _REPORT_SECONDS.time(monitor="resource"):
                    stats = get_host_stats()
                    _HOST_CPU_GAUGE.set(stats["cpu_percent"])
                    _HOST_MEM_GAUGE.set(stats["memory_mb"])
                    self._client.report_resource_stats(
                        cpu_percent=stats["cpu_percent"],
                        memory_mb=stats["memory_mb"],
                        chip_stats=get_chip_stats(),
                    )
            except Exception as e:  # noqa: BLE001
                _REPORT_ERRORS_TOTAL.inc(monitor="resource")
                logger.warning("resource report failed: %s", e)

    def stop(self):
        self._stopped.set()


class TrainingMonitor:
    """Tails the metrics file written by the trainer's step loop and
    reports global step to the master (reference: monitor/training.py
    TorchTrainingMonitor + ElasticTrainer metrics file)."""

    METRICS_FILE_ENV = "DLROVER_METRICS_FILE"

    def __init__(self, metrics_path: str, interval: float = 15.0,
                 client: Optional[MasterClient] = None):
        self._path = metrics_path
        self._interval = interval
        self._client = client or MasterClient.singleton()
        self._stopped = threading.Event()
        self._last_step = -1
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def default_metrics_path() -> str:
        # the port's trainer writes its default under the temp dir
        # (which follows TMPDIR), where the reference's uses /tmp
        return os.getenv(
            TrainingMonitor.METRICS_FILE_ENV,
            os.path.join(tempfile.gettempdir(),
                         f"dlrover_metrics_{os.getuid()}.json"),
        )

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="training-monitor"
            )
            self._thread.start()

    def _run(self):
        while not self._stopped.wait(self._interval):
            self.report_once()
        # final flush: a short run (or a loaded machine starving this
        # thread) can finish before a single interval elapses — the
        # tail progress must still reach the master's SpeedMonitor
        self.report_once()

    def report_once(self):
        try:
            if not os.path.exists(self._path):
                return
            with _REPORT_SECONDS.time(monitor="training"):
                with open(self._path) as f:
                    record = json.load(f)
                step = int(record.get("global_step", -1))
                ts = float(record.get("timestamp", time.time()))
                if step > self._last_step:
                    self._client.report_global_step(step, ts)
                    self._last_step = step
        except (OSError, ValueError) as e:
            logger.debug("metrics file read failed: %s", e)
        except Exception as e:  # noqa: BLE001
            _REPORT_ERRORS_TOTAL.inc(monitor="training")
            logger.warning("global-step report failed: %s", e)

    def stop(self):
        self._stopped.set()


class HeartbeatReporter:
    """Periodic heartbeat to the master's dead-node monitor
    (reference: master_client.report_heart_beat + job manager's
    heartbeat window, dist_job_manager.py:355)."""

    def __init__(self, interval: float = 15.0,
                 client: Optional[MasterClient] = None):
        self._interval = interval
        self._client = client or MasterClient.singleton()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_action = ""

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="heartbeat"
            )
            self._thread.start()

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                with _REPORT_SECONDS.time(monitor="heartbeat"):
                    action = self._client.report_heartbeat()
                # the master delivers an action exactly once (popped
                # from its queue on this ack): an empty later ack
                # must not clobber one the agent loop has not
                # consumed yet — the consumer clears it
                if action:
                    self.last_action = action
            except Exception as e:  # noqa: BLE001
                _REPORT_ERRORS_TOTAL.inc(monitor="heartbeat")
                logger.warning("heartbeat failed: %s", e)

    def stop(self):
        self._stopped.set()
