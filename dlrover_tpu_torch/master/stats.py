"""Job runtime stats collection + reporting.

Copy of ``dlrover_tpu/master/stats.py`` (the port imports nothing of
the JAX package).

Reference: ``master/stats/`` (``job_collector.py:185`` JobMetricCollector,
``reporter.py:233``, ``training_metrics.py:169``): the master collects
node resources, model info and custom metrics per job and ships them
to the Brain datastore (cluster mode) or the local log; error events
are additionally emitted as k8s events (``error_monitor.py:77``).
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class TrainingMetrics:
    """Reference: training_metrics.py — what the collector ships."""

    job_name: str = ""
    workers: int = 0
    samples_per_sec: float = 0.0
    global_step: int = 0
    mfu: float = 0.0
    goodput: float = 0.0
    model_params: int = 0
    node_resources: Dict[str, Dict] = field(default_factory=dict)
    custom: Dict[str, float] = field(default_factory=dict)


class StatsReporter:
    """Where metrics land (reference: reporter.py — Brain in cluster
    mode, the log otherwise)."""

    def report(self, metrics: TrainingMetrics):
        logger.info(
            "job %s: step=%s %.1f samples/s mfu=%.3f goodput=%.3f "
            "workers=%s",
            metrics.job_name, metrics.global_step,
            metrics.samples_per_sec, metrics.mfu, metrics.goodput,
            metrics.workers,
        )


class BrainStatsReporter(StatsReporter):
    """Persists to the Brain datastore (cluster mode)."""

    def __init__(self, store, job_name: str):
        self._store = store
        self._job_name = job_name

    def report(self, metrics: TrainingMetrics):
        from dlrover_tpu_torch.brain.service import JobMetricRecord

        self._store.persist(
            JobMetricRecord(
                job_name=self._job_name,
                timestamp=time.time(),
                workers=metrics.workers,
                samples_per_sec=metrics.samples_per_sec,
                model_params=metrics.model_params,
            )
        )


class JobMetricCollector:
    """Periodically assembles TrainingMetrics from the master's
    monitors and ships them (reference: job_collector.py:185)."""

    def __init__(
        self,
        job_name: str,
        speed_monitor,
        job_manager=None,
        reporter: Optional[StatsReporter] = None,
        interval: float = 60.0,
    ):
        self._job_name = job_name
        self._speed_monitor = speed_monitor
        self._job_manager = job_manager
        self._reporter = reporter or StatsReporter()
        self._interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.model_params = 0
        self._node_resources: Dict[str, Dict] = {}

    def collect_node_resource(self, node_id: int, usage: Dict):
        """Agents' ResourceMonitor reports land here."""
        self._node_resources[str(node_id)] = dict(usage)

    def collect_model_info(self, num_params: int):
        self.model_params = num_params

    def snapshot(self) -> TrainingMetrics:
        workers = 0
        if self._job_manager is not None:
            workers = len(
                self._speed_monitor.running_workers
            ) or sum(
                1 for n in self._job_manager.all_nodes().values()
                if n.is_alive()
            )
        return TrainingMetrics(
            job_name=self._job_name,
            workers=workers,
            samples_per_sec=self._speed_monitor.samples_per_second(),
            global_step=self._speed_monitor.completed_global_step,
            mfu=self._speed_monitor.mfu(),
            goodput=self._speed_monitor.goodput(),
            model_params=self.model_params,
            node_resources=dict(self._node_resources),
        )

    def report_once(self):
        self._reporter.report(self.snapshot())

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="stats-collector"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.report_once()
            except Exception:  # noqa: BLE001
                logger.exception("stats report failed")


def emit_k8s_event(
    client, job_name: str, reason: str, message: str,
    event_type: str = "Warning",
):
    """Record a k8s Event on the job (reference: K8sJobErrorMonitor,
    error_monitor.py:77 — surfacing errors where kubectl shows them)."""
    body = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "name": f"{job_name}-{reason.lower()}-{int(time.time())}",
            "labels": {"app": "dlrover-tpu", "job": job_name},
        },
        "type": event_type,
        "reason": reason,
        "message": message,
        "involvedObject": {
            "apiVersion": "elastic.dlrover-tpu.org/v1alpha1",
            "kind": "ElasticJob",
            "name": job_name,
        },
    }
    try:
        return client.api.create_custom_resource(
            "", "v1", client.namespace, "events", body
        )
    except Exception as e:  # noqa: BLE001
        logger.warning("k8s event emission failed: %s", e)
        return False
