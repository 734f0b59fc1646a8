"""Standalone cluster monitor feeding the Brain datastore.

Copy of ``dlrover_tpu/brain/cluster_monitor.py`` (the port imports nothing of the JAX
package).

Reference: the Go k8smonitor (``go/brain/cmd/k8smonitor/main.go`` +
``pkg/platform/k8s/watcher``): a deployment-level process — NOT tied
to any one job master — that watches cluster pod events and persists
them so the Brain's optimizers learn from every job that ever ran,
including jobs whose masters died.  TPU rebuild: a watch-driven loop
over :class:`~dlrover_tpu_torch.scheduler.kubernetes.K8sClient` (real or
mock API), aggregating per-job pod state into the sqlite datastore
(``brain/datastore.py``) as metric rows tagged with the lifecycle
event that produced them.

Runnable standalone::

    python -m dlrover_tpu_torch.brain.cluster_monitor \
        --namespace prod --db /var/lib/dlrover/brain.db
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

from dlrover_tpu_torch.brain.service import JobMetricRecord
from dlrover_tpu_torch.common.log import default_logger as logger


def record_goodput_attribution(
    store, job_name: str, attribution: Dict,
    timestamp: Optional[float] = None,
) -> None:
    """Persist a flight-recorder goodput-loss diagnosis
    (:func:`dlrover_tpu_torch.telemetry.timeline.attribute_goodput_loss`)
    into the Brain datastore — the diagnosis layer learns from the
    SAME numbers the operator's /timeline report shows, instead of
    re-deriving its own.  One row per attribution pass, cause buckets
    in the extra columns."""
    buckets = dict(attribution.get("buckets") or {})
    store.persist(
        JobMetricRecord(
            job_name=job_name,
            timestamp=timestamp or time.time(),
            finished=False,
        ),
        event="goodput_attribution",
        goodput=attribution.get("goodput"),
        window_s=attribution.get("window_s"),
        training_s=attribution.get("training_s"),
        loss_s=attribution.get("loss_s"),
        **{f"loss_{cause}_s": v for cause, v in buckets.items()},
    )


def record_diagnosis_verdicts(
    store, job_name: str, events: Iterable[Dict]
) -> int:
    """Persist every ``diagnosis_verdict`` event (hang / straggler /
    data-starved, with measured durations) into the Brain datastore —
    the cluster-level optimizer learns which nodes and jobs hang or
    straggle, not just how much goodput was lost.  Returns the row
    count."""
    n = 0
    for e in events:
        if e.get("type") != "diagnosis_verdict":
            continue
        store.persist(
            JobMetricRecord(
                job_name=job_name,
                timestamp=float(e.get("ts") or time.time()),
                finished=False,
            ),
            event="diagnosis_verdict",
            verdict=e.get("verdict") or e.get("action"),
            action=e.get("action"),
            culprit_node=e.get("culprit_node"),
            hung=bool(e.get("hung")),
            stall_s=e.get("stall_s"),
            duration_s=e.get("duration_s"),
        )
        n += 1
    return n


def record_throughput_snapshot(
    store, job_name: str, workers: int, samples_per_sec: float,
    global_step: int = 0, timestamp: Optional[float] = None,
) -> None:
    """Persist one live (workers, throughput) observation.  The
    goodput/verdict rows from :func:`ingest_job_events` explain WHERE
    time went; these rows are the raw material of the Brain's
    throughput heuristics (``generate_worker_plan`` groups
    samples_per_sec by worker count), so the master's auto-ingest
    cadence records them alongside."""
    store.persist(
        JobMetricRecord(
            job_name=job_name,
            timestamp=timestamp or time.time(),
            workers=int(workers),
            samples_per_sec=float(samples_per_sec),
            finished=False,
        ),
        event="throughput_snapshot",
        global_step=int(global_step),
    )


def record_serving_fleet_snapshot(
    store, job_name: str, snapshot: Dict,
    timestamp: Optional[float] = None,
) -> None:
    """Persist one routed-QPS/freshness window from the serving-fleet
    lookup router (:meth:`LookupRouter.stats_snapshot`) — the serving
    analog of :func:`record_throughput_snapshot`: QPS grouped by pool
    size is the raw material a ``ResizeCoordinator``-style optimizer
    needs to grow/shrink the replica pool."""
    store.persist(
        JobMetricRecord(
            job_name=job_name,
            timestamp=timestamp or time.time(),
            workers=int(snapshot.get("members_up", 0)),
            samples_per_sec=float(snapshot.get("qps", 0.0)),
            finished=False,
        ),
        event="serving_fleet_snapshot",
        routed=int(snapshot.get("count", 0)),
        failed=int(snapshot.get("failed", 0)),
        stale=int(snapshot.get("stale", 0)),
        rerouted=int(snapshot.get("rerouted", 0)),
        p99_ms=snapshot.get("p99_ms"),
        generation_floor=int(snapshot.get("generation_floor", -1)),
        members_draining=int(snapshot.get("members_draining", 0)),
        members_suspect=int(snapshot.get("members_suspect", 0)),
    )


def suggest_serving_pool_size(
    snapshot: Dict,
    qps_per_replica: float,
    min_size: int = 1,
    max_size: int = 8,
    headroom: float = 1.25,
) -> int:
    """Pool-size recommendation from one router snapshot: enough
    healthy replicas to carry the observed routed QPS at
    ``qps_per_replica`` with ``headroom``, never below what drain
    safety needs (one member must always be able to re-base while the
    rest carry traffic)."""
    qps = float(snapshot.get("qps", 0.0))
    need = qps * headroom / max(1e-9, qps_per_replica)
    size = max(min_size, int(need) + (need > int(need)))
    # a pool carrying traffic needs a spare member so one can drain
    # for a re-base while the rest keep serving
    if (
        snapshot.get("members_draining", 0) or (qps > 0 and size == 1)
    ) and max_size >= 2:
        size = max(size, 2)
    return min(max_size, size)


def ingest_job_events(
    store, job_name: str, sources: Iterable[str]
) -> Optional[Dict]:
    """Assemble a job's shipped event logs and persist the resulting
    goodput diagnosis + diagnosis verdicts; returns the attribution
    (None when the logs hold no training window)."""
    from dlrover_tpu_torch.telemetry import timeline as _timeline

    events = _timeline.collect_events(sources)
    if not events:
        return None
    record_diagnosis_verdicts(store, job_name, events)
    tl = _timeline.assemble(events)
    if tl.window is None:
        # lifecycle events but no train_step: the job never trained,
        # so there is no goodput to attribute — persisting the zeroed
        # default would record a failed job as goodput=1.0
        return None
    attribution = _timeline.attribute_goodput_loss(tl)
    record_goodput_attribution(store, job_name, attribution)
    return attribution


@dataclass
class JobState:
    """Aggregated live view of one job's pods."""

    job_name: str
    running: int = 0
    pending: int = 0
    failed: int = 0
    succeeded: int = 0
    relaunches: int = 0
    oom_kills: int = 0
    first_seen: float = field(default_factory=time.time)
    pod_phase: Dict[str, str] = field(default_factory=dict)


class ClusterMonitor:
    """Watch-driven pod-event aggregator (reference: the k8s watcher
    manager's pod event handlers feeding the datastore)."""

    def __init__(
        self,
        client,
        store,
        label_selector: str = "app=dlrover-tpu",
        snapshot_interval: float = 60.0,
    ):
        self._client = client
        self._store = store
        self._selector = label_selector
        self._interval = snapshot_interval
        self._jobs: Dict[str, JobState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    # -- event handling -----------------------------------------------------

    @staticmethod
    def _job_of(pod: Dict) -> Optional[str]:
        labels = pod.get("metadata", {}).get("labels") or {}
        return labels.get("job") or labels.get("elasticjob-name")

    def handle_event(self, etype: str, pod: Dict):
        job_name = self._job_of(pod)
        if not job_name:
            return
        name = pod.get("metadata", {}).get("name", "")
        phase = (pod.get("status") or {}).get("phase", "")
        reason = (pod.get("status") or {}).get("reason", "")
        with self._lock:
            js = self._jobs.setdefault(job_name, JobState(job_name))
            prev = js.pod_phase.get(name, "")
            if etype == "deleted":
                # the pod is GONE whatever its last phase said — a
                # deletion while Running/Pending (preemption,
                # scale-down) is a loss, and leaving the stale phase
                # in place would report workers=N forever and block
                # 'finished' for every normally-torn-down job
                js.pod_phase.pop(name, None)
                if prev in ("Running", "Pending"):
                    js.failed += 1
                    if "oom" in reason.lower():
                        js.oom_kills += 1
                self._persist_locked(
                    js, event=f"deleted:{prev or phase or '-'}"
                )
                return
            js.pod_phase[name] = phase
            if phase == prev:
                return
            if phase == "Failed":
                js.failed += 1
                if "oom" in reason.lower():
                    js.oom_kills += 1
            elif phase == "Succeeded":
                js.succeeded += 1
            elif etype == "added" and prev == "" and (
                js.failed + js.succeeded
            ) > 0:
                # a new pod after deaths = a relaunch
                js.relaunches += 1
            self._persist_locked(js, event=f"{etype}:{phase or '-'}")

    def _persist_locked(self, js: JobState, event: str):
        counts = {"Running": 0, "Pending": 0}
        for ph in js.pod_phase.values():
            if ph in counts:
                counts[ph] += 1
        js.running = counts["Running"]
        js.pending = counts["Pending"]
        self._store.persist(
            JobMetricRecord(
                job_name=js.job_name,
                timestamp=time.time(),
                workers=js.running,
                finished=bool(
                    js.succeeded and not js.running and not js.pending
                ),
            ),
            event=event,
            failed=js.failed,
            relaunches=js.relaunches,
            oom_kills=js.oom_kills,
        )

    # -- loops --------------------------------------------------------------

    def _watch_loop(self):
        while not self._stop.is_set():
            try:
                for etype, pod in self._client.watch_pods(
                    self._selector
                ):
                    if self._stop.is_set():
                        return
                    try:
                        self.handle_event(etype, pod)
                    except Exception:  # noqa: BLE001
                        logger.exception("pod event handling failed")
            except Exception as e:  # noqa: BLE001
                logger.warning("cluster watch error: %s; rewatch", e)
            self._stop.wait(1.0)

    def _snapshot_loop(self):
        while not self._stop.wait(self._interval):
            with self._lock:
                for js in self._jobs.values():
                    self._persist_locked(js, event="snapshot")

    def start(self):
        for target, name in (
            (self._watch_loop, "cluster-watch"),
            (self._snapshot_loop, "cluster-snapshot"),
        ):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()

    def job_states(self) -> Dict[str, JobState]:
        with self._lock:
            return dict(self._jobs)


def main(argv=None) -> int:
    import argparse

    from dlrover_tpu_torch.brain.datastore import SqliteJobMetricsStore
    from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

    parser = argparse.ArgumentParser(
        description="DLRover cluster monitor -> Brain datastore"
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--db", default="brain_metrics.db")
    parser.add_argument("--selector", default="app=dlrover-tpu")
    parser.add_argument("--snapshot-interval", type=float, default=60.0)
    args = parser.parse_args(argv)
    client = K8sClient(namespace=args.namespace)
    store = SqliteJobMetricsStore(args.db)
    mon = ClusterMonitor(
        client, store, label_selector=args.selector,
        snapshot_interval=args.snapshot_interval,
    )
    mon.start()
    logger.info(
        "cluster monitor watching %s (selector %s) -> %s",
        args.namespace, args.selector, args.db,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        mon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
