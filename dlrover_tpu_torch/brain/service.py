"""Brain service: metrics store + history-driven resource plans.

Copy of ``dlrover_tpu/brain/service.py`` (the port imports nothing of the JAX
package).

Reference: the Go Brain (``dlrover/go/brain/``) persists job metrics
to MySQL and runs an optimizer chain (per-stage algorithms:
``optimize_job_worker_create_resource.go``,
``optimize_job_worker_resource.go``, hot-PS handling) consulted by the
master over gRPC (``dlrover/python/brain/client.py``).  This Python
service keeps the same roles with a JSON-file store: persist runtime
metrics per job, estimate initial resources for new jobs from similar
completed jobs, and refine worker counts from observed throughput —
exposed through the master's :class:`ResourceOptimizer` interface.
"""

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.resource_optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)


@dataclass
class JobMetricRecord:
    job_name: str = ""
    timestamp: float = 0.0
    workers: int = 0
    samples_per_sec: float = 0.0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    model_params: int = 0
    finished: bool = False


class JobMetricsStore:
    """Append-only JSONL store (the MySQL datastore's role)."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def persist(self, record: JobMetricRecord):
        with self._lock, open(self._path, "a") as f:
            f.write(json.dumps(asdict(record)) + "\n")

    def load(self, job_name: Optional[str] = None) -> List[JobMetricRecord]:
        if not os.path.exists(self._path):
            return []
        out = []
        with open(self._path) as f:
            for line in f:
                try:
                    rec = JobMetricRecord(**json.loads(line))
                except (TypeError, ValueError):
                    continue
                if job_name is None or rec.job_name == job_name:
                    out.append(rec)
        return out


class BrainService(ResourceOptimizer):
    """History-driven resource optimization.

    The per-stage algorithm chain
    (:mod:`dlrover_tpu_torch.brain.optimizer_chain`) mirrors the Go Brain's
    optalgorithm dispatch; the store can be the JSONL file here or
    the sqlite datastore (:mod:`dlrover_tpu_torch.brain.datastore`)."""

    def __init__(self, store, job_name: str = "", chain=None):
        from dlrover_tpu_torch.brain.optimizer_chain import OptimizerChain

        self._store = store
        self._job_name = job_name
        self._chain = chain or OptimizerChain()

    def optimize_stage(self, stage: str, **ctx_fields) -> ResourcePlan:
        """Run the stage's algorithm chain over the job history
        (reference: Brain.optimize RPC -> optimizer chain)."""
        from dlrover_tpu_torch.brain.optimizer_chain import OptimizeContext

        ctx = OptimizeContext(
            job_name=self._job_name,
            history=self._store.load(),
            **ctx_fields,
        )
        return self._chain.optimize(stage, ctx)

    # -- client surface (reference: BrainClient.persist_metrics /
    #    get_optimization_plan) --------------------------------------------

    def persist_metrics(self, **kwargs):
        self._store.persist(
            JobMetricRecord(
                job_name=self._job_name, timestamp=time.time(), **kwargs
            )
        )

    def initial_resource_plan(self, model_params: int = 0) -> ResourcePlan:
        """Estimate initial worker count from the most-similar
        completed job (reference: optimize_job_worker_create_resource
        stage algorithm)."""
        history = [
            r for r in self._store.load() if r.finished and r.workers
        ]
        if not history:
            return ResourcePlan(worker_count=1, comment="no history")
        if model_params:
            history.sort(
                key=lambda r: abs(r.model_params - model_params)
            )
        best = max(
            history[: max(2, len(history) // 4)],
            key=lambda r: r.samples_per_sec / max(r.workers, 1),
        )
        return ResourcePlan(
            worker_count=best.workers,
            comment=f"from similar job {best.job_name}",
        )

    def generate_worker_plan(
        self, current_workers: int, speed_monitor
    ) -> ResourcePlan:
        """Refine worker count from this job's throughput history
        (reference: optimize_job_worker_resource stage)."""
        records = self._store.load(self._job_name)
        by_workers: Dict[int, List[float]] = {}
        for r in records:
            if r.workers and r.samples_per_sec:
                by_workers.setdefault(r.workers, []).append(
                    r.samples_per_sec
                )
        if not by_workers:
            return ResourcePlan(worker_count=current_workers)
        per_worker = {
            w: (sum(v) / len(v)) / w for w, v in by_workers.items()
        }
        best_w = max(per_worker, key=per_worker.get)
        if (
            current_workers in per_worker
            and per_worker[current_workers] >= 0.9 * per_worker[best_w]
        ):
            # current setting near-optimal: probe one step up if
            # untried
            untried = current_workers + 1
            if untried not in per_worker:
                return ResourcePlan(
                    worker_count=untried, comment="probe untried"
                )
            return ResourcePlan(worker_count=current_workers)
        return ResourcePlan(
            worker_count=best_w,
            comment=f"best observed per-worker throughput at {best_w}",
        )
