"""Per-stage optimizer-algorithm chain.

Copy of ``dlrover_tpu/brain/optimizer_chain.py`` (the port imports nothing of the JAX
package).

Reference: the Go Brain's optimizer implementation
(``go/brain/pkg/optimizer/implementation/optalgorithm/`` — one
algorithm per job stage: ``optimize_job_worker_create_resource.go``,
``optimize_job_worker_resource.go``, OOM/cold-create/hot-PS stages)
dispatched by the optimizer per request.  The TPU chain keeps the
same shape: a stage-keyed registry of small algorithms, each taking
an :class:`OptimizeContext` and refining the
:class:`~dlrover_tpu_torch.master.resource_optimizer.ResourcePlan`.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.resource_optimizer import ResourcePlan


class JobStage:
    CREATE = "create"          # before any worker ran
    INIT_ADJUST = "init"       # first minutes of running
    RUNNING = "running"        # steady state
    OOM = "oom"                # a worker just OOMed


@dataclass
class OptimizeContext:
    job_name: str = ""
    model_params: int = 0
    current_workers: int = 0
    samples_per_sec: float = 0.0
    memory_mb: float = 0.0
    memory_limit_mb: float = 0.0
    chip_util: float = 0.0     # 0..1 duty cycle if known
    history: List = field(default_factory=list)  # JobMetricRecords


class OptAlgorithm:
    """One stage algorithm (reference: the OptimizeAlgorithm
    interface in optalgorithm/)."""

    name = "base"

    def optimize(
        self, ctx: OptimizeContext, plan: ResourcePlan
    ) -> ResourcePlan:
        raise NotImplementedError


class WorkerCreateResource(OptAlgorithm):
    """Initial worker count from the most-similar completed job
    (reference: optimize_job_worker_create_resource.go)."""

    name = "worker-create-resource"

    def optimize(self, ctx, plan):
        history = [
            r for r in ctx.history if r.finished and r.workers
        ]
        if not history:
            plan.worker_count = max(plan.worker_count, 1)
            plan.comment = "no history; start minimal"
            return plan
        if ctx.model_params:
            history.sort(
                key=lambda r: abs(r.model_params - ctx.model_params)
            )
        best = max(
            history[: max(2, len(history) // 4)],
            key=lambda r: r.samples_per_sec / max(r.workers, 1),
        )
        plan.worker_count = best.workers
        plan.comment = f"from similar job {best.job_name}"
        return plan


class WorkerResource(OptAlgorithm):
    """Steady-state worker count from observed per-worker throughput
    (reference: optimize_job_worker_resource.go)."""

    name = "worker-resource"

    def optimize(self, ctx, plan):
        by_workers: Dict[int, List[float]] = {}
        for r in ctx.history:
            if r.job_name == ctx.job_name and r.workers and (
                r.samples_per_sec
            ):
                by_workers.setdefault(r.workers, []).append(
                    r.samples_per_sec
                )
        if not by_workers:
            plan.worker_count = ctx.current_workers
            return plan
        per_worker = {
            w: (sum(v) / len(v)) / w for w, v in by_workers.items()
        }
        best_w = max(per_worker, key=per_worker.get)
        cur = ctx.current_workers
        if cur in per_worker and per_worker[cur] >= 0.9 * (
            per_worker[best_w]
        ):
            untried = cur + 1
            if untried not in per_worker:
                plan.worker_count = untried
                plan.comment = "probe untried"
            else:
                plan.worker_count = cur
        else:
            plan.worker_count = best_w
            plan.comment = (
                f"best per-worker throughput at {best_w}"
            )
        return plan


class OomMemoryBump(OptAlgorithm):
    """Raise the memory request after an OOM (reference: the OOM
    resource adjustment in resource/job.py + hot-resource stages)."""

    name = "oom-memory-bump"
    FACTOR = 1.5

    def optimize(self, ctx, plan):
        base = ctx.memory_limit_mb or ctx.memory_mb
        if base:
            plan.memory_mb = int(base * self.FACTOR)
            plan.comment = f"OOM: memory -> {plan.memory_mb}MB"
        return plan


class UtilizationScaleDown(OptAlgorithm):
    """Shrink when chips idle: low duty cycle at steady state means
    the input pipeline or batch is the bottleneck, so fewer hosts do
    the same work (TPU-specific stage; the reference's CPU-util
    analog is optimize_job_ps_resource)."""

    name = "utilization-scale-down"
    THRESHOLD = 0.3

    def optimize(self, ctx, plan):
        if (
            0.0 < ctx.chip_util < self.THRESHOLD
            and ctx.current_workers > 1
        ):
            plan.worker_count = max(1, ctx.current_workers // 2)
            plan.comment = (
                f"chip util {ctx.chip_util:.0%} < "
                f"{self.THRESHOLD:.0%}: halve workers"
            )
        return plan


class OptimizerChain:
    """Stage -> ordered algorithms (reference: the per-request
    algorithm chain the Go optimizer builds)."""

    def __init__(self):
        self._stages: Dict[str, List[OptAlgorithm]] = {
            JobStage.CREATE: [WorkerCreateResource()],
            JobStage.INIT_ADJUST: [WorkerResource()],
            JobStage.RUNNING: [
                WorkerResource(), UtilizationScaleDown(),
            ],
            JobStage.OOM: [OomMemoryBump()],
        }

    def register(self, stage: str, algorithm: OptAlgorithm):
        self._stages.setdefault(stage, []).append(algorithm)

    def optimize(
        self, stage: str, ctx: OptimizeContext
    ) -> ResourcePlan:
        plan = ResourcePlan(worker_count=ctx.current_workers)
        for algo in self._stages.get(stage, []):
            plan = algo.optimize(ctx, plan)
            logger.debug(
                "stage %s algo %s -> workers=%s %s",
                stage, algo.name, plan.worker_count, plan.comment,
            )
        return plan
