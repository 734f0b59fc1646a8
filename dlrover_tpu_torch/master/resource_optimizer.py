"""Local (single-job) resource optimization heuristics.

Copy of ``dlrover_tpu/master/resource_optimizer.py`` (the port imports
nothing of the JAX package).

Reference: ``LocalOptimizer`` (``dlrover/python/master/resource/
local_optimizer.py``) + the PS/allreduce resource optimizers
(``resource/job.py``): derive a resource plan from observed runtime
stats without the cluster Brain service — worker count from throughput
trends, memory bumps on OOM.  The Brain-backed flavour plugs into the
same interface (:mod:`dlrover_tpu_torch.brain`).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor


@dataclass
class ResourcePlan:
    worker_count: int = 0
    node_resources: Dict[str, Dict] = field(default_factory=dict)
    memory_mb: int = 0  # per-node memory request override (OOM bump)
    comment: str = ""


class ResourceOptimizer:
    def generate_worker_plan(
        self, current_workers: int, speed_monitor: SpeedMonitor
    ) -> ResourcePlan:
        raise NotImplementedError


class LocalOptimizer(ResourceOptimizer):
    """Throughput-trend heuristic: grow while per-worker throughput
    scales, back off when it regresses (a simplified version of the
    reference's sample-driven estimation)."""

    def __init__(self, grow_step: int = 1):
        self._grow_step = grow_step
        # (workers, samples_per_sec) history
        self._history: List[tuple] = []

    def observe(self, workers: int, samples_per_sec: float):
        if workers > 0 and samples_per_sec > 0:
            self._history.append((workers, samples_per_sec))

    def generate_worker_plan(
        self, current_workers: int, speed_monitor: SpeedMonitor
    ) -> ResourcePlan:
        speed = speed_monitor.samples_per_second()
        self.observe(current_workers, speed)
        plan = ResourcePlan(worker_count=current_workers)
        if len(self._history) < 2:
            # not enough signal: keep (or probe upward once running)
            if speed > 0:
                plan.worker_count = current_workers + self._grow_step
                plan.comment = "probe scale-up"
            return plan
        (w_prev, s_prev), (w_now, s_now) = self._history[-2:]
        if w_now == w_prev:
            return plan
        per_prev = s_prev / max(w_prev, 1)
        per_now = s_now / max(w_now, 1)
        if w_now > w_prev and per_now >= 0.8 * per_prev:
            # scaling still efficient: keep growing
            plan.worker_count = w_now + self._grow_step
            plan.comment = "scaling efficient; grow"
        elif w_now > w_prev and per_now < 0.6 * per_prev:
            # efficiency collapsed: shrink back
            plan.worker_count = w_prev
            plan.comment = "scaling inefficient; back off"
        return plan
