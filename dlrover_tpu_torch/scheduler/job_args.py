"""Job arguments per platform.

Copy of ``dlrover_tpu/scheduler/job_args.py`` (the port imports
nothing of the JAX package).

Reference: ``JobArgs``/``K8sJobArgs`` (``dlrover/python/scheduler/
job.py``, ``kubernetes.py:392``): the declarative description of a
job's node groups (counts, resources, restart budgets) the master
initializes its node registry from.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    DistributionStrategy,
    NodeType,
    PlatformType,
)
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource


@dataclass
class NodeArgs:
    group_resource: NodeGroupResource = field(
        default_factory=NodeGroupResource
    )
    auto_scale: bool = True
    restart_count: int = 3
    critical: bool = False


@dataclass
class JobArgs:
    platform: str = PlatformType.LOCAL
    namespace: str = "default"
    job_name: str = "local-job"
    distribution_strategy: str = DistributionStrategy.ALLREDUCE
    node_args: Dict[str, NodeArgs] = field(default_factory=dict)
    # elastic bounds for the worker group
    min_nodes: int = 1
    max_nodes: int = 1
    node_unit: int = 1
    enable_dynamic_sharding: bool = True
    enable_elastic_scheduling: bool = True
    relaunch_on_worker_failure: int = 3
    remove_exited_node: bool = True

    def worker_count(self) -> int:
        w = self.node_args.get(NodeType.WORKER)
        return w.group_resource.count if w else 0


def new_job_args(
    platform: str = PlatformType.LOCAL,
    job_name: str = "local-job",
    num_workers: int = 1,
    chips_per_node: int = 4,
    namespace: str = "default",
    min_nodes: int = 0,
    max_nodes: int = 0,
    node_unit: int = 1,
    num_evaluators: int = 0,
) -> JobArgs:
    args = JobArgs(
        platform=platform,
        namespace=namespace,
        job_name=job_name,
        min_nodes=min_nodes or num_workers,
        max_nodes=max_nodes or num_workers,
        node_unit=node_unit,
    )
    args.node_args[NodeType.WORKER] = NodeArgs(
        group_resource=NodeGroupResource(
            count=num_workers,
            node_resource=NodeResource(
                cpu=8, memory_mb=32 * 1024, chips=chips_per_node,
                chip_type="tpu",
            ),
        )
    )
    if num_evaluators:
        # evaluator flavour (reference: EvaluatorManager,
        # node/worker.py:66): side nodes running eval loops — outside
        # the training rendezvous, relaunched but never auto-scaled
        args.node_args[NodeType.EVALUATOR] = NodeArgs(
            group_resource=NodeGroupResource(
                count=num_evaluators,
                node_resource=NodeResource(
                    cpu=8, memory_mb=32 * 1024,
                    chips=chips_per_node, chip_type="tpu",
                ),
            ),
            auto_scale=False,
        )
    return args
