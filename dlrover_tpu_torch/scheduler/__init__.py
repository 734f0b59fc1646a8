"""Cluster substrate clients (reference: ``dlrover/python/scheduler/``
— k8sClient, RayClient, JobArgs per platform).

Copy of ``dlrover_tpu/scheduler/__init__.py`` (the port imports
nothing of the JAX package).
"""

from dlrover_tpu_torch.scheduler.job_args import JobArgs, NodeArgs, new_job_args
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

__all__ = ["JobArgs", "K8sClient", "NodeArgs", "new_job_args"]
