"""Brain: cluster-level optimization services.

Copy of ``dlrover_tpu/brain/__init__.py`` (the port imports nothing of
the JAX package).

Reference: the Go Brain service (``dlrover/go/brain/`` — gRPC resource
optimizer over a MySQL metrics store) and its Python client +
hyperparameter search (``dlrover/python/brain/client.py:63``,
``brain/hpsearch/bo.py:30``).  This package provides the same
capabilities in-process: a Gaussian-process Bayesian optimizer for
hyperparameter/resource search and a metrics-store-backed resource
service pluggable into the master's resource optimizer interface.
"""

from dlrover_tpu_torch.brain.bo import BayesianOptimizer
from dlrover_tpu_torch.brain.service import BrainService, JobMetricsStore

__all__ = ["BayesianOptimizer", "BrainService", "JobMetricsStore"]
