"""Kubernetes operator: ElasticJob/ScalePlan reconciliation.

Copy of ``dlrover_tpu/operator/__init__.py``.  Reference: the Go
kubebuilder operator (``dlrover/go/operator/`` —
``ElasticJobReconciler`` creating the master pod per ElasticJob,
``scaleplan_controller.go``; CRD types in
``api/v1alpha1/elasticjob_types.go:29-118``).  Rebuilt as a Python
controller against the same API surface: CRD manifests in
``dlrover_tpu_torch/operator/crds/`` (the JAX package's, byte for byte)
and a reconciler loop that creates the job-master pod, tracks job
phase, and applies ScalePlans.
"""

from dlrover_tpu_torch.operator.reconciler import (
    ElasticJobReconciler,
    JobPhase,
)

__all__ = ["ElasticJobReconciler", "JobPhase"]
