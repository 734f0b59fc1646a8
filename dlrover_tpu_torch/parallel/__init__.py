"""Parallelism layer (reference: ``dlrover_tpu/parallel/``): the mesh
and the partition rules, which become FSDP2 and DTensor placements on
``torch.distributed``; ``sequence`` (ring and Ulysses attention),
``moe`` (the expert-parallel MoE layer) and ``pipeline`` (GPipe and
1F1B over the ``pipeline`` axis)."""

from dlrover_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.sharding import (
    PartitionRules,
    placements_for,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "PartitionRules",
    "build_mesh",
    "placements_for",
]
