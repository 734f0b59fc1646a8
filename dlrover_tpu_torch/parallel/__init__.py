"""Parallelism layer (reference: ``dlrover_tpu/parallel/``): the mesh
and the partition rules, which become FSDP2 and DTensor placements on
``torch.distributed``.  ``moe`` and ``sequence`` come with slice 5.2
of the port, ``pipeline`` with 5.3."""

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
