"""Device-mesh construction on ``torch.distributed``.

Reference: ``dlrover_tpu/parallel/mesh.py`` (one ``jax.sharding.Mesh``
whose named axes carry every parallelism flavour).  Here a
:class:`Mesh` is the logical shape over the same axis names and, when a
process group exists, a ``torch.distributed`` ``DeviceMesh`` over the
axes the port runs: ``data`` (batch split, params replicated), ``fsdp``
(batch split, params and optimizer state sharded, FSDP2), ``sequence``
(the sequence split: ring or Ulysses attention,
:mod:`dlrover_tpu_torch.parallel.sequence`), ``expert`` (MoE expert
kernels split, the batch replicated: :mod:`dlrover_tpu_torch.parallel.moe`)
``tensor`` (Megatron-style tensor parallelism, DTensor) and
``pipeline`` (stage-stacked blocks, one stage a rank:
:mod:`dlrover_tpu_torch.parallel.pipeline`; ``mesh.group("pipeline")``
is the stage group).  One device is one rank.

The reference's ICI/DCN split becomes intra-node/inter-node (NVLink
against the network): ``num_slices`` is the node count, and only the
bandwidth-light axes (``data``, ``pipeline``) may span nodes.  Ranks
are laid out row-major over (data, pipeline, fsdp, sequence, expert,
tensor), so with one node's ranks consecutive, the inner axes stay
inside a node whenever their product divides the node's rank count, and
the nodes split ``data`` first, then ``pipeline``.

A world of one with no process group builds a mesh with no
``DeviceMesh``: it shards nothing, as the reference's one-device mesh
does.  With a process group (even of one rank) the ``DeviceMesh`` is
built, so FSDP2's hooks and DTensor parameters run.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common import env_utils

AXES = ("data", "fsdp", "tensor", "sequence", "expert", "pipeline")

# bandwidth-light axes may span nodes (the reference's DCN_AXES);
# fsdp all-gathers/reduce-scatters, tensor all-reduces and the
# sequence/expert all-to-alls stay inside a node (its ICI_AXES)
DCN_AXES = ("data", "pipeline")
ICI_AXES = ("fsdp", "tensor", "sequence", "expert")
# the axes a DeviceMesh of the port carries, outermost first: the
# node-spanning axes outside, in the order that absorbs the nodes
TORCH_AXES = ("data", "pipeline", "fsdp", "sequence", "expert", "tensor")


@dataclass
class MeshConfig:
    """Logical mesh shape; -1 on ``data`` absorbs remaining devices.
    ``num_slices`` = 0 detects the node count from the launcher's env;
    >1 names it (see :func:`build_mesh`)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipeline: int = 1
    num_slices: int = 0

    def axis_sizes(self, num_devices: int) -> Dict[str, int]:
        sizes = {
            "data": self.data,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "sequence": self.sequence,
            "expert": self.expert,
            "pipeline": self.pipeline,
        }
        fixed = 1
        for name, size in sizes.items():
            if size > 0:
                fixed *= size
        unknown = [n for n, s in sizes.items() if s <= 0]
        if len(unknown) > 1:
            raise ValueError(f"only one axis may be -1, got {unknown}")
        if unknown:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"product {fixed}"
                )
            sizes[unknown[0]] = num_devices // fixed
        else:
            if fixed != num_devices:
                raise ValueError(
                    f"mesh {sizes} needs {fixed} devices, have "
                    f"{num_devices}"
                )
        return sizes

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshConfig":
        return cls(**{
            k: v for k, v in d.items()
            if k in AXES or k == "num_slices"
        })


def detect_num_slices() -> int:
    """Nodes in the job: the world over one node's ranks, from the
    launcher's env (1 when it is not set)."""
    world = env_utils.get_world_size()
    local = max(1, env_utils.get_local_world_size())
    return max(1, world // local)


def split_axes_dcn_ici(
    sizes: Dict[str, int], num_slices: int
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Factor each axis into (inter-node, intra-node) extents: the node
    count is absorbed by the axes that may span nodes (data first, then
    pipeline); the others must fit inside one node."""
    dcn = {a: 1 for a in AXES}
    remaining = num_slices
    for a in DCN_AXES:
        g = math.gcd(sizes[a], remaining)
        dcn[a] = g
        remaining //= g
    if remaining != 1:
        raise ValueError(
            f"cannot place {num_slices} nodes on the axes {DCN_AXES} of "
            f"mesh {sizes}: data*pipeline="
            f"{sizes['data'] * sizes['pipeline']} does not absorb it "
            f"(bandwidth-hungry axes {ICI_AXES} may not span nodes)"
        )
    ici = {a: sizes[a] // dcn[a] for a in AXES}
    return dcn, ici


@dataclass
class Mesh:
    """The logical mesh: ``shape`` by axis name (all of :data:`AXES`),
    the device type, and the ``DeviceMesh`` over :data:`TORCH_AXES`
    (None with no process group: one device, nothing sharded)."""

    shape: Dict[str, int]
    device_type: str = "cuda"
    device_mesh: Optional[object] = None
    num_slices: int = 1
    _groups: Dict[str, object] = field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def __getitem__(self, axes):
        """The sub-``DeviceMesh`` over one axis name or a tuple of them."""
        if self.device_mesh is None:
            raise RuntimeError("a mesh with no process group has no "
                               "DeviceMesh")
        return self.device_mesh[axes]

    def group(self, axis: str):
        """The process group of one axis, or None when it holds one
        rank (or there is no process group)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            self._groups[axis] = self.device_mesh[axis].get_group()
        return self._groups[axis]

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis (0 with no process group)."""
        coord = {a: 0 for a in AXES}
        if self.device_mesh is not None:
            for a, i in zip(TORCH_AXES,
                            self.device_mesh.get_coordinate() or ()):
                coord[a] = i
        return coord


def build_mesh(
    config: Optional[MeshConfig] = None,
    world_size: Optional[int] = None,
    device_type: str = "cuda",
    num_slices: Optional[int] = None,
) -> Mesh:
    """Build the mesh over the process group's ranks (one device each).

    ``world_size`` defaults to the process group's size, or 1 when there
    is none.  Multi-node (``num_slices`` > 1, detected from the
    launcher's env when not given): ``data``/``pipeline`` must absorb
    the node count, so ``fsdp``/``tensor`` collectives stay on NVLink
    (the reference's hybrid ICI/DCN mesh)."""
    import torch.distributed as dist

    config = config or MeshConfig()
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    sizes = config.axis_sizes(world_size)
    if num_slices is None:
        num_slices = config.num_slices or detect_num_slices()
    if num_slices > 1:
        split_axes_dcn_ici(sizes, num_slices)  # raises when it cannot
    device_mesh = None
    if initialized:
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"a mesh of {world_size} ranks in a process group of "
                f"{dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(
            device_type, tuple(sizes[a] for a in TORCH_AXES),
            mesh_dim_names=TORCH_AXES,
        )
    elif world_size != 1:
        raise ValueError(f"a mesh of {world_size} devices needs a process "
                         "group (torch.distributed.init_process_group)")
    return Mesh(shape=sizes, device_type=device_type,
                device_mesh=device_mesh, num_slices=num_slices)


_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Mesh):
    """Register the mesh model-internal collectives should use; set by
    :func:`dlrover_tpu_torch.accel.accelerate.build_from_plan`."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Mesh:
    if _GLOBAL_MESH is None:
        raise RuntimeError(
            "no global mesh set; call set_global_mesh (or use "
            "auto_accelerate, which sets it)"
        )
    return _GLOBAL_MESH


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes the global batch's rows are split over (its sequence
    dim goes over ``sequence``)."""
    return ("data", "fsdp")


def dp_world_size(mesh: Mesh) -> int:
    return mesh.shape["data"] * mesh.shape["fsdp"]
