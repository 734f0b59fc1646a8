"""Partition rules: parameter path patterns -> placements.

Reference: ``dlrover_tpu/parallel/sharding.py``.  A strategy emits
rules, ordered ``(regex, spec)`` pairs over the flax parameter paths
(first match wins; a spec names mesh axes per tensor dim), and GSPMD
inserts the collectives.  The port keeps the rules and their regexes
as they are: its parameter names map onto the flax paths through
:func:`dlrover_tpu_torch.utils.convert.flax_path`.  What changes is
what a spec becomes: :func:`placements_for`, a pure function of the
path, the shape and the mesh shape, gives a parameter one
``torch.distributed.tensor`` placement per mesh dim of
:data:`~dlrover_tpu_torch.parallel.mesh.TORCH_AXES` (``Shard(d)``
where the spec names that axis on tensor dim ``d``, else
``Replicate()``), after the reference's fitting rules
(:func:`fit_spec`): an axis the mesh lacks is replicated, and so is a
dim the axis sizes do not divide.  FSDP2's ``fully_shard`` applies the
``fsdp`` axis and DTensor the ``tensor`` axis
(:mod:`dlrover_tpu_torch.accel.accelerate`).

``moe_rules`` places the expert kernels on ``("expert", "fsdp",
"tensor")``; :func:`dlrover_tpu_torch.parallel.moe.attach_mesh` makes
them DTensors over the expert and tensor axes (FSDP2 adds fsdp).
``gpt_tp_rules``' vocab-parallel ``wte`` and ``lm_head`` are split by
vocab over the tensor axis (:func:`apply_tensor_parallel`):
:func:`vocab_parallel_embedding` looks each token up on the rank that
holds its row and sums over the tensor group, :func:`vocab_logits`
gives logits sharded on vocab, which the losses of
:mod:`dlrover_tpu_torch.models.losses` reduce without gathering them.
``pipeline_rules`` places the stage-stacked ``blocks`` of a pipelined
model (:class:`~dlrover_tpu_torch.models.gpt.PipelinedDecoder`) on the
``pipeline`` axis, each rank's shard its own stage.
"""

import functools
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

from dlrover_tpu_torch.parallel.mesh import TORCH_AXES

SpecLike = Union[None, str, Tuple]


@dataclass
class PartitionRules:
    """Ordered (path-regex, partition-spec) pairs, first match wins.

    Spec entries name mesh axes per tensor dimension, e.g.
    ``("fsdp", None)`` shards dim 0 over the fsdp axis.  ``None``
    replicates the dimension.
    """

    rules: List[Tuple[str, Tuple[SpecLike, ...]]] = field(
        default_factory=list
    )
    default: Tuple[SpecLike, ...] = ()

    def spec_for(self, path: str) -> Tuple[SpecLike, ...]:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return tuple(spec)
        return tuple(self.default)

    def extended(self, extra: Sequence[Tuple[str, Tuple]], front=True):
        new = list(extra) + self.rules if front else self.rules + list(extra)
        return PartitionRules(rules=new, default=self.default)


_WARNED_MISSING_AXES = set()


def fit_spec(spec: Sequence[SpecLike], shape: Sequence[int],
             mesh_shape: Mapping[str, int]) -> Tuple[SpecLike, ...]:
    """The reference's ``_fit_spec``: the spec cut to the tensor's rank,
    axes the mesh does not have dropped (warned once per axis and mesh
    factorization), and a dim replicated where its axes' sizes do not
    divide it."""
    spec = tuple(spec)[: len(shape)]
    fitted = []
    for dim, entry in enumerate(spec):
        if entry is None:
            fitted.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in mesh_shape]
        for a in missing:
            warn_key = (a, tuple(sorted(mesh_shape.items())))
            if warn_key not in _WARNED_MISSING_AXES:
                _WARNED_MISSING_AXES.add(warn_key)
                from dlrover_tpu_torch.common.log import default_logger

                default_logger.warning(
                    "partition spec names mesh axis %r which mesh %s "
                    "does not have; replicating that dimension",
                    a, dict(mesh_shape),
                )
        axes = tuple(a for a in axes if a in mesh_shape)
        if not axes:
            fitted.append(None)
            continue
        size = 1
        for a in axes:
            size *= mesh_shape[a]
        if shape[dim] % size == 0:
            fitted.append(axes if len(axes) > 1 else axes[0])
        else:
            fitted.append(None)
    return tuple(fitted)


def spec_to_placements(spec: Sequence[SpecLike],
                       mesh_axes: Sequence[str] = TORCH_AXES) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the (fitted) spec
    names the axis on tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_axes:
        dims = [d for d, entry in enumerate(spec) if entry is not None
                and axis in (entry if isinstance(entry, tuple) else (entry,))]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names axis {axis!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def placements_for(path: str, shape: Sequence[int],
                   mesh_shape: Mapping[str, int],
                   rules: PartitionRules) -> tuple:
    """A parameter's placements over :data:`TORCH_AXES` for its flax
    ``path``, its ``shape`` and the mesh's axis sizes."""
    return spec_to_placements(
        fit_spec(rules.spec_for(path), shape, mesh_shape))


def param_placements(model, mesh_shape: Mapping[str, int],
                     rules: PartitionRules) -> Dict[str, tuple]:
    """``{parameter name: placements}`` over the module's parameters,
    matched by their flax paths."""
    from dlrover_tpu_torch.utils.convert import flax_path

    return {
        name: placements_for("/".join(flax_path(name)), tuple(p.shape),
                             mesh_shape, rules)
        for name, p in model.named_parameters()
    }


def shards_over(placements: Mapping[str, tuple], axis: str) -> bool:
    """Whether any parameter is sharded over ``axis``."""
    from torch.distributed.tensor import Shard

    i = TORCH_AXES.index(axis)
    return any(isinstance(pl[i], Shard) for pl in placements.values())


# ---------------------------------------------------------------------------
# Canonical rule sets (copies of the reference's)
# ---------------------------------------------------------------------------


def replicated_rules() -> PartitionRules:
    """Pure DP: everything replicated (torch DDP parity)."""
    return PartitionRules(rules=[], default=())


def pipeline_rules() -> PartitionRules:
    """Stage-stacked block params (``blocks/...`` leaves with leading
    [stage, layer/stage] dims) shard dim 0 over the pipeline axis;
    embed/head replicate."""
    return PartitionRules(
        rules=[(r"(^|/)blocks/", ("pipeline",))], default=()
    )


def fsdp_rules(min_size_divisor: int = 1) -> PartitionRules:
    """ZeRO-3 parity: shard the largest dim of every weight over
    ``fsdp``.  Biases/norms stay replicated."""
    return PartitionRules(
        rules=[
            (r"(scale|bias|ln_\w+|layernorm)", ()),
            (r"embedding$|wte|wpe", ("fsdp",)),
            (r"kernel$|w$", ("fsdp", None)),
        ],
        default=(),
    )


def gpt_tp_rules() -> PartitionRules:
    """Megatron-style TP for transformer blocks: attention qkv + mlp-in
    column-parallel (shard the output dim), attention out + mlp-out
    row-parallel (shard the input dim), embeddings vocab-parallel;
    combined with fsdp on the other dim."""
    return PartitionRules(
        rules=[
            (r"(scale|bias|ln_\w+|layernorm)", ()),
            # vocab-parallel embedding
            (r"(wte|embedding)/embedding$", ("tensor", "fsdp")),
            (r"wpe/embedding$", (None, "fsdp")),
            # column-parallel: qkv projections, mlp up
            (r"(q_proj|k_proj|v_proj|qkv|fc_in|up|gate)/kernel$",
             ("fsdp", "tensor")),
            # row-parallel: attention output, mlp down
            (r"(o_proj|out_proj|fc_out|down)/kernel$",
             ("tensor", "fsdp")),
            (r"lm_head/kernel$", ("fsdp", "tensor")),
            (r"kernel$", ("fsdp", None)),
        ],
        default=(),
    )


def moe_rules() -> PartitionRules:
    """Expert-parallel MoE: expert weights carry a leading expert dim
    sharded over ``expert``; the rest follows the TP rules."""
    base = gpt_tp_rules()
    return base.extended(
        [
            (r"experts_w_(in|out|gate)$",
             ("expert", "fsdp", "tensor")),
            (r"router/kernel$", (None, None)),
        ]
    )


def batch_spec(extra_seq_axis: bool = False) -> Tuple[SpecLike, ...]:
    """Spec of input batches: dim 0 split over data x fsdp; with
    sequence parallelism the sequence dim too."""
    if extra_seq_axis:
        return (("data", "fsdp"), "sequence")
    return (("data", "fsdp"),)


# the axes whose ranks hold distinct tokens of a global batch under
# :func:`batch_shard`, innermost first: the order the global token index
# nests (the sequence, then the rows over data x fsdp, data outer)
TOKEN_AXES = ("sequence", "fsdp", "data")


def token_shard(mesh) -> Tuple[int, int, int, int]:
    """``(row, rows, col, cols)``: this rank's part of a global batch
    under :func:`batch_shard`, the ``row``-th of ``rows`` equal blocks
    of the batch dim and the ``col``-th of ``cols`` of the sequence."""
    shape, coord = mesh.shape, mesh.coordinate()
    return (coord["data"] * shape["fsdp"] + coord["fsdp"],
            shape["data"] * shape["fsdp"],
            coord.get("sequence", 0), shape.get("sequence", 1))


def token_indices(mesh, b_local: int, s_local: int):
    """The global token index (row-major over the global ``[batch,
    seq]``) of each of this rank's ``b_local * s_local`` tokens, in its
    own row-major order (a ``torch`` int64 tensor)."""
    import torch

    row, _, col, cols = token_shard(mesh)
    rows = torch.arange(b_local) + row * b_local
    seq = torch.arange(s_local) + col * s_local
    return (rows[:, None] * (cols * s_local) + seq[None, :]).reshape(-1)


def batch_shard(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """This rank's part of a global batch under :func:`batch_spec`: the
    batch dim split over data x fsdp in that order (data outer) and,
    with sequence parallelism, the sequence dim (dim 1) over
    ``sequence`` (``batch_spec(extra_seq_axis=True)``); the same on
    every tensor- and expert-parallel rank (:func:`token_shard`)."""
    i, n, j, sp = token_shard(mesh)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows not divisible over "
                             f"{n} data x fsdp ranks")
        per = rows // n
        v = v[i * per:(i + 1) * per]
        if sp > 1:
            seq = v.shape[1]
            if seq % sp:
                raise ValueError(f"sequence of {seq} not divisible over "
                                 f"{sp} sequence ranks")
            v = v[:, j * (seq // sp):(j + 1) * (seq // sp)]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Applying placements: DTensor on the tensor axis, FSDP2 on fsdp
# ---------------------------------------------------------------------------


def _dense_style(colwise: bool):
    """A ``ParallelStyle`` for the flax-layout ``Dense`` (weight
    ``[in, out]``, so torch's ``ColwiseParallel``/``RowwiseParallel``
    for ``nn.Linear`` do not apply).  Column: weight ``Shard(1)``, bias
    ``Shard(0)``, a plain input taken as replicated, the output left a
    DTensor sharded on its last dim.  Row: weight ``Shard(0)``, bias
    replicated, a plain input taken as sharded on its last dim (a
    DTensor one as it is), the output all-reduced to a plain tensor."""
    from torch import nn
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_module,
        distribute_tensor,
    )
    from torch.distributed.tensor.parallel import ParallelStyle

    class DenseParallel(ParallelStyle):
        def _apply(self, module, device_mesh):
            def partition(name, mod, mesh):
                if mod is not module:
                    return
                for n, p in list(mod.named_parameters(recurse=False)):
                    if colwise:
                        pl = Shard(1) if n == "weight" else Shard(0)
                    else:
                        pl = Shard(0) if n == "weight" else Replicate()
                    mod.register_parameter(n, nn.Parameter(
                        distribute_tensor(p, mesh, [pl]),
                        requires_grad=p.requires_grad))

            def input_fn(mod, inputs, mesh):
                x = inputs[0]
                if not isinstance(x, DTensor):
                    x = DTensor.from_local(
                        x, mesh, [Replicate() if colwise else
                                  Shard(x.dim() - 1)], run_check=False)
                return (x, *inputs[1:])

            def output_fn(mod, out, mesh):
                if colwise:
                    return out
                return out.redistribute(placements=[Replicate()]).to_local()

            return distribute_module(module, device_mesh, partition,
                                     input_fn, output_fn)

    return DenseParallel()


def apply_tensor_parallel(model, mesh, placements: Mapping[str, tuple]):
    """Shard the model over the tensor axis as the placements say: the
    Dense layers column (``Shard(1)``, ``lm_head`` included: its logits
    come out sharded on vocab) or row (``Shard(0)``) parallel, and an
    embedding table split by vocab (``Shard(0)``, ``wte``; its lookup is
    :func:`vocab_parallel_embedding`, a tied head over it
    :func:`vocab_logits`).  Everything else stays replicated over the
    tensor axis, and every tensor rank computes the same residual
    stream.  The MoE experts take their tensor dim in
    :func:`dlrover_tpu_torch.parallel.moe.attach_mesh`."""
    from torch import nn
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.parallel import parallelize_module

    i = TORCH_AXES.index("tensor")
    tp_plan = {}
    for name, module in model.named_modules():
        pl = placements.get(f"{name}.weight")
        if pl is None or not isinstance(pl[i], Shard):
            continue
        if isinstance(module, nn.Embedding) and pl[i].dim == 0:
            module.weight = nn.Parameter(
                distribute_tensor(module.weight.detach(), mesh["tensor"],
                                  [Shard(0)]),
                requires_grad=module.weight.requires_grad)
        elif hasattr(module, "in_features") and pl[i].dim in (0, 1):
            tp_plan[name] = _dense_style(colwise=pl[i].dim == 1)
    parallelize_module(model, mesh["tensor"], tp_plan)
    return model


def vocab_shard(weight, dim: int):
    """``(local, group, start)`` of a table split by vocab on ``dim`` over
    a one-dim tensor mesh (the tensor-parallel ``wte`` and ``lm_head``,
    as forwards see them), else None: the rank's rows (columns), the
    tensor group and the first vocab id it holds."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    from dlrover_tpu_torch.common.device import is_dtensor

    if not is_dtensor(weight) or weight.device_mesh.ndim != 1:
        return None
    pl = weight.placements[0]
    if not (isinstance(pl, Shard) and pl.dim == dim):
        return None
    _, offset = compute_local_shape_and_global_offset(
        weight.shape, weight.device_mesh, weight.placements)
    return (weight.to_local(), weight.device_mesh.get_group(0),
            int(offset[dim]))


@functools.lru_cache(maxsize=None)
def _sum_grad_over():
    import torch

    class SumGradOver(torch.autograd.Function):
        """Identity forward; the backward sums the gradient over
        ``group`` (each rank's part of a split computation gives only
        its part of the input's gradient)."""

        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            import torch.distributed as dist

            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
            return grad, None

    return SumGradOver


def sum_grad_over(x, group):
    """``x`` as it is, its gradient summed over ``group``."""
    return _sum_grad_over().apply(x, group)


@functools.lru_cache(maxsize=None)
def _sum_over():
    import torch

    class SumOver(torch.autograd.Function):
        """Sum over ``group`` forward; the gradient of a replicated
        output passes to each rank's part as it is."""

        @staticmethod
        def forward(ctx, x, group):
            import torch.distributed as dist

            x = x.clone()
            dist.all_reduce(x, group=group)
            return x

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    return SumOver


def vocab_parallel_embedding(tokens, weight):
    """``F.embedding(tokens, weight)`` for a table split by vocab over
    the tensor axis: each rank looks up the tokens whose rows it holds
    (zeros for the rest) and the rows are summed over the tensor group,
    so every rank gets the whole lookup; each rank's gradient lands on
    its own rows.  A table that is not split is looked up as it is."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.common.device import is_dtensor

    shard = vocab_shard(weight, 0)
    if shard is None:
        return F.embedding(tokens,
                           weight.to_local() if is_dtensor(weight) else weight)
    local, group, start = shard
    ids = tokens - start
    inside = (ids >= 0) & (ids < local.shape[0])
    rows = F.embedding(ids.clamp(0, local.shape[0] - 1), local)
    rows = rows * inside[..., None].to(rows.dtype)
    return _sum_over().apply(rows, group)


def vocab_logits(x, weight, transpose: bool):
    """``x @ weight`` (``weight.t()`` with ``transpose``, a tied
    ``[vocab, hid]`` table) as a DTensor sharded on vocab when the table
    is split by vocab over the tensor axis: ``x`` enters as replicated,
    and its gradient is summed over the tensor group by DTensor.  A
    plain table gives plain logits."""
    from torch.distributed.tensor import DTensor, Replicate

    if vocab_shard(weight, 0 if transpose else 1) is None:
        return x @ (weight.t() if transpose else weight)
    xd = DTensor.from_local(x, weight.device_mesh, [Replicate()],
                            run_check=False)
    return xd @ (weight.t() if transpose else weight)


def apply_fsdp(model, mesh, reshard_after_forward: bool = True):
    """FSDP2 over the fsdp axis (HSDP over data x fsdp when data > 1):
    each transformer block is its own unit, the root holds the rest.
    FSDP2 shards dim 0 of every parameter of a unit (padding a dim the
    axis does not divide) and gathers it before the unit's forward, so
    the kernels see plain tensors.  The root's parameters stay gathered
    from its forward to its backward: a loss that applies the head
    itself (``chunked_loss_fn`` over ``return_hidden``) reads them after
    the forward, and its gradient must land on the gathered parameter,
    which FSDP2 reduces, not on the shard.  FSDP2 gathers a unit in one
    dtype, so a layer whose parameters keep another dtype than the rest
    of its unit (the fp32 norms beside bf16 weights, ``half``) is a unit
    of its own."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    fsdp_mesh = (mesh[("data", "fsdp")] if mesh.shape["data"] > 1
                 else mesh["fsdp"])

    def wrap(unit, reshard):
        wrapped = {id(p) for sub in unit.modules()
                   if sub is not unit and isinstance(sub, FSDPModule)
                   for p in sub.parameters()}
        # the dtype of most of the unit's elements (the norms' few fp32
        # ones go to units of their own)
        sizes: Dict[Any, int] = {}
        for p in unit.parameters():
            if id(p) not in wrapped:
                sizes[p.dtype] = sizes.get(p.dtype, 0) + p.numel()
        main = max(sizes, key=sizes.get) if sizes else None
        for sub in unit.modules():
            own = [p for p in sub.parameters(recurse=False)
                   if id(p) not in wrapped]
            if sub is not unit and own and all(p.dtype != main
                                               for p in own):
                fully_shard(sub, mesh=fsdp_mesh,
                            reshard_after_forward=reshard)
        fully_shard(unit, mesh=fsdp_mesh, reshard_after_forward=reshard)

    for block in getattr(model, "blocks", []):
        wrap(block, reshard_after_forward)
    wrap(model, False)
    return model
