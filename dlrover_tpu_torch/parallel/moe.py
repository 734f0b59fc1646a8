"""Mixture-of-Experts layer with expert parallelism.

Reference: ``dlrover_tpu/parallel/moe.py`` (GShard-style dense
dispatch: the routing is an einsum against a ``[tokens, experts,
capacity]`` one-hot dispatch tensor, and the expert kernels carry a
leading expert dim that the ``expert`` mesh axis shards).  Top-1
(Switch) and top-2 (GShard) gating with capacity dropping and the
load-balancing auxiliary loss, the same arithmetic in the same dtypes.

Where the reference sees the global batch under ``jit``, each rank here
holds its own tokens, so the layer keeps the reference's *global*
semantics by hand (:class:`MoEMLP` over a mesh, attached by
:func:`attach_mesh`):

- the capacity is ``int(k * T * cf / e)`` with ``T`` the global token
  count, and each token's queue position is a cumsum over the global
  token order: the ranks that hold distinct tokens (the ``sequence``,
  ``fsdp`` and ``data`` axes) all-gather their top-k expert ids, every
  rank computes the positions of all tokens and keeps its own;
- the aux loss's first-choice density is the global one; its gate-mean
  factor is the rank's own, so the mean of the ranks' aux losses (the
  data-parallel average every loss and gradient takes) is the
  reference's aux loss and its gradient;
- the expert kernels are DTensors placed as ``moe_rules`` places them
  (:func:`attach_mesh`): ``Shard(0)`` over ``expert`` and, under tensor
  parallelism, their tensor dim over ``tensor`` (FSDP2 adds ``fsdp``),
  so the sharded flash checkpoint saves each rank's box of them and
  restores it at another expert world, as any other DTensor;
- the batch is replicated over the ``expert`` axis (the reference's
  ``batch_spec`` is ``("data", "fsdp")``), so every rank of an expert
  group holds the same tokens and gating: each dispatches only to its
  ``e / ep`` experts (its ``[e / ep, c, d]`` slice), runs them on the
  kernels' local tensors (their tensor dim gathered first: the tokens
  are replicated over ``tensor`` too, so every tensor rank runs its
  experts whole), and the outputs are all-gathered over the group (the
  all-to-all of split tokens reduces to that when the tokens are
  replicated); the backward takes the rank's slice of the gathered
  gradient and all-reduces the tokens' ``[t, d]`` gradient from its
  experts over the group, so every rank ends with the same gradients
  outside the experts.

The dispatch and combine stay einsums, as in the reference (no kernel
computes them).  :func:`collect_moe_aux_loss` sums the aux loss each
layer kept from its last forward (flax's ``sow``).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.common.device import is_dtensor
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import (
    TOKEN_AXES,
    sum_grad_over,
    token_indices,
    token_shard,
)


class TokenGroup:
    """The ranks that hold distinct tokens of one global batch, and this
    rank's place among them (the layout of
    :func:`~dlrover_tpu_torch.parallel.sharding.batch_shard`):
    ``gather`` returns a per-token tensor of every rank in the global
    order, ``local`` the index of this rank's tokens in it."""

    def __init__(self, mesh, b_local: int, s_local: int):
        self.mesh, self.b, self.s = mesh, b_local, s_local
        _, rows, _, self.sp = token_shard(mesh)
        self.size = rows * self.sp
        self.local = token_indices(mesh, b_local, s_local)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[b_local * s_local, ...]`` of every rank, ``[T, ...]``
        in the global token order."""
        import torch.distributed as dist

        x = x.reshape(self.b, self.s, *x.shape[1:])
        for axis in TOKEN_AXES:
            dim = 1 if axis == "sequence" else 0
            group = self.mesh.group(axis)
            if group is None:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x, group=group)
            x = torch.cat(parts, dim=dim)
        return x.reshape(-1, *x.shape[2:])


def top_k_gating(gate_logits: torch.Tensor, k: int, capacity: int,
                 tokens: Optional[TokenGroup] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dispatch [t, e, c], combine [t, e, c], aux_loss)`` for this
    rank's ``t`` tokens' ``gate_logits`` ``[t, e]`` (fp32).  Tokens past
    an expert's capacity are dropped (zero combine weight).  A choice-c
    token's queue position starts after every token the expert took in
    choices ``0..c-1`` (GShard's ``locations2 += sum(mask1)``), so slots
    never collide across choices; with ``k > 1`` the combine weights are
    renormalised over the kept choices.  ``tokens`` makes the positions,
    the capacity's token order and the density global."""
    t, e = gate_logits.shape
    gates = torch.softmax(gate_logits, dim=-1)
    expert_ids = torch.topk(gates, k, dim=-1).indices  # [t, k]
    if tokens is None:
        all_ids, mine = expert_ids, slice(None)
    else:
        all_ids = tokens.gather(expert_ids)
        mine = tokens.local.to(gates.device)
    # load balancing: e * sum(density * mean gate) * e / k, density the
    # first choice's share of the tokens
    density = F.one_hot(all_ids[:, 0], e).to(gates.dtype).mean(dim=0)
    aux = (density * gates.mean(dim=0)).sum() * (e ** 2) / k
    dispatch = torch.zeros(t, e, capacity, dtype=gates.dtype,
                           device=gates.device)
    rows = torch.arange(t, device=gates.device)
    prev = torch.zeros(e, dtype=gates.dtype, device=gates.device)
    slots, weights = [], []
    for choice in range(k):
        onehot = F.one_hot(all_ids[:, choice], e).to(gates.dtype)
        pos_all = (torch.cumsum(onehot, dim=0) - 1.0 + prev) * onehot
        prev = prev + onehot.sum(dim=0)
        ids = expert_ids[:, choice]
        pos = pos_all[mine].gather(1, ids[:, None])[:, 0]
        in_cap = (pos < capacity).to(gates.dtype)
        slot = (rows, ids, torch.clamp(pos, max=capacity - 1).long())
        dispatch = dispatch.index_put(slot, in_cap, accumulate=True)
        slots.append(slot)
        weights.append(in_cap * gates.gather(1, ids[:, None])[:, 0])
    if k > 1:
        denom = torch.clamp(sum(weights), min=1e-9)
        weights = [w / denom for w in weights]
    combine = torch.zeros_like(dispatch)
    for slot, w in zip(slots, weights):
        combine = combine.index_put(slot, w, accumulate=True)
    return dispatch, combine, aux


class _GatherExperts(torch.autograd.Function):
    """The expert group's outputs concatenated on dim 0 (all ranks' the
    same); the backward takes this rank's slice of the gradient, which
    every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, rank):
        import torch.distributed as dist

        ctx.rank, ctx.n = rank, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.n
        return grad[lo:lo + ctx.n], None, None


class MoEMLP(nn.Module):
    """Expert-parallel MLP block (drop-in for the dense MLP).

    Parameters as the reference names them: ``router`` (a Dense to
    ``e`` logits, fp32), ``experts_w_in`` ``[e, d, h]``,
    ``experts_w_out`` ``[e, h, d]`` and with ``gated`` (SwiGLU, Mixtral)
    ``experts_w_gate`` ``[e, d, h]``; without it the experts apply
    GELU.  ``no_drop`` lifts the capacity to the tokens (up to 2048
    for one-token steps, 512 otherwise) as the reference's decode mode
    does.  Under expert parallelism (:meth:`distribute_experts`) the
    expert kernels are DTensors whose local tensors hold this rank's
    ``e / ep`` experts."""

    def __init__(self, num_experts: int, hidden_dim: int, mlp_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gated: bool = False, no_drop: bool = False,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        from dlrover_tpu_torch.models.gpt import Dense

        self.num_experts, self.hidden_dim, self.mlp_dim = (
            num_experts, hidden_dim, mlp_dim)
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.gated, self.no_drop, self.dtype = gated, no_drop, dtype
        e, d, h = num_experts, hidden_dim, mlp_dim
        self.router = Dense(d, e, bias=False, dtype=param_dtype,
                            device=device)

        def expert(shape):
            return nn.Parameter(torch.empty(shape, dtype=param_dtype,
                                            device=device))

        self.experts_w_in = expert((e, d, h))
        if gated:
            self.experts_w_gate = expert((e, d, h))
        self.experts_w_out = expert((e, h, d))
        self.mesh = None
        self.expert_group, self.expert_rank = None, 0
        self.aux_loss: Optional[torch.Tensor] = None

    def expert_kernels(self):
        names = ("experts_w_in", "experts_w_gate", "experts_w_out")
        return [n for n in names if hasattr(self, n)]

    def distribute_experts(self, mesh, placements=None):
        """Make the expert kernels DTensors over the mesh's ``expert``
        and ``tensor`` axes (those larger than 1): ``Shard(0)`` over
        ``expert`` (the leading expert dim, as ``moe_rules`` places it)
        and over ``tensor`` the placement ``placements`` (``{kernel
        name: placements over TORCH_AXES}``) gives, else replicated."""
        from torch.distributed.tensor import (
            Replicate,
            Shard,
            distribute_tensor,
        )

        from dlrover_tpu_torch.parallel.mesh import TORCH_AXES

        ep = mesh.shape["expert"]
        if self.num_experts % ep:
            raise ValueError(f"{self.num_experts} experts do not shard "
                             f"over an expert axis of {ep}")
        axes = tuple(a for a in ("expert", "tensor") if mesh.shape[a] > 1)
        if not axes:
            return
        sub = mesh[axes]
        for name in self.expert_kernels():
            w = getattr(self, name)
            pl = (placements or {}).get(name)
            tensor = pl[TORCH_AXES.index("tensor")] if pl else Replicate()
            spec = [Shard(0) if a == "expert" else
                    (tensor if isinstance(tensor, Shard) else Replicate())
                    for a in axes]
            setattr(self, name, nn.Parameter(
                distribute_tensor(w.detach(), sub, spec),
                requires_grad=w.requires_grad))
        if ep > 1:
            self.expert_group = mesh.group("expert")
            self.expert_rank = mesh.coordinate()["expert"]

    def _kernel(self, name: str) -> torch.Tensor:
        """An expert kernel as the dispatch reads it: this rank's experts
        whole (its tensor dim gathered when the tensor axis splits it)."""
        from torch.distributed.tensor import Replicate, Shard

        w = getattr(self, name)
        if not is_dtensor(w):
            return w
        want = [pl if (isinstance(pl, Shard) and pl.dim == 0)
                else Replicate() for pl in w.placements]
        if list(w.placements) != want:
            w = w.redistribute(placements=want)
        return w.to_local()

    def _capacity(self, t: int, s: int) -> int:
        capacity = max(1, int(self.top_k * t * self.capacity_factor
                              / self.num_experts))
        if self.no_drop:
            bound = 2048 if s == 1 else 512
            if t > bound:
                logger.warning(
                    "no_drop MoE: %d tokens exceeds the bounded no-drop "
                    "guarantee (%d); trained capacity factor applies and "
                    "overflow tokens may drop", t, bound)
            capacity = max(capacity, min(t, bound))
        return capacity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dtype = self.dtype
        tokens_in = x.reshape(b * s, d)
        group = None
        if self.mesh is not None:
            group = TokenGroup(self.mesh, b, s)
            if group.size == 1:
                group = None
        t_all = b * s * (group.size if group else 1)
        s_all = s * (group.sp if group else 1)
        capacity = self._capacity(t_all, s_all)
        # router in fp32 for a stable softmax and top-k
        gate_logits = self.router(tokens_in.float(), torch.float32)
        dispatch, combine, aux = top_k_gating(gate_logits, self.top_k,
                                              capacity, group)
        self.aux_loss = aux
        tokens = tokens_in.to(dtype)
        w_in = self._kernel("experts_w_in")
        if self.expert_group is not None:
            # this rank's experts' slots only; the tokens' gradient from
            # each rank's experts is summed over the group
            per = w_in.shape[0]
            lo = self.expert_rank * per
            dispatch = dispatch[:, lo:lo + per]
            tokens = sum_grad_over(tokens, self.expert_group)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype), tokens)
        h = torch.einsum("ecd,edh->ech", expert_in, w_in.to(dtype))
        if self.gated:
            gate_h = torch.einsum("ecd,edh->ech", expert_in,
                                  self._kernel("experts_w_gate").to(dtype))
            h = F.silu(gate_h) * h
        else:
            # flax nn.gelu defaults to the tanh approximation
            h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", h,
                                  self._kernel("experts_w_out").to(dtype))
        if self.expert_group is not None:
            expert_out = _GatherExperts.apply(expert_out, self.expert_group,
                                              self.expert_rank)
        out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
        return out.reshape(b, s, d)


def attach_mesh(model: nn.Module, mesh, placements=None) -> nn.Module:
    """Point every :class:`MoEMLP` of ``model`` at ``mesh``: gating over
    the global tokens of its token axes, and the expert kernels made
    DTensors over its ``expert`` and ``tensor`` axes
    (:meth:`MoEMLP.distribute_experts`; ``placements`` maps parameter
    names to their placements over ``TORCH_AXES``)."""
    for prefix, module in model.named_modules():
        if isinstance(module, MoEMLP):
            module.mesh = mesh
            mine = {n: (placements or {}).get(
                f"{prefix}.{n}" if prefix else n)
                for n in module.expert_kernels()}
            module.distribute_experts(mesh, mine)
    return model


def collect_moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the aux losses every :class:`MoEMLP` of ``model`` kept
    from its last forward (the reference sums what the layers sowed)."""
    total = None
    for module in model.modules():
        if isinstance(module, MoEMLP) and module.aux_loss is not None:
            aux = module.aux_loss.float()
            total = aux if total is None else total + aux
    if total is None:
        p = next(model.parameters())
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return total
