"""Local SGD / DiLoCo: infrequent cross-replica synchronization.

Reference: ``dlrover_tpu/optim/local_sgd.py`` (``init_diloco``,
``replicate_for_local_training``, ``reduce_deltas``,
``diloco_outer_step``; the role of ATorch's ``local_sgd/`` and its
reduce methods ``linear``, ``gta`` and ``sparsify``).  Each
data-parallel replica trains on its own with no per-step gradient
collective, and every H steps the outer step reduces the parameter
*delta* (anchor minus local) across replicas and applies an outer
Nesterov-momentum update to the anchor, which every replica then takes.

Two forms, one arithmetic:

- **stacked** (the reference's): a replica is a row of a leading
  replica dim, ``[R, ...]`` per leaf, and every cross-replica
  reduction is a sum over dim 0 (:func:`reduce_deltas`,
  :func:`diloco_outer_step`);
- **process group** (:func:`diloco_outer_step_dist`): each rank of a
  group (the data axis) is one replica holding its own unstacked
  params; the reductions are all-reduces over the group, one chain per
  leaf every H steps: the mean for ``linear``/``sparsify``, and for
  ``gta`` the consensus sign (a sum of the deltas or of their signs)
  and the contributor count.

A params tree is any nest of dicts, lists and tuples of tensors
(``torch.utils._pytree``).  Sparsification ``magnitude`` keeps each
replica's top ``density`` fraction by magnitude against the linear
interpolated quantile, as ``jnp.quantile`` computes it; ``random`` and
``rescaled_random`` draw a Bernoulli mask from an explicit
``torch.Generator``, one ``[R, ...]`` draw a leaf in leaf order (the
process-group form draws the same and keeps its rank's row, so both
forms agree exactly).
"""

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

REDUCE_METHODS = ("linear", "gta", "sparsify")


class DilocoState(NamedTuple):
    # the globally agreed params at the last outer sync
    anchor_params: Any
    # outer momentum buffer (same structure as params)
    momentum: Any


def init_diloco(params) -> DilocoState:
    return DilocoState(
        anchor_params=pytree.tree_map(lambda p: p.detach().clone(), params),
        momentum=pytree.tree_map(torch.zeros_like, params),
    )


def replicate_for_local_training(params, num_replicas: int):
    """Stack params with a leading replica dim, each replica its own
    copy (the stacked form's ``[R, ...]`` leaves, on the params'
    device; the reference also shards that dim over ``data``, which
    the process-group form is here)."""
    return pytree.tree_map(
        lambda p: p.detach().unsqueeze(0).repeat(
            num_replicas, *([1] * p.dim())), params)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=1)`` (linear interpolation) of each
    row of ``x`` ``[R, n]``, through ``kthvalue`` (``torch.quantile``
    refuses more than 2**24 elements)."""
    n = x.shape[1]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    v_lo = torch.kthvalue(x, lo + 1, dim=1).values
    if hi == lo:
        return v_lo
    v_hi = torch.kthvalue(x, hi + 1, dim=1).values
    return v_lo + (v_hi - v_lo) * (pos - lo)


def _check_method(method: str, generator):
    if method in ("random", "rescaled_random"):
        if generator is None:
            raise ValueError("random sparsification needs a torch.Generator")
    elif method != "magnitude":
        raise ValueError(f"unknown sparsification method {method!r}")


def _random_mask(shape, density: float, generator, device):
    return torch.rand(shape, generator=generator, device=device) < density


def _sparsify_deltas(deltas: torch.Tensor, density: float, method: str,
                     generator) -> torch.Tensor:
    """Per-replica sparsification of stacked deltas ``[R, ...]``:
    ``magnitude`` keeps each replica's values at or above its
    ``1 - density`` quantile of ``|delta|``; ``random`` keeps a
    Bernoulli(``density``) mask, ``rescaled_random`` divides the kept
    values by ``density``."""
    if density >= 1.0:
        return deltas
    _check_method(method, generator)
    zero = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    if method == "magnitude":
        mag = deltas.abs()
        thresh = _quantile(mag.reshape(deltas.shape[0], -1), 1.0 - density)
        thresh = thresh.reshape((-1,) + (1,) * (deltas.dim() - 1))
        return torch.where(mag >= thresh, deltas, zero)
    mask = _random_mask(deltas.shape, density, generator, deltas.device)
    out = torch.where(mask, deltas, zero)
    return out / density if method == "rescaled_random" else out


def _replica_weights(weights, d: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=d.dtype, device=d.device).reshape(
        (-1,) + (1,) * (d.dim() - 1))


def _check_reduce(reduce_method: str, density: float, consensus: str):
    if reduce_method not in REDUCE_METHODS:
        raise ValueError(f"unknown reduce_method {reduce_method!r}")
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    if reduce_method == "gta" and consensus not in ("sum", "count"):
        raise ValueError(f"unknown consensus {consensus!r}")


def _majority(total: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=total.dtype, device=total.device)
    return torch.where(total >= 0, one, -one)


def reduce_deltas(
    deltas: torch.Tensor,         # stacked [R, ...] per-replica deltas
    reduce_method: str = "linear",
    consensus: str = "sum",       # gta: "sum" | "count"
    sparsification: Optional[str] = None,
    density: float = 1.0,
    weights: Optional[Sequence[float]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reduce per-replica deltas to one consensus delta (the reference's
    ``reduce_deltas``): every reduction is a sum over dim 0."""
    _check_reduce(reduce_method, density, consensus)

    def weighted_mean(d):
        if weights is None:
            return d.mean(dim=0)
        w = _replica_weights(weights, d)
        return (d * w).sum(dim=0) / w.sum()

    if reduce_method == "linear":
        return weighted_mean(deltas)
    if reduce_method == "sparsify":
        return weighted_mean(_sparsify_deltas(
            deltas, density, sparsification or "magnitude", generator))
    d = deltas
    if sparsification is not None:
        d = _sparsify_deltas(d, density, sparsification, generator)
    w = (_replica_weights(weights, d) if weights is not None else
         torch.ones((d.shape[0],) + (1,) * (d.dim() - 1), dtype=d.dtype,
                    device=d.device))
    d = d * w
    signs = torch.sign(d)
    majority = _majority((d if consensus == "sum" else signs).sum(dim=0))
    mask = (signs == majority).to(d.dtype)
    d = d * mask
    divisor = (mask * w).sum(dim=0)
    divisor = torch.where(divisor.abs() < 1e-8,
                          torch.ones_like(divisor), divisor)
    return d.sum(dim=0) / divisor


def _outer_update(delta, anchor, mom, outer_lr, outer_momentum, nesterov):
    new_mom = outer_momentum * mom + delta
    step = outer_momentum * new_mom + delta if nesterov else new_mom
    return anchor - outer_lr * step, new_mom


def _map_leaves(fn, local_params, state: DilocoState):
    flat_local, spec = pytree.tree_flatten(local_params)
    flat_anchor = pytree.tree_leaves(state.anchor_params)
    flat_mom = pytree.tree_leaves(state.momentum)
    if not len(flat_local) == len(flat_anchor) == len(flat_mom):
        raise ValueError("local params, anchor and momentum differ in "
                         "structure")
    out = [fn(i, l, a, m) for i, (l, a, m) in enumerate(
        zip(flat_local, flat_anchor, flat_mom))]
    return tuple(pytree.tree_unflatten([o[j] for o in out], spec)
                 for j in range(3))


@torch.no_grad()
def diloco_outer_step(
    local_params,                 # stacked [R, ...] per-replica params
    state: DilocoState,
    outer_lr: float = 0.7,
    outer_momentum: float = 0.9,
    nesterov: bool = True,
    reduce_method: str = "linear",
    consensus: str = "sum",
    sparsification: Optional[str] = None,
    density: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Any, DilocoState]:
    """One outer DiLoCo update of the stacked form: each replica's delta
    ``anchor - local_r`` reduced by ``reduce_method``, the momentum
    update on it, and the new anchor broadcast back to every replica.
    Returns ``(new stacked params, new state)``."""

    def per_leaf(_, local, anchor, mom):
        delta = reduce_deltas(
            anchor[None] - local, reduce_method=reduce_method,
            consensus=consensus, sparsification=sparsification,
            density=density, generator=generator)
        new_anchor, new_mom = _outer_update(delta, anchor, mom, outer_lr,
                                            outer_momentum, nesterov)
        return new_anchor.expand_as(local).clone(), new_anchor, new_mom

    new_local, new_anchor, new_mom = _map_leaves(per_leaf, local_params,
                                                 state)
    return new_local, DilocoState(anchor_params=new_anchor,
                                  momentum=new_mom)


@torch.no_grad()
def diloco_outer_step_dist(
    local_params,                 # this rank's replica, unstacked
    state: DilocoState,
    group=None,
    outer_lr: float = 0.7,
    outer_momentum: float = 0.9,
    nesterov: bool = True,
    reduce_method: str = "linear",
    consensus: str = "sum",
    sparsification: Optional[str] = None,
    density: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Any, DilocoState]:
    """The outer step with one replica a rank of ``group`` (the default
    group when None): the same arithmetic as :func:`diloco_outer_step`
    with each sum over replicas an all-reduce over the group.  The
    returned params are the new anchor, the same on every rank."""
    import torch.distributed as dist

    _check_reduce(reduce_method, density, consensus)
    method = {"linear": None, "sparsify": sparsification or "magnitude",
              "gta": sparsification}[reduce_method]
    if method is not None and density < 1.0:
        _check_method(method, generator)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def allreduce(x):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    def sparsify(d):
        if method is None or density >= 1.0:
            return d
        if method == "magnitude":
            return _sparsify_deltas(d[None], density, method, None)[0]
        mask = _random_mask((world, *d.shape), density, generator,
                            d.device)[rank]
        out = torch.where(mask, d, torch.zeros((), dtype=d.dtype,
                                               device=d.device))
        return out / density if method == "rescaled_random" else out

    def per_leaf(_, local, anchor, mom):
        d = sparsify(anchor - local)
        if reduce_method != "gta":
            delta = allreduce(d) / world
        else:
            signs = torch.sign(d)
            majority = _majority(allreduce(d.clone() if consensus == "sum"
                                           else signs.clone()))
            mask = (signs == majority).to(d.dtype)
            divisor = allreduce(mask.clone())
            divisor = torch.where(divisor.abs() < 1e-8,
                                  torch.ones_like(divisor), divisor)
            delta = allreduce(d * mask) / divisor
        new_anchor, new_mom = _outer_update(delta, anchor, mom, outer_lr,
                                            outer_momentum, nesterov)
        return new_anchor.clone(), new_anchor, new_mom

    new_local, new_anchor, new_mom = _map_leaves(per_leaf, local_params,
                                                 state)
    return new_local, DilocoState(anchor_params=new_anchor,
                                  momentum=new_mom)
