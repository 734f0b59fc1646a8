"""μP — maximal update parametrization.

Copy of ``dlrover_tpu/utils/mup.py`` (reference:
``atorch/atorch/mup/{infshape,init,module,optim,shape}.py``).  Compare
a *base* (narrow) tree of parameters with the target tree to derive
per-leaf width multipliers, then

- rescale matrix-like initializations by ``1/sqrt(mult)``,
- step matrix-like params with the Adam learning rate ``lr/mult``: a
  ``torch.optim.AdamW`` whose parameter groups carry the multipliers
  (the reference chains optax's Adam with a per-leaf ``1/mult`` scale
  of its updates, the same step),
- scale output logits by ``1/mult`` via :func:`output_multiplier`.

This preserves optimal hyperparameters across width (muTransfer).  A
tree is a tensor or a nested dict, list or tuple of them, e.g.
``dict(model.named_parameters())``; fan-in is the product of every dim
but the last, as flax's ``[in, out]`` kernels (and the port's
``Dense``) lay weights out.
"""

import math
from typing import Dict, List

import torch

from dlrover_tpu_torch.utils.numeric_checker import tree_leaves


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _fan_in(shape) -> int:
    if len(shape) <= 1:
        return 1
    return math.prod(shape[:-1])


def width_multipliers(base_params, params):
    """Per-leaf width multiplier tree: fan_in / base_fan_in.

    Matrix-like leaves (ndim >= 2) get mult = fan_in ratio; vectors
    and scalars get 1.0 (they are 'infinite-width invariant').
    """

    def per_leaf(base, target):
        if getattr(target, "ndim", 0) < 2:
            return 1.0
        return max(_fan_in(target.shape) / max(_fan_in(base.shape), 1), 1e-9)

    return _map(per_leaf, base_params, params)


def scale_init(params, mults):
    """Rescale matrix inits by 1/sqrt(mult) (μP init rule); a new tree,
    the leaves' dtype kept."""

    def per_leaf(p, m):
        if getattr(p, "ndim", 0) < 2 or m == 1.0:
            return p
        return p / torch.sqrt(torch.tensor(m, dtype=p.dtype, device=p.device))

    return _map(per_leaf, params, mults)


def mup_adam(
    params,
    learning_rate: float,
    mults,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> torch.optim.AdamW:
    """Adam with per-leaf μP learning-rate scaling: matrix-like params
    step with lr/mult (reference: mup/optim.py MuAdam).  ``params`` and
    ``mults`` are trees of one structure; the parameters of one
    multiplier share a group whose ``lr`` is ``learning_rate / mult``
    and whose ``mup_mult`` records it (decoupled weight decay, as
    optax's ``adamw``, scales with the group's lr, as the reference
    scales the whole update)."""
    groups: Dict[float, List[torch.Tensor]] = {}
    mult_of = dict(tree_leaves(mults))
    for path, p in tree_leaves(params):
        groups.setdefault(float(mult_of[path]), []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr": learning_rate / m, "mup_mult": m}
         for m, ps in groups.items()],
        lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay)


def output_multiplier(base_width: int, width: int) -> float:
    """Scale for the readout logits: base_width / width."""
    return base_width / width
