"""WSAM: sharpness-aware minimization with a weighted sharpness term
(Yue et al., KDD 2023).

Reference: ``dlrover_tpu/optim/wsam.py`` (``sam_gradient``, ``wsam``;
integration point ``atorch/optimizers/wsam.py:11``).  SAM-family
optimizers take two gradients a step, at ``w`` and at the perturbed
``w + e(w)`` with ``e(w) = rho * g / ||g||``, and combine them as
``(1 - gamma) * g + gamma * g_adv``.  The reference computes both in
the loss-gradient function; here:

- :func:`sam_gradient` does the same over a module's parameters and
  returns the loss and the combined gradients;
- :class:`WSAM` is a ``torch.optim.Optimizer`` that takes the second
  forward/backward through ``step(closure)`` (the closure zeroes
  nothing; it computes the loss and calls ``backward``), leaves each
  parameter's ``.grad`` the combined gradient and steps the base
  optimizer with it (SGD at ``learning_rate`` when none is given, as
  the reference's ``wsam(base=None)``).
"""

from typing import Callable, List, Optional, Tuple

import torch


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


@torch.no_grad()
def _combine(params, grads, adv_grads, gamma: float):
    return [(1.0 - gamma) * g + gamma * ga for g, ga in zip(grads, adv_grads)]


def sam_gradient(loss_fn: Callable, module: torch.nn.Module, batch,
                 rho: float = 0.05, gamma: float = 0.9
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Two-pass WSAM gradient of ``loss_fn(module, batch)`` over the
    module's parameters (in ``module.parameters()`` order).

    gamma=0 gives the plain gradient, gamma=1 the pure SAM gradient.
    The parameters are left as they were."""
    params = [p for p in module.parameters() if p.requires_grad]
    loss = loss_fn(module, batch)
    grads = list(torch.autograd.grad(loss, params))
    with torch.no_grad():
        scale = rho / (_global_norm(grads) + 1e-12)
        saved = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.add_(scale * g)
    try:
        adv = torch.autograd.grad(loss_fn(module, batch), params)
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    return loss.detach(), _combine(params, grads, adv, gamma)


class WSAM(torch.optim.Optimizer):
    """Weighted SAM around ``base`` (an optimizer over the same
    parameters); ``step(closure)`` needs the closure."""

    def __init__(self, params, base: Optional[torch.optim.Optimizer] = None,
                 learning_rate: float = 1e-3, rho: float = 0.05,
                 gamma: float = 0.9):
        params = list(params)
        super().__init__(params, dict(rho=rho, gamma=gamma))
        self.base = base if base is not None else torch.optim.SGD(
            params, lr=learning_rate)

    def step(self, closure=None):
        if closure is None:
            raise ValueError("WSAM takes its second gradient through "
                             "step(closure)")
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        group = self.param_groups[0]
        with torch.no_grad():
            grads = [p.grad.clone() for p in params]
            scale = group["rho"] / (_global_norm(grads) + 1e-12)
            saved = [p.detach().clone() for p in params]
            for p, g in zip(params, grads):
                p.add_(scale * g)
                p.grad = None
        try:
            with torch.enable_grad():
                loss = closure()
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        with torch.no_grad():
            adv = [p.grad for p in params]
            for p, c in zip(params, _combine(params, grads, adv,
                                             group["gamma"])):
                p.grad = c
        self.base.step()
        return loss

    def zero_grad(self, set_to_none: bool = True):
        self.base.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return {"wsam": super().state_dict(), "base": self.base.state_dict()}

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict["wsam"])
        self.base.load_state_dict(state_dict["base"])


def wsam(params, base: Optional[torch.optim.Optimizer] = None,
         learning_rate: float = 1e-3, rho: float = 0.05,
         gamma: float = 0.9) -> WSAM:
    """``WSAM(params, base)``; reads as the reference's
    ``wsam(optax.sgd(lr))`` / ``WeightedSAM(base_optimizer=...)``."""
    return WSAM(params, base, learning_rate=learning_rate, rho=rho,
                gamma=gamma)
