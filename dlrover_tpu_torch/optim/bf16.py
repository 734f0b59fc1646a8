"""bf16 params with fp32 master weights in the optimizer.

Reference: ``dlrover_tpu/optim/bf16.py`` (``with_fp32_master``,
``adamw_bf16``; behaviour of ``atorch/optimizers/bf16_optimizer.py``):
the model holds bf16 params for matmul speed and half the param
memory, and the optimizer keeps an fp32 master copy so repeated tiny
updates are not lost to bf16's 8 mantissa bits.

Here :class:`Fp32Master` is a ``torch.optim.Optimizer`` around any inner
optimizer built over the fp32 masters: each step it hands the inner
optimizer the gradients in fp32, steps the masters and writes each
param as its master rounded to the param's dtype, so ``param ==
master.to(param.dtype)`` after every step, as the reference emits
exactly the delta that lands the params on the rounded master.

:func:`adamw_bf16` is AdamW with a bfloat16 first moment, optax's
``adamw(mu_dtype=bfloat16)`` (:class:`OptaxAdamW`): the moment is
updated in fp32 from the gradient and its bf16 state, the
bias-corrected update is taken from that fp32 value, and only then is
the moment stored as bf16.
"""

from typing import Any, Callable, Dict, Iterable, List

import torch

from dlrover_tpu_torch.ops.quantization import bias_corrections, device_scalar


class Fp32Master(torch.optim.Optimizer):
    """Run ``inner_factory(masters)`` against fp32 master weights of
    ``params``; the params take the rounded masters after each step."""

    def __init__(self, params: Iterable[torch.Tensor],
                 inner_factory: Callable[[List[torch.Tensor]], Any]):
        params = list(params)
        super().__init__(params, {})
        # copies even for fp32 leaves (norm scales): a master must never
        # alias its param
        self.masters = [
            torch.nn.Parameter(p.detach().to(torch.float32, copy=True))
            for p in params
        ]
        self.inner = inner_factory(self.masters)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]]
        for p, m in zip(params, self.masters):
            m.grad = None if p.grad is None else p.grad.to(torch.float32)
        self.inner.step()
        for p, m in zip(params, self.masters):
            if p.grad is not None:
                p.copy_(m)
        return loss

    def state_dict(self) -> Dict[str, Any]:
        return {"master": [m.detach() for m in self.masters],
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state_dict: Dict[str, Any]):
        with torch.no_grad():
            for m, saved in zip(self.masters, state_dict["master"]):
                m.copy_(saved)
        self.inner.load_state_dict(state_dict["inner"])


def with_fp32_master(params: Iterable[torch.Tensor],
                     inner_factory: Callable[[List[torch.Tensor]], Any]
                     ) -> Fp32Master:
    """Wrap the optimizer that ``inner_factory`` builds so it runs
    against fp32 master weights of ``params``."""
    return Fp32Master(params, inner_factory)


class OptaxAdamW(torch.optim.Optimizer):
    """AdamW in optax's order of operations (``optax.adamw``): the
    update ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)`` in fp32,
    added to the param in its dtype.  With ``mu_dtype=torch.bfloat16``
    the first moment is stored as bf16 (``mu_dtype=jnp.bfloat16``); as
    the reference's jitted step computes it, ``b1`` is then rounded to
    bf16 and ``b1 * mu`` is kept in fp32 for the sum.
    ``torch.optim.AdamW`` takes the same update in another order (its
    weight decay first, as a product), a few ulps away."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                bc1, bc2 = bias_corrections(b1, b2, st["step"])
                g = p.grad.to(torch.float32)
                # b1 rounded to mu's dtype (XLA takes a Python scalar in
                # the array's dtype), the product kept in fp32 (XLA's
                # excess precision under jit)
                b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
                mu = (1 - b1) * g + b1_mu * st["mu"].to(torch.float32)
                nu = (1 - b2) * g * g + b2 * st["nu"]
                upd = (mu / device_scalar(bc1, g)) / (
                    torch.sqrt(nu / device_scalar(bc2, g)) + group["eps"])
                upd = -group["lr"] * (upd + group["weight_decay"] * p.float())
                p.add_(upd.to(p.dtype))
                st["mu"], st["nu"] = mu.to(self.mu_dtype), nu
        return loss


def adamw_bf16(params, learning_rate: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> OptaxAdamW:
    """AdamW with a bfloat16 first moment: the throughput point of the
    optimizer-memory family (half the first moment's bytes, no
    quantization pass)."""
    return OptaxAdamW(params, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mu_dtype=torch.bfloat16)
