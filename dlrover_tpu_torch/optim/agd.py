"""AGD: auto-switchable optimizer using the stepwise gradient
difference (Yue et al., NeurIPS 2023).

Reference: ``dlrover_tpu/optim/agd.py`` (``agd``, an optax transform;
integration point ``atorch/optimizers/agd.py:18``).  The same update as
a ``torch.optim.Optimizer``, and the same as the int8/int4 state
optimizer :class:`dlrover_tpu_torch.optim.low_bit.QAGD` without its
quantization: the second moment accumulates the squared difference of
successive bias-corrected first moments (``m_hat_t - m_hat_{t-1}``,
``m_hat_1`` itself at step 1), and the preconditioner
``max(sqrt(v), delta * sqrt(bc2))`` switches between adaptive steps
and SGD-like ones.  Bias corrections are fp32 values computed on the
host from the host step count, as the reference computes them on the
device in fp32.
"""

import numpy as np
import torch

from dlrover_tpu_torch.ops.quantization import bias_corrections, device_scalar


class AGD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, delta: float = 1e-5, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, delta=delta,
                                      eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group)
        return loss

    def _update(self, p, group):
        b1, b2 = group["b1"], group["b2"]
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["mu"] = torch.zeros_like(p, dtype=torch.float32)
            st["nu"] = torch.zeros_like(p, dtype=torch.float32)
        st["step"] += 1
        count = st["step"]
        f32 = np.float32
        bc1, bc2 = bias_corrections(b1, b2, count)
        bc1_old = float(max(f32(1) - np.power(f32(b1), f32(count) - f32(1)),
                            f32(1e-30)))
        sqrt_bc2 = np.sqrt(f32(bc2))
        floor = float(f32(group["delta"]) * sqrt_bc2)
        coef = float(sqrt_bc2 / f32(bc1))
        g = p.grad.to(torch.float32)
        m_old = st["mu"]
        m_new = b1 * m_old + (1 - b1) * g
        if count == 1:
            diff = m_new / device_scalar(bc1, g)
        else:
            diff = (m_new / device_scalar(bc1, g)
                    - m_old / device_scalar(bc1_old, g))
        v_new = b2 * st["nu"] + (1 - b2) * diff * diff
        denom = torch.clamp_min(torch.sqrt(v_new), floor) + group["eps"]
        upd = coef * m_new / denom
        if group["weight_decay"]:
            upd = upd + group["weight_decay"] * p.float()
        p.add_((-group["lr"] * upd).to(p.dtype))
        st["mu"], st["nu"] = m_new, v_new


def agd(params, learning_rate: float = 1e-3, b1: float = 0.9,
        b2: float = 0.999, delta: float = 1e-5, eps: float = 1e-8,
        weight_decay: float = 0.0) -> AGD:
    return AGD(params, lr=learning_rate, b1=b1, b2=b2, delta=delta, eps=eps,
               weight_decay=weight_decay)
