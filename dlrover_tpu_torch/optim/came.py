"""CAME and quantized Adafactor: the factored low-bit family, as torch
optimizers.

Reference: ``dlrover_tpu/optim/came.py`` (``came``, ``q_came``,
``q_adafactor``).  The second moment is rank-1 factored for leaves of
two or more dims (row and column means of ``grad^2``, Adafactor style)
and kept whole for vectors and scalars; CAME adds a factored EMA of
the squared residual ``(u - m)^2`` that rescales the momentum.  The
quantized variants store the O(n) first moment as blockwise int8
through the quantize and dequantize kernels of
:mod:`dlrover_tpu_torch.ops.quantization` (the reference's ``_Q8``
codec); the rest is elementwise torch ops in the reference's order.

State per parameter: ``step`` (a host int), the first moment
(``mu_values``/``mu_scales``, or ``mu`` in fp32 for ``came``), and the
factored statistics ``nu_row``/``nu_col``/``nu_full`` (and ``res_*``
for CAME), shaped as the reference's ``FactoredMoment``.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops.quantization import (
    DEFAULT_BLOCK,
    dequantize_blockwise,
    device_scalar,
    quantize_blockwise,
)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def _factored(shape) -> bool:
    return len(shape) >= 2


def _approx_sq(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Rank-1 reconstruction of the factored second moment's rsqrt:
    ``rsqrt(row / mean(row)) x rsqrt(col)`` (Adafactor eq. 4)."""
    r = torch.rsqrt(row / torch.mean(row, dim=-1, keepdim=True))[..., :, None]
    c = torch.rsqrt(col)[..., None, :]
    return r * c


def _init_factored(p: torch.Tensor, prefix: str):
    zeros = dict(dtype=torch.float32, device=p.device)
    if _factored(p.shape):
        return {f"{prefix}_row": torch.zeros(p.shape[:-1], **zeros),
                f"{prefix}_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **zeros),
                f"{prefix}_full": torch.zeros((), **zeros)}
    return {f"{prefix}_row": torch.zeros((), **zeros),
            f"{prefix}_col": torch.zeros((), **zeros),
            f"{prefix}_full": torch.zeros(p.shape, **zeros)}


def _factored_precondition(g, st, b2, eps1, clip_threshold):
    """Shared Adafactor/CAME core: row/col EMA of ``grad^2 + eps1``,
    rank-1 rsqrt preconditioning, RMS clip; updates ``nu_*`` in
    ``st`` and returns the clipped direction."""
    one_minus_b2 = 1 - b2
    sq = torch.square(g) + eps1
    if _factored(g.shape):
        row = b2 * st["nu_row"] + one_minus_b2 * torch.mean(sq, dim=-1)
        col = b2 * st["nu_col"] + one_minus_b2 * torch.mean(sq, dim=-2)
        u = _approx_sq(row, col) * g
        st["nu_row"], st["nu_col"] = row, col
    else:
        full = b2 * st["nu_full"] + one_minus_b2 * sq
        u = torch.rsqrt(full) * g
        st["nu_full"] = full
    return u / torch.clamp_min(_rms(u) / clip_threshold, 1.0)


class _FactoredOptimizer(torch.optim.Optimizer):
    """Eager state; the first moment blockwise int8 (``block_size``)
    or fp32 (``block_size=None``)."""

    def __init__(self, params, defaults, block_size: Optional[int],
                 keep_mu: bool = True):
        self.block_size, self.keep_mu = block_size, keep_mu
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self._param_state(p)

    def _init_state(self, p):
        return {"step": 0, **_init_factored(p, "nu")}

    def _param_state(self, p):
        st = self.state[p]
        if not st:
            st.update(self._init_state(p))
            if self.keep_mu:
                self._put_mu(st, torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
            else:
                st["mu"] = torch.zeros((), dtype=torch.float32,
                                       device=p.device)
        return st

    def _put_mu(self, st, m):
        if self.block_size is None:
            st["mu"] = m
        else:
            st["mu_values"], st["mu_scales"], _ = quantize_blockwise(
                m, self.block_size)

    def _get_mu(self, st, shape):
        if self.block_size is None:
            return st["mu"]
        return dequantize_blockwise(st["mu_values"], st["mu_scales"], shape)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise RuntimeError("factored optimizers take no sparse "
                                       "gradients")
                st = self._param_state(p)
                st["step"] += 1
                upd = self._update(p, p.grad.float(), st, group)
                p.add_(upd.to(p.dtype))
        return loss


class CAME(_FactoredOptimizer):
    """CAME with an fp32 (``block_size=None``) or blockwise-int8 first
    moment; the reference's ``came`` / ``q_came``."""

    def __init__(self, params, lr: float = 2e-4,
                 betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
                 eps: Tuple[float, float] = (1e-30, 1e-16),
                 clip_threshold: float = 1.0, weight_decay: float = 0.0,
                 block_size: Optional[int] = None):
        super().__init__(
            params, dict(lr=lr, betas=tuple(betas), eps=tuple(eps),
                         clip_threshold=clip_threshold,
                         weight_decay=weight_decay),
            block_size,
        )

    def _init_state(self, p):
        return {**super()._init_state(p), **_init_factored(p, "res")}

    def _update(self, p, g, st, group):
        b1, b2, b3 = group["betas"]
        eps1, eps2 = group["eps"]
        u = _factored_precondition(g, st, b2, eps1, group["clip_threshold"])
        m = b1 * self._get_mu(st, g.shape) + (1 - b1) * u
        if _factored(g.shape):
            r = torch.square(u - m) + eps2
            rrow = b3 * st["res_row"] + (1 - b3) * torch.mean(r, dim=-1)
            rcol = b3 * st["res_col"] + (1 - b3) * torch.mean(r, dim=-2)
            final = _approx_sq(rrow, rcol) * m
            st["res_row"], st["res_col"] = rrow, rcol
        else:
            final = m
        self._put_mu(st, m)
        return -group["lr"] * (final + group["weight_decay"] * p.float())


class QAdafactor(_FactoredOptimizer):
    """Adafactor with the first moment stored blockwise-int8; the
    reference's ``q_adafactor``.  ``lr=None`` takes the relative step
    ``min(1/sqrt(t), 1e-2)`` (``1e-6 t`` with ``warmup_init``);
    ``scale_parameter`` multiplies it by ``max(eps[1], rms(p))``;
    ``beta1=None`` keeps no first moment."""

    def __init__(self, params, lr: Optional[float] = None,
                 beta1: Optional[float] = 0.9, decay_rate: float = 0.8,
                 eps: Tuple[float, float] = (1e-30, 1e-3),
                 clip_threshold: float = 1.0, weight_decay: float = 0.0,
                 scale_parameter: bool = True, warmup_init: bool = False,
                 block_size: int = DEFAULT_BLOCK):
        super().__init__(
            params, dict(lr=lr, beta1=beta1, decay_rate=decay_rate,
                         eps=tuple(eps), clip_threshold=clip_threshold,
                         weight_decay=weight_decay,
                         scale_parameter=scale_parameter,
                         warmup_init=warmup_init),
            block_size, keep_mu=beta1 is not None,
        )

    def _step_size(self, group, t, p):
        if group["lr"] is not None:
            lr = torch.full((), group["lr"], dtype=torch.float32,
                            device=p.device)
        else:
            min_step = (np.float32(1e-6) * t if group["warmup_init"]
                        else np.float32(1e-2))
            lr = device_scalar(float(min(min_step, 1 / np.sqrt(t))), p)
        if group["scale_parameter"]:
            lr = lr * torch.clamp_min(_rms(p.float()), group["eps"][1])
        return lr

    def _update(self, p, g, st, group):
        t = np.float32(st["step"])
        # b2 = 1 - t^-decay_rate, in fp32 as the reference computes it
        b2 = float(np.float32(1) - np.power(t, np.float32(-group["decay_rate"])))
        u = _factored_precondition(g, st, b2, group["eps"][0],
                                   group["clip_threshold"])
        lr = self._step_size(group, t, p)
        if self.keep_mu:
            beta1 = group["beta1"]
            final = beta1 * self._get_mu(st, g.shape) + (1 - beta1) * u
            self._put_mu(st, final)
        else:
            final = u
        return -lr * (final + group["weight_decay"] * p.float())


def came(params, lr: float = 2e-4, betas=(0.9, 0.999, 0.9999),
         eps=(1e-30, 1e-16), clip_threshold: float = 1.0,
         weight_decay: float = 0.0) -> CAME:
    """CAME with fp32 states."""
    return CAME(params, lr=lr, betas=betas, eps=eps,
                clip_threshold=clip_threshold, weight_decay=weight_decay)


def q_came(params, lr: float = 2e-4, betas=(0.9, 0.999, 0.9999),
           eps=(1e-30, 1e-16), clip_threshold: float = 1.0,
           weight_decay: float = 0.0, block_size: int = DEFAULT_BLOCK) -> CAME:
    """CAME with the O(n) first moment stored blockwise-int8."""
    return CAME(params, lr=lr, betas=betas, eps=eps,
                clip_threshold=clip_threshold, weight_decay=weight_decay,
                block_size=block_size)


def q_adafactor(params, lr: Optional[float] = None,
                beta1: Optional[float] = 0.9, decay_rate: float = 0.8,
                eps=(1e-30, 1e-3), clip_threshold: float = 1.0,
                weight_decay: float = 0.0, scale_parameter: bool = True,
                warmup_init: bool = False,
                block_size: int = DEFAULT_BLOCK) -> QAdafactor:
    return QAdafactor(params, lr=lr, beta1=beta1, decay_rate=decay_rate,
                      eps=eps, clip_threshold=clip_threshold,
                      weight_decay=weight_decay,
                      scale_parameter=scale_parameter,
                      warmup_init=warmup_init, block_size=block_size)
