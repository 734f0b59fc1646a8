"""FP8 (e4m3) matmuls with dynamic per-tensor scaling.

Reference: ``dlrover_tpu/ops/fp8.py`` (jnp that XLA lowers, not a Pallas
kernel): each operand is scaled to the e4m3 range by its absolute
maximum over 448, cast to ``float8_e4m3fn``, and the two are contracted
with an fp32 accumulator, the product times both scales.

- :func:`quantize_fp8`: the scale is ``max(amax, 1e-12) * (1/448)``,
  the product with the reciprocal that XLA makes of the reference's
  division by the constant under ``jit`` (where the model runs it), so
  codes and scales equal the jitted reference's bit for bit;
- :func:`fp8_dot`: on a CUDA tensor one ``torch._scaled_mm`` (the
  card's fp8 tensor-core product; a library call, as a plain large
  matrix product stays one), A row-major, B column-major, K and N
  padded with zeros to multiples of 16 (exact), one-element fp32
  scales, fp32 out; on a CPU tensor the plain version: the e4m3fn
  codes upcast, an fp32 matmul, then the scales.  No other path: a
  card that cannot run ``_scaled_mm`` raises;
- :class:`Fp8Dense`: a drop-in for the port's ``Dense`` (``weight``
  ``[in, out]`` and ``bias``, the same names) whose product runs
  through :func:`fp8_dot` with the reference's straight-through
  backward (``_ste_bwd``): the gradients use the full-precision
  operands, in fp32.
"""

import torch
from torch import nn

E4M3_MAX = 448.0
_ALIGN = 16


def quantize_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    """Per-tensor dynamic scaling to the e4m3 range: ``(codes, scale)``
    with ``x ~ codes * scale`` and ``scale`` a 0-d fp32 tensor."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) * (1.0 / E4M3_MAX)
    return (xf / scale).to(dtype), scale


def _pad_to(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with zero codes appended along ``dim`` up to a multiple
    of 16 (a copy into zeros: no pad kernel takes fp8)."""
    extra = -t.shape[dim] % _ALIGN
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] += extra
    out = t.new_zeros(shape)
    out.narrow(dim, 0, t.shape[dim]).copy_(t)
    return out


def scaled_mm(aq: torch.Tensor, bq: torch.Tensor, sa: torch.Tensor,
              sb: torch.Tensor) -> torch.Tensor:
    """``(aq * sa) @ (bq * sb)`` in fp32 from e4m3 codes ``aq [M, K]``
    and ``bq [K, N]``.  CUDA: ``torch._scaled_mm`` with K and N padded
    with zero codes to multiples of 16; CPU: the plain version."""
    if aq.device.type != "cuda":
        return (aq.float() @ bq.float()) * (sa * sb)
    n = bq.shape[1]
    a = _pad_to(aq, 1).contiguous()
    # column-major B: the transpose of a row-major [N, K]
    b = _pad_to(_pad_to(bq, 0), 1).t().contiguous().t()
    out = torch._scaled_mm(a, b, scale_a=sa.reshape(1).float(),
                           scale_b=sb.reshape(1).float(),
                           out_dtype=torch.float32)
    return out[:, :n] if out.shape[1] != n else out


def fp8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a [..., K]``, ``b [K, N]``) with both operands
    dynamically quantized to e4m3 and an fp32 accumulator; the result
    fp32, times ``scale_a * scale_b``."""
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    aq, sa = quantize_fp8(a)
    bq, sb = quantize_fp8(b)
    flat = aq.reshape(-1, aq.shape[-1])
    out = scaled_mm(flat, bq, sa, sb)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _SteFp8Dot(torch.autograd.Function):
    """The reference's ``_ste_fp8_dot`` ``custom_vjp``: fp8 forward,
    straight-through backward over the full-precision operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_dot(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = g @ b.float().t()
        db = a.float().t() @ g
        return da.to(a.dtype), db.to(b.dtype)


class Fp8Dense(nn.Module):
    """The reference's ``Fp8Dense``: a ``Dense`` (flax layout,
    ``weight [in, out]``, ``bias``) whose product runs through the fp8
    path.  The parameters stay in their dtype; the input enters the
    product as it comes, the kernel as fp32, and the fp32 product plus
    the bias is cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=dtype, device=device)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        out = _SteFp8Dot.apply(flat, self.weight.float())
        out = out.reshape(*x.shape[:-1], self.out_features)
        if self.bias is not None:
            out = out + self.bias
        return out.to(dtype)
