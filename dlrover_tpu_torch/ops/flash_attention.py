"""Flash attention (forward + backward) for the H100.

Reference: ``dlrover_tpu/ops/flash_attention.py`` (Pallas TPU kernels
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).  Here the
three kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/flash_attention.cu``, built at first use by
:mod:`dlrover_tpu_torch.ops.cuda_build` and called through ctypes; the
source's header says what bounds them on the card and what the design
does about it.

Layout at the public function stays the reference's
``[batch, seq, heads, head_dim]``; the kernels read it through strides,
so the q/k/v views of a fused qkv projection are not copied.  ``lse``
and the backward's row term ``Delta = rowsum(O * dO)`` are fp32
``[batch, heads, seq]``.

Dispatch is by device: a CPU tensor takes the plain PyTorch version
below (the same tiled online-softmax algorithm with the same casts,
tiled by the public ``block_q``/``block_k``); a CUDA tensor launches
the kernel or raises.  The kernels tile by rows of their own: the bf16
and fp16 forward and dK/dV (wgmma, fed by TMA) by 128, the FMA kernels
by 64 (32 at head_dim 256).  They take head_dim 64, 128 and 256
(:data:`KERNEL_HEAD_DIMS`), and past 256 any multiple of 64 (the wide
kernels, which walk head_dim in chunks of 64 columns with fp32
accumulators in a scratch buffer allocated here); any other head_dim is
zero-padded to the next of them on the way in and sliced on the way
out, with the scale of the true head_dim.  That is exact: the padded
columns add zeros to QK^T and to Delta, and the padded columns of O,
dQ, dK and dV are zero.  ``LAUNCHES`` counts kernel launches only.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# tile of the plain version when the caller names none; the CUDA
# kernels use their own tiles whatever is asked here
DEFAULT_BLOCK = 128

# kernel launches, one count per kernel, bumped where it launches
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h, d] -> [b*h, s, d]."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    """[b*h, s, d] -> [b, s, h, d]."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).permute(0, 2, 1, 3)


def _kv_rows(x: torch.Tensor, group: int) -> torch.Tensor:
    """Folded kv rows, one per q row: q row ``r`` reads kv row
    ``r // group`` (kv-head-major GQA)."""
    f = _fold(x)
    return f.repeat_interleave(group, dim=0) if group > 1 else f


def _masked_logits(qb, kb, scale, causal, q0, k0):
    logits = torch.einsum("bqd,bkd->bqk", qb.float(), kb.float()) * scale
    if causal:
        q_pos = q0 + torch.arange(qb.shape[1], device=qb.device)
        k_pos = k0 + torch.arange(kb.shape[1], device=qb.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    return logits


def fwd_plain(
    q, k, v, scale: float, causal: bool, block_q: int, block_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(out [b, s, h, d] in q's
    dtype, lse [b, h, s] fp32)``.  Rounds p to v's dtype before P.V,
    as ``_fwd_kernel`` does."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf, kf, vf = _fold(q), _kv_rows(k, group), _kv_rows(v, group)
    out = torch.empty_like(qf)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        qb = qf[:, q0:q0 + block_q]
        m = torch.full(qb.shape[:2], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(qb.shape[:2], dtype=torch.float32, device=q.device)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, s, block_k):
            if causal and k0 > q0 + block_q - 1:
                break
            kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            logits = _masked_logits(qb, kb, scale, causal, q0, k0)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.bmm(
                p.to(v.dtype).float(), vb.float()
            )
            m = m_new
        safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q0 + block_q] = (acc / safe_l[..., None]).to(q.dtype)
        lse[:, q0:q0 + block_q] = m + torch.log(safe_l)
    return _unfold(out, b), lse.reshape(b, h, s)


def delta_plain(out, dout) -> torch.Tensor:
    """``Delta = rowsum(O * dO)`` in fp32, ``[b, h, s]``."""
    return (out.float() * dout.float()).sum(dim=-1).permute(0, 2, 1)


def bwd_dq_plain(
    q, k, v, dout, lse, delta, scale: float, causal: bool,
    block_q: int, block_k: int,
) -> torch.Tensor:
    """Plain version of the dQ kernel.  Rounds dS to k's dtype before
    dS.K, as ``_bwd_dq_kernel`` does."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf, kf, vf = _fold(q), _kv_rows(k, group), _kv_rows(v, group)
    dof = _fold(dout).float()
    lse, delta = lse.reshape(b * h, s), delta.reshape(b * h, s)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        qb, dob = qf[:, q0:q0 + block_q], dof[:, q0:q0 + block_q]
        lse_b = lse[:, q0:q0 + block_q, None]
        delta_b = delta[:, q0:q0 + block_q, None]
        for k0 in range(0, s, block_k):
            if causal and k0 > q0 + block_q - 1:
                break
            kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            p = torch.exp(
                _masked_logits(qb, kb, scale, causal, q0, k0) - lse_b
            )
            dp = torch.bmm(dob, vb.float().transpose(1, 2))
            ds = p * (dp - delta_b) * scale
            dq[:, q0:q0 + block_q] += torch.bmm(
                ds.to(k.dtype).float(), kb.float()
            )
    return _unfold(dq.to(q.dtype), b)


def bwd_dkv_plain(
    q, k, v, dout, lse, delta, scale: float, causal: bool,
    block_q: int, block_k: int, operand_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: p, dS, dO and q stay fp32,
    as in ``_bwd_dkv_kernel``; the group's q heads are summed in fp32
    before the one cast, as the CUDA kernel does.  ``operand_dtype``
    rounds p and dS before their products: bf16 gives the coarser
    rounding point that the kernel checks hold the bf16 kernel away
    from."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qf, kf, vf = _fold(q).float(), _kv_rows(k, group), _kv_rows(v, group)
    dof = _fold(dout).float()
    lse, delta = lse.reshape(b * h, s), delta.reshape(b * h, s)
    dk = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        for q0 in range(0, s, block_q):
            if causal and q0 + block_q - 1 < k0:
                continue
            qb, dob = qf[:, q0:q0 + block_q], dof[:, q0:q0 + block_q]
            p = torch.exp(
                _masked_logits(qb, kb, scale, causal, q0, k0)
                - lse[:, q0:q0 + block_q, None]
            )
            dv[:, k0:k0 + block_k] += torch.bmm(
                p.to(operand_dtype).float().transpose(1, 2), dob)
            dp = torch.bmm(dob, vb.float().transpose(1, 2))
            ds = p * (dp - delta[:, q0:q0 + block_q, None]) * scale
            dk[:, k0:k0 + block_k] += torch.bmm(
                ds.to(operand_dtype).float().transpose(1, 2), qb)
    dk = dk.reshape(b * kvh, group, s, d).sum(dim=1)
    dv = dv.reshape(b * kvh, group, s, d).sum(dim=1)
    return _unfold(dk.to(k.dtype), b), _unfold(dv.to(v.dtype), b)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims the kernels are built for; others up to 256 are padded
# up to one, and past 256 up to a multiple of WIDE_CHUNK (the wide kernels)
KERNEL_HEAD_DIMS = (64, 128, 256)
WIDE_CHUNK = 64


def kernel_head_dim(d: int) -> int:
    """The head_dim a CUDA launch runs at for a true head_dim ``d``:
    the least of :data:`KERNEL_HEAD_DIMS` that holds it, or past 256 the
    least multiple of :data:`WIDE_CHUNK` that does."""
    if d <= 0:
        raise ValueError(f"head_dim must be positive, not {d}")
    for kd in KERNEL_HEAD_DIMS:
        if d <= kd:
            return kd
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def _is_wide(d: int) -> bool:
    return d > KERNEL_HEAD_DIMS[-1]


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with zero columns appended to head_dim up to ``d``."""
    extra = d - x.shape[-1]
    return F.pad(x, (0, extra)) if extra else x


class _Params(ctypes.Structure):
    """Field for field the ``FlashParams`` struct of the CUDA source."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "out", "lse", "delta",
            "dq", "dk", "dv",
        )]
        + [(f"{t}_{s}", ctypes.c_longlong)
           for t in ("q", "k", "v", "o", "do") for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int) for n in (
            "B", "S", "H", "KVH", "group", "causal", "dtype", "head_dim",
        )]
        + [("scale", ctypes.c_float), ("scratch", ctypes.c_void_p)]
    )


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from dlrover_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flash_attention")
        for fn in ("dlr_flash_fwd", "dlr_flash_bwd_dq", "dlr_flash_bwd_dkv"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.dlr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dlr_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _cuda_inputs(*xs: torch.Tensor):
    """Check what the kernels take and return the inputs ready for
    them.  The bf16 and fp16 wgmma kernels read rows through TMA tensor
    maps (and 16-byte copies), which need a 16-byte-aligned base and
    16-byte strides, so a view that breaks either is copied first; the
    fused-qkv views of the model pass as they are."""
    q = xs[0]
    for x in xs:
        if x.device != q.device:
            raise ValueError(
                f"flash attention inputs on {x.device} and {q.device}"
            )
        if x.dtype != q.dtype:
            raise ValueError(
                f"flash attention inputs of {x.dtype} and {q.dtype}"
            )
        if x.stride(-1) != 1:
            raise ValueError("flash attention needs head_dim contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(
            f"CUDA flash attention takes float32, bfloat16 or float16, "
            f"not {q.dtype}"
        )
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS and not (_is_wide(d) and d % WIDE_CHUNK == 0):
        raise ValueError(
            f"the CUDA flash kernels take head_dim in {KERNEL_HEAD_DIMS} "
            f"or a multiple of {WIDE_CHUNK} past them, not {d}: pad it "
            "first (pad_head_dim)"
        )
    if q.dtype == torch.float32 or d >= 256:
        return xs  # the FMA and wide kernels read elements, not TMA boxes
    return tuple(
        x.clone(memory_format=torch.contiguous_format)
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1])
        else x
        for x in xs
    )


def _scratch(rows: int, d: int, device) -> Optional[torch.Tensor]:
    """The wide kernels' fp32 accumulators, ``rows * d`` of them; None
    below head_dim 256, whose kernels keep theirs in registers."""
    if not _is_wide(d):
        return None
    return torch.empty(rows * d, dtype=torch.float32, device=device)


def _params(q, k, v, scale, causal, **ptrs) -> _Params:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    p = _Params()
    for name, t in dict(q=q, k=k, v=v, **ptrs).items():
        if t is not None:
            setattr(p, name, t.data_ptr())
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("o", ptrs.get("o")), ("do", ptrs.get("dout"))):
        if t is not None:
            setattr(p, f"{name}_sb", t.stride(0))
            setattr(p, f"{name}_ss", t.stride(1))
            setattr(p, f"{name}_sh", t.stride(2))
    p.B, p.S, p.H, p.KVH, p.group = b, s, h, kvh, h // kvh
    p.causal, p.dtype, p.head_dim = int(causal), _DTYPES[q.dtype], d
    p.scale = scale
    return p


def _launch(fn_name: str, params: _Params, device: torch.device):
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(ctypes.byref(params), stream)
    if err != 0:
        msg = lib.dlr_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")


def fwd_cuda(q, k, v, scale: float, causal: bool):
    """Launch the forward kernel: ``(out [b, s, h, d], lse [b, h, s])``."""
    q, k, v = _cuda_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("dlr_flash_fwd", _params(
        q, k, v, scale, causal, out=out, lse=lse,
        scratch=_scratch(b * h * s, d, q.device)), q.device)
    LAUNCHES["fwd"] += 1
    return out, lse


def bwd_dq_cuda(q, k, v, out, dout, lse, scale: float, causal: bool):
    """Launch the dQ kernel, which also writes Delta:
    ``(dq [b, s, h, d], delta [b, h, s])``."""
    q, k, v, out, dout = _cuda_inputs(q, k, v, out, dout)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("dlr_flash_bwd_dq", _params(
        q, k, v, scale, causal, o=out, dout=dout, lse=lse.contiguous(),
        delta=delta, dq=dq, scratch=_scratch(b * h * s, d, q.device),
    ), q.device)
    LAUNCHES["bwd_dq"] += 1
    return dq, delta


def bwd_dkv_cuda(q, k, v, dout, lse, delta, scale: float, causal: bool):
    """Launch the dK/dV kernel: per-kv-head ``(dk, dv)`` shaped as k.

    The bf16 and fp16 kernel reads the rows of lse and Delta (``[b, h,
    s]`` as one flat array) through TMA boxes that must start on 16
    bytes: a seq that 4 does not divide is padded to the next multiple
    of 4 here (zero q, dO, lse and Delta rows, which add nothing to dK
    and dV; zero keys and values, whose dK and dV are sliced off)."""
    s = q.shape[1]
    if s % 4 and q.dtype != torch.float32 and q.shape[-1] < 256:
        pad = 4 - s % 4
        q, k, v, dout = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (q, k, v, dout))
        lse, delta = (F.pad(x, (0, pad)) for x in (lse, delta))
        dk, dv = bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, causal)
        return dk[:, :s], dv[:, :s]
    q, k, v, dout = _cuda_inputs(q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    b, s, kvh, d = k.shape
    _launch("dlr_flash_bwd_dkv", _params(
        q, k, v, scale, causal, dout=dout, lse=lse.contiguous(),
        delta=delta.contiguous(), dk=dk, dv=dv,
        scratch=_scratch(2 * b * kvh * s, d, q.device),
    ), q.device)
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cpu or cuda, not {x.device}")


class _FlashAttention(torch.autograd.Function):
    """On a CUDA tensor q, k and v are padded to the kernels' head_dim
    once, in the forward; the padded tensors and the padded output are
    what the backward's kernels read."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        d = q.shape[-1]
        if _on_cpu(q):
            out, lse = fwd_plain(q, k, v, scale, causal, block_q, block_k)
            out_k = out
        else:
            kd = kernel_head_dim(d)
            q, k, v = (pad_head_dim(x, kd) for x in (q, k, v))
            out_k, lse = fwd_cuda(q, k, v, scale, causal)
            out = out_k[..., :d].contiguous() if kd != d else out_k
        ctx.save_for_backward(q, k, v, out_k, lse)
        ctx.cfg = (scale, causal, block_q, block_k, d)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, block_q, block_k, d = ctx.cfg
        dout = dout.contiguous()
        if _on_cpu(q):
            delta = delta_plain(out, dout)
            dq = bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                              block_q, block_k)
            dk, dv = bwd_dkv_plain(q, k, v, dout, lse, delta, scale,
                                   causal, block_q, block_k)
        else:
            dout = pad_head_dim(dout, q.shape[-1])
            dq, delta = bwd_dq_cuda(q, k, v, out, dout, lse, scale, causal)
            dk, dv = bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, causal)
            if q.shape[-1] != d:
                dq, dk, dv = (x[..., :d] for x in (dq, dk, dv))
        return dq, dk, dv, None, None, None, None


def _fit_block(s: int, requested: int) -> int:
    """Largest divisor of ``s`` that is <= requested — so a seq that
    is a multiple of 128 but not of the (large) default block still
    works, just with a smaller tile."""
    block = min(requested, s)
    while block > 1 and s % block:
        block //= 2
    if s % block:  # odd seq lens: fall back to the full sequence
        return s
    return block


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Flash attention over [batch, seq, heads, head_dim] tensors.

    Drop-in for :func:`dlrover_tpu_torch.models.gpt.xla_causal_attention`.
    ``block_q``/``block_k`` tile the plain version and must fit the
    sequence as in the reference; the CUDA kernels take any seq.

    GQA: ``k``/``v`` may carry fewer heads than ``q`` (``kv_heads``
    dividing ``heads``, kv-head-major q layout as in the Llama
    family); no kernel builds the repeated kv tensor.

    On the card: fp32, bf16 or fp16, any head_dim (padded to the
    kernels' 64, 128 or 256, or past 256 to a multiple of 64).
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if v.shape[2] != kvh:
        raise ValueError(
            f"k has {kvh} heads but v has {v.shape[2]}"
        )
    if h % kvh:
        raise ValueError(
            f"q heads {h} not a multiple of kv heads {kvh}"
        )
    scale = scale if scale is not None else d**-0.5
    block_q = _fit_block(s, block_q or DEFAULT_BLOCK)
    block_k = _fit_block(s, block_k or DEFAULT_BLOCK)
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq len {s} must be divisible by blocks "
            f"({block_q},{block_k})"
        )
    out = _FlashAttention.apply(q, k, v, scale, causal, block_q, block_k)
    if dtype is not None:
        out = out.to(dtype)
    return out


# the kernels read each kv head once per group (no repeated kv tensor):
# a model with fewer kv heads than q heads passes k and v as they are
flash_attention.gqa_aware = True
