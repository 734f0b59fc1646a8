"""Blockwise int8 quantization of optimizer state for the H100.

Reference: ``dlrover_tpu/ops/quantization.py`` (Pallas TPU kernels
``_quant_kernel``, ``_dequant_kernel``, ``_qadam_kernel``).  Here the
three kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/quantization.cu``, built at first use by
:mod:`dlrover_tpu_torch.ops.cuda_build` and called through ctypes; the
source's header says what bounds them on the card and how they round.

Layout: a tensor is flattened in its own (row-major) order and cut
into rows of ``block_size`` elements, the last row zero-padded
(:func:`to_block_tiles`); each row carries one fp32 scale.  The CUDA
kernels read that layout straight from the tensor's flat storage and
treat positions past ``numel`` as the zeros the padding would hold, so
no padded fp32 copy is made on the card.

Dispatch is by device: a CPU tensor takes the plain PyTorch version
below (the same arithmetic, one rounding per operation, in the
reference's order); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches only.  The 4-bit nibble packing
and the sqrt-domain 4-bit codec are plain tensor ops, as in the
reference.
"""

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BLOCK = 2048  # elements per scale block
SCALE_FLOOR = 1e-12

# kernel launches, one count per kernel, bumped where it launches
LAUNCHES = {"quantize": 0, "dequantize": 0, "qadam": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def num_rows(numel: int, block_size: int) -> int:
    return -(-numel // block_size)


def to_block_tiles(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flatten + zero-pad ``x`` to the fp32 ``[rows, block_size]``
    layout every kernel here works on."""
    flat = x.reshape(-1).float()
    rows = num_rows(flat.numel(), block_size)
    pad = rows * block_size - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(rows, block_size)


def _numel(shape) -> int:
    return math.prod(shape)


def reciprocal(qmax: float) -> float:
    """``fp32(1 / qmax)``.  The reference's XLA rewrites the division
    of a row's absmax by the constant ``qmax`` into a product with
    this reciprocal; the kernels and plain versions here do the same,
    so the scales agree bit for bit."""
    return float(np.float32(1.0) / np.float32(qmax))


def device_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device.  Dividing by it is an
    IEEE division on every device (PyTorch's CUDA division by a Python
    number multiplies by its reciprocal instead); ``torch.full``
    fills it on the device, with no host-device copy."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def quantize_plain(
    tiles: torch.Tensor, qmax: float = 127.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantize kernel: per row
    ``scale = max(absmax * fp32(1/qmax), 1e-12)`` and
    ``q = clip(round_half_even(x / scale), -qmax, qmax)`` as int8."""
    x = tiles.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * reciprocal(qmax), SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of the dequantize kernel: ``q * scale`` in fp32."""
    return q.float() * scales


def fused_qadam_step_plain(
    g_tiles, p_tiles, q_mu, mu_scales, q_nu, nu_scales,
    bc1: float, bc2: float, *, b1: float, b2: float, eps: float,
    lr: float, wd: float, out_dtype: Optional[torch.dtype] = None,
):
    """Plain version of the fused quantized-Adam kernel over tiles, in
    the reference's order of operations: ``(upd_tiles, q_mu',
    mu_scales', q_nu', nu_scales')``.  ``mu`` is stored linear,
    ``nu`` in the sqrt domain (``nu = (q * scale)^2``); ``bc1``/``bc2``
    are the fp32 bias corrections; ``upd`` comes out in ``out_dtype``
    (default: the gradient's dtype)."""
    g = g_tiles.float()
    p = p_tiles.float()
    bc1, bc2 = device_scalar(bc1, g), device_scalar(bc2, g)
    mu = q_mu.float() * mu_scales
    nu_sqrt_prev = q_nu.float() * nu_scales
    nu = b2 * nu_sqrt_prev * nu_sqrt_prev + (1.0 - b2) * g * g
    mu = b1 * mu + (1.0 - b1) * g
    m_hat = mu / bc1
    v_hat = nu / bc2
    upd = (-lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * p)).to(
        out_dtype or g_tiles.dtype
    )
    inv = reciprocal(127.0)
    mu_scale = torch.clamp_min(
        mu.abs().amax(dim=-1, keepdim=True) * inv, SCALE_FLOOR
    )
    qmu = torch.clamp(torch.round(mu / mu_scale), -127, 127).to(torch.int8)
    nu_sqrt = torch.sqrt(nu)
    nu_scale = torch.clamp_min(
        nu_sqrt.amax(dim=-1, keepdim=True) * inv, SCALE_FLOOR
    )
    qnu = torch.clamp(torch.round(nu_sqrt / nu_scale), 0, 127).to(torch.int8)
    return upd, qmu, mu_scale, qnu, nu_scale


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/quantization.cu)
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _QAdamParams(ctypes.Structure):
    """Field for field the ``QAdamParams`` struct of the CUDA source."""

    _fields_ = (
        [("leaves", ctypes.c_void_p), ("n_leaves", ctypes.c_longlong),
         ("rows", ctypes.c_longlong), ("block", ctypes.c_int),
         ("pad", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in (
            "b1", "b2", "one_minus_b1", "one_minus_b2", "neg_lr", "eps",
            "wd",
        )]
    )


# field for field the ``QAdamLeaf`` struct of the CUDA source: one row of
# the leaf table of a multi-tensor q-AdamW launch
LEAF_DTYPE = np.dtype([
    *[(n, np.uint64) for n in ("p", "g", "q_mu", "mu_scales", "q_nu",
                               "nu_scales")],
    ("numel", np.int64), ("row0", np.int64),
    ("bc1", np.float32), ("bc2", np.float32),
    ("dtype", np.int32), ("pad", np.int32),
])


class QAdamLeaf(NamedTuple):
    """One parameter of a multi-tensor q-AdamW step: the parameter, its
    gradient, both moments' codes and scales (updated in place), and
    its fp32 bias corrections."""

    p: torch.Tensor
    g: torch.Tensor
    q_mu: torch.Tensor
    mu_scales: torch.Tensor
    q_nu: torch.Tensor
    nu_scales: torch.Tensor
    bc1: float
    bc2: float


def leaf_rows(numels: Sequence[int], block_size: int) -> np.ndarray:
    """Each leaf's first row among the rows of all leaves, and the total
    after them: ``[n + 1]`` int64 prefix sums of the leaves' rows (a
    leaf of no elements has no row)."""
    rows = -(-np.asarray(numels, dtype=np.int64) // block_size)
    return np.concatenate([np.zeros(1, np.int64), np.cumsum(rows)])


def leaf_table(leaves: Sequence[QAdamLeaf], block_size: int
               ) -> Tuple[np.ndarray, int]:
    """The kernel's leaf table (``LEAF_DTYPE``) over the leaves that
    have elements, in order, and the rows of all of them."""
    numels = [leaf.p.numel() for leaf in leaves]
    if not all(numels):
        leaves = [leaf for leaf, n in zip(leaves, numels) if n]
        numels = [n for n in numels if n]
    starts = leaf_rows(numels, block_size)
    # column by column from flat lists: the host builds this table every
    # step, and numpy fills a column from a list faster than a record
    # from a tuple
    table = np.zeros(len(leaves), LEAF_DTYPE)
    ptrs = np.array([t.data_ptr() for leaf in leaves for t in leaf[:6]],
                    dtype=np.uint64).reshape(len(leaves), 6)
    for i, name in enumerate(LEAF_DTYPE.names[:6]):
        table[name] = ptrs[:, i]
    table["numel"] = numels
    table["row0"] = starts[:-1]
    table["bc1"] = [leaf.bc1 for leaf in leaves]
    table["bc2"] = [leaf.bc2 for leaf in leaves]
    table["dtype"] = [_DTYPES.get(leaf.p.dtype, -1) for leaf in leaves]
    return table, int(starts[-1])


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from dlrover_tpu_torch.ops import cuda_build

        lib = cuda_build.load("quantization")
        lib.dlr_quantize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.dlr_dequantize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.dlr_qadam_step.argtypes = [
            ctypes.POINTER(_QAdamParams), ctypes.c_void_p,
        ]
        for fn in (lib.dlr_quantize, lib.dlr_dequantize, lib.dlr_qadam_step):
            fn.restype = ctypes.c_int
        lib.dlr_quant_error_string.argtypes = [ctypes.c_int]
        lib.dlr_quant_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(name: str, err: int):
    if err != 0:
        msg = _lib().dlr_quant_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_block(block_size: int):
    # the kernels hold a row of up to 8192 elements in registers and take
    # two passes over a longer one; the block is a C int
    if not 0 < block_size < 2**31:
        raise ValueError(
            f"the CUDA quantization kernels take block_size in "
            f"[1, 2**31 - 1], not {block_size}"
        )


def _flat_input(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise ValueError(
            f"CUDA {what} takes bfloat16 or float32, not {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError(f"CUDA {what} needs a contiguous tensor")
    return x


def _check_state(q: torch.Tensor, scales: torch.Tensor, rows: int,
                 block_size: int, device: torch.device):
    if q.dtype != torch.int8 or q.shape != (rows, block_size):
        raise ValueError(
            f"codes must be int8 [{rows}, {block_size}], got {q.dtype} "
            f"{tuple(q.shape)}"
        )
    if scales.dtype != torch.float32 or scales.shape != (rows, 1):
        raise ValueError(
            f"scales must be float32 [{rows}, 1], got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    for t in (q, scales):
        if t.device != device or not t.is_contiguous():
            raise ValueError("codes and scales must be contiguous on "
                             f"{device}")


def quantize_cuda(
    x: torch.Tensor, block_size: int, qmax: float = 127.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel on ``x`` read as ``[rows, block]``
    tiles of its flat storage: ``(q int8 [rows, block], scales fp32
    [rows, 1])``."""
    _check_block(block_size)
    x = _flat_input(x, "quantize")
    rows = num_rows(x.numel(), block_size)
    q = torch.empty((rows, block_size), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            _check("dlr_quantize", _lib().dlr_quantize(
                x.data_ptr(), _DTYPES[x.dtype], x.numel(), rows, block_size,
                qmax, reciprocal(qmax), q.data_ptr(), scales.data_ptr(),
                _stream(x.device),
            ))
        LAUNCHES["quantize"] += 1
    return q, scales


def dequantize_cuda(
    q: torch.Tensor, scales: torch.Tensor, shape=None
) -> torch.Tensor:
    """Launch the dequantize kernel: fp32 ``shape`` (default: the
    tiles' own ``[rows, block]``), written straight from the tiles'
    first ``numel`` elements."""
    rows, block_size = q.shape
    _check_block(block_size)
    _check_state(q, scales, rows, block_size, q.device)
    shape = tuple(shape) if shape is not None else (rows, block_size)
    numel = _numel(shape)
    if numel > rows * block_size:
        raise ValueError(f"{rows}x{block_size} tiles hold no {shape}")
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    if rows:
        with torch.cuda.device(q.device):
            _check("dlr_dequantize", _lib().dlr_dequantize(
                q.data_ptr(), scales.data_ptr(), numel, rows, block_size,
                out.data_ptr(), _stream(q.device),
            ))
        LAUNCHES["dequantize"] += 1
    return out


def _hyper(b1, b2, eps, lr, wd, **fields) -> _QAdamParams:
    """fp32 constants as the reference bakes them: each Python double
    (``1 - b1`` too) rounded once to fp32."""
    p = _QAdamParams(**fields)
    p.b1, p.b2 = b1, b2
    p.one_minus_b1, p.one_minus_b2 = 1.0 - b1, 1.0 - b2
    p.neg_lr, p.eps, p.wd = -lr, eps, wd
    return p


def _check_qadam_state(p: torch.Tensor, q_mu, mu_scales, q_nu,
                       nu_scales, block_size: int):
    """The parameter and its state as the q-AdamW kernel reads and
    writes them: ``p`` contiguous bf16 or fp32, codes int8 ``[rows,
    block_size]`` and scales fp32 ``[rows, 1]`` for its elements, all
    contiguous on p's device.  Raises ``ValueError`` otherwise."""
    _check_block(block_size)
    p = _flat_input(p, "qadam")
    rows = q_mu.shape[0]
    if rows != num_rows(p.numel(), block_size):
        raise ValueError(f"{rows} state rows for {p.numel()} elements")
    _check_state(q_mu, mu_scales, rows, block_size, p.device)
    _check_state(q_nu, nu_scales, rows, block_size, p.device)


def _check_step(leaves: Sequence[QAdamLeaf], device: torch.device):
    """Each parameter contiguous in a kernel dtype, and each gradient
    contiguous, on ``device``, shaped and typed as its parameter: one
    pass, no call a leaf (the host runs it every step)."""
    bad = next((leaf for leaf in leaves if leaf.p.dtype not in _DTYPES
                or not leaf.p.is_contiguous()
                or leaf.g.dtype is not leaf.p.dtype
                or leaf.g.shape != leaf.p.shape
                or not leaf.g.is_contiguous() or leaf.g.device != device),
               None)
    if bad is None:
        return
    p, g = _flat_input(bad.p, "qadam"), bad.g
    if g.device != device:
        raise ValueError(f"gradient on {g.device}, launch on {device}")
    raise ValueError(
        f"qadam needs a contiguous gradient shaped and typed as the "
        f"parameter ({p.dtype} {tuple(p.shape)}), got {g.dtype} "
        f"{tuple(g.shape)}"
    )


def qadam_multi_cuda(leaves: Sequence[QAdamLeaf], *, b1, b2, eps, lr, wd,
                     state_checked: bool = False):
    """Launch the fused quantized-Adam kernel once over ``leaves`` (bf16
    and fp32 parameters alike, one block size, one device): updates each
    ``p`` in place (``p + round_p(upd)``, rounded to p's dtype, as
    ``apply_updates``) and its four state tensors in place.

    The parameters and gradients are checked at every call; each leaf's
    state (:func:`_check_qadam_state`) too, unless ``state_checked``
    says that its owner built or loaded it so: codes and scales of the
    parameter's rows, contiguous on its device."""
    if not leaves:
        return
    block_size = leaves[0].q_mu.shape[1]
    _check_block(block_size)
    device = leaves[0].p.device
    table, rows = leaf_table(leaves, block_size)
    if not rows:
        return
    if not state_checked:
        for leaf in leaves:
            if leaf.p.device != device:
                raise ValueError(f"parameter on {leaf.p.device}, launch on "
                                 f"{device}")
            _check_qadam_state(leaf.p, *leaf[2:6], block_size)
    _check_step(leaves, device)
    with torch.cuda.device(device):
        # one non-blocking copy from pinned memory on the current stream,
        # where the kernel reads it; the caching host allocator holds the
        # pinned block until the copy is done
        dev = torch.from_numpy(table.view(np.uint8)).pin_memory().to(
            device, non_blocking=True)
        params = _hyper(
            b1, b2, eps, lr, wd, leaves=dev.data_ptr(), n_leaves=len(table),
            rows=rows, block=block_size,
        )
        _check("dlr_qadam_step", _lib().dlr_qadam_step(
            ctypes.byref(params), _stream(device)
        ))
    LAUNCHES["qadam"] += 1


def qadam_step_cuda(
    p, g, q_mu, mu_scales, q_nu, nu_scales, *, bc1, bc2, b1, b2, eps, lr,
    wd,
):
    """The one-leaf case of :func:`qadam_multi_cuda`."""
    qadam_multi_cuda(
        [QAdamLeaf(p, g, q_mu, mu_scales, q_nu, nu_scales, bc1, bc2)],
        b1=b1, b2=b2, eps=eps, lr=lr, wd=wd,
    )


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"quantization runs on cpu or cuda, not {x.device}")


def quantize_blockwise(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK, qmax: float = 127.0,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Flatten + pad to ``[rows, block_size]``; returns ``(int8
    values, fp32 scales [rows, 1], original shape)``.  On the card the
    kernel reads ``x`` in place (bf16 or fp32, upcast in registers)."""
    shape = tuple(x.shape)
    if _on_cpu(x):
        q, scales = quantize_plain(to_block_tiles(x, block_size), qmax)
    else:
        q, scales = quantize_cuda(x.contiguous(), block_size, qmax)
    return q, scales, shape


def dequantize_blockwise(
    q: torch.Tensor, scales: torch.Tensor, shape: Tuple[int, ...]
) -> torch.Tensor:
    if _on_cpu(q):
        out = dequantize_plain(q, scales)
        return out.reshape(-1)[:_numel(shape)].reshape(shape)
    return dequantize_cuda(q, scales, shape)


def fused_qadam_update_(
    p: torch.Tensor, g: torch.Tensor, q_mu, mu_scales, q_nu, nu_scales, *,
    bc1: float, bc2: float, b1: float, b2: float, eps: float, lr: float,
    wd: float,
):
    """One quantized-AdamW step of one parameter, in place: the
    moments' codes and scales are replaced by the new ones and ``p``
    by ``p + upd`` in p's dtype (what ``optax.apply_updates`` gives for
    the reference's update).  On the card: one kernel launch."""
    if not _on_cpu(p):
        return qadam_step_cuda(
            p, g, q_mu, mu_scales, q_nu, nu_scales, bc1=bc1, bc2=bc2, b1=b1,
            b2=b2, eps=eps, lr=lr, wd=wd,
        )
    block_size = q_mu.shape[1]
    upd, qm, ms, qn, ns = fused_qadam_step_plain(
        to_block_tiles(g, block_size), to_block_tiles(p, block_size),
        q_mu, mu_scales, q_nu, nu_scales, bc1, bc2, b1=b1, b2=b2, eps=eps,
        lr=lr, wd=wd, out_dtype=p.dtype,
    )
    p.add_(upd.reshape(-1)[:p.numel()].reshape(p.shape))
    for state, new in ((q_mu, qm), (mu_scales, ms), (q_nu, qn),
                       (nu_scales, ns)):
        state.copy_(new)


def fused_qadam_update_multi_(
    leaves: Sequence[QAdamLeaf], *, b1: float, b2: float, eps: float,
    lr: float, wd: float, state_checked: bool = False,
):
    """One quantized-AdamW step of every leaf, in place, with shared
    hyperparameters and each leaf's own bias corrections.  On the card:
    one kernel launch for all of them (``state_checked`` as in
    :func:`qadam_multi_cuda`); on the CPU: the plain step of
    :func:`fused_qadam_update_`, leaf by leaf."""
    if not leaves:
        return
    if not _on_cpu(leaves[0].p):
        return qadam_multi_cuda(leaves, b1=b1, b2=b2, eps=eps, lr=lr, wd=wd,
                                state_checked=state_checked)
    for leaf in leaves:
        if not _on_cpu(leaf.p):
            raise ValueError("q-AdamW leaves on the CPU and on "
                             f"{leaf.p.device} in one step")
        fused_qadam_update_(*leaf[:6], bc1=leaf.bc1, bc2=leaf.bc2, b1=b1,
                            b2=b2, eps=eps, lr=lr, wd=wd)


# -- 4-bit (packed nibbles), plain tensor ops around the kernels ------------


def quantize_blockwise_4bit(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """int4 blockwise: symmetric absmax over +-7 (the quantize kernel
    at qmax 7), two values packed per byte.  Returns ``(packed uint8
    [rows, block/2], scales [rows, 1], shape)``."""
    q, scales, shape = quantize_blockwise(x, block_size, qmax=7.0)
    biased = (q + 7).to(torch.uint8)  # nibbles in [0, 14]
    packed = biased[:, 0::2] | (biased[:, 1::2] << 4)
    return packed, scales, shape


def _unpack(packed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    lo = (packed & 0xF).to(dtype)
    hi = ((packed >> 4) & 0xF).to(dtype)
    rows, half = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(rows, half * 2)


def dequantize_blockwise_4bit(
    packed: torch.Tensor, scales: torch.Tensor, shape: Tuple[int, ...],
) -> torch.Tensor:
    q = _unpack(packed, torch.int32) - 7
    return dequantize_blockwise(q.to(torch.int8), scales, shape)


def quantize_blockwise_4bit_sqrt(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Unsigned 4-bit in the sqrt domain, for Adam's second moment:
    15 levels over ``[0, sqrt(absmax)]``."""
    shape = tuple(x.shape)
    y = torch.sqrt(torch.clamp_min(to_block_tiles(x, block_size), 0.0))
    scales = torch.clamp_min(
        y.amax(dim=-1, keepdim=True) * reciprocal(15.0), SCALE_FLOOR
    )
    q = torch.clamp(torch.round(y / scales), 0, 15).to(torch.uint8)
    packed = q[:, 0::2] | (q[:, 1::2] << 4)
    return packed, scales, shape


def dequantize_blockwise_4bit_sqrt(
    packed: torch.Tensor, scales: torch.Tensor, shape: Tuple[int, ...],
) -> torch.Tensor:
    y = _unpack(packed, torch.float32) * scales
    return (y * y).reshape(-1)[:_numel(shape)].reshape(shape)


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """``(1 - b1**count, 1 - b2**count)`` in fp32, as the reference
    computes them on the device, here on the host from the host count
    (no device sync).  Returned as Python floats holding the fp32
    values exactly."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(b1), c)),
            float(one - np.power(np.float32(b2), c)))
