"""Low-bit (int8 / int4 state) AdamW and AGD as torch optimizers.

Reference: ``dlrover_tpu/optim/low_bit.py`` (``q_adamw``, ``q_agd``,
``migrate_qadamw_state_v0``), optax transforms over the Pallas kernels
of ``dlrover_tpu/ops/quantization.py``.  Here they are
``torch.optim.Optimizer`` subclasses over the CUDA kernels of
:mod:`dlrover_tpu_torch.ops.quantization`, with the reference's math,
its order of operations and its state layout:

- each moment of each parameter is a :class:`QMoment`: int8 codes
  ``[rows, block]`` (packed nibbles ``[rows, block / 2]`` at 4 bits)
  and fp32 scales ``[rows, 1]`` over the parameter flattened in its
  own order; q-AdamW stores ``mu`` linear and ``nu`` in the sqrt
  domain (``nu = (q * scale)^2``), tagged ``nu_domain`` in
  :meth:`QAdamW.state_dict` as the reference tags its state;
- the step count is a host int per parameter, so the fp32 bias
  corrections are computed on the host with no device sync;
- the learning rate is read from ``param_groups`` at every step, so a
  torch LR scheduler drives it (where the reference takes an optax
  schedule).  The 8-bit step passes it to the fused kernel, so a
  schedule agrees with the reference's, which scales a unit-lr update
  afterwards, to an ulp rather than bit for bit.

The 8-bit q-AdamW step is one fused kernel launch per parameter group
over all its parameters, bf16 and fp32 alike; it writes each new
parameter in place (``p + round_p(upd)``, what
``optax.apply_updates`` gives).  The state is checked where it is
built or loaded, so a step checks only the parameters and gradients.
The 4-bit step and q-AGD are elementwise torch ops around the quantize
and dequantize kernels, as the reference leaves those chains to XLA.
State is built at construction (the reference's ``init``), through
the quantize kernel.

Sharded parameters (FSDP2's DTensors, ``Shard(0)`` over one mesh dim)
keep the reference's *global* block grid: the reference quantizes the
whole tensor flattened in blocks of ``block_size``, so here each rank
holds the state rows of the blocks its contiguous slice of that
flattening touches (:class:`ShardGrid`).  The blocks a rank holds whole
go to the fused kernel as views of its shard and state.  A block that a
shard boundary splits is gathered whole on every rank that shares it
(one sum all-reduce a step over every split block of a process group),
and each of those ranks steps the whole block in the same launch, from
the same state, so that block's codes and scale are the reference's
and alike on those ranks; each keeps its own elements of the new
parameter.  Other placements (tensor parallel) come with slice 4.3 of
the port.
"""

from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.device import is_dtensor
from dlrover_tpu_torch.ops.quantization import (
    DEFAULT_BLOCK,
    SCALE_FLOOR,
    bias_corrections,
    dequantize_blockwise,
    dequantize_blockwise_4bit,
    dequantize_blockwise_4bit_sqrt,
    device_scalar,
    QAdamLeaf,
    fused_qadam_update_multi_,
    quantize_blockwise,
    quantize_blockwise_4bit,
    quantize_blockwise_4bit_sqrt,
    reciprocal,
)


class QMoment(NamedTuple):
    """Blockwise-quantized moment: codes and per-row fp32 scales."""

    values: torch.Tensor
    scales: torch.Tensor


class ShardGrid(NamedTuple):
    """Where a rank's shard of a ``Shard(0)`` DTensor lies on the
    global block grid: its flat ``start`` and ``numel`` in the global
    tensor, the first global block ``row0`` of its ``rows`` state rows,
    its ``split`` rows (local row, index in the parameter's split
    table) whose blocks other ranks share, that table's size
    ``n_split`` (the same on every rank) and the mesh dim's process
    ``group``."""

    start: int
    numel: int
    row0: int
    rows: int
    split: Tuple[Tuple[int, int], ...]
    n_split: int
    group: Any


def shard_grid(p, block: int) -> Optional[ShardGrid]:
    """The :class:`ShardGrid` of a DTensor parameter (None for a plain
    one).  Shards follow ``torch.chunk`` over dim 0, as DTensor and
    FSDP2 cut them."""
    if not is_dtensor(p):
        return None
    from torch.distributed.tensor import Replicate, Shard

    dims = [i for i, pl in enumerate(p.placements) if isinstance(pl, Shard)]
    if (len(dims) != 1 or p.placements[dims[0]].dim != 0
            or any(not isinstance(pl, (Shard, Replicate))
                   for pl in p.placements)):
        raise NotImplementedError(
            f"low-bit state of a parameter placed {p.placements}: only "
            "Shard(0) over one mesh dim (FSDP2) keeps the global block grid; "
            "the rest comes with slice 4.3 of the port")
    mesh_dim = dims[0]
    n = p.device_mesh.size(mesh_dim)
    r = p.device_mesh.get_local_rank(mesh_dim)
    dim0, total = p.shape[0], p.numel()
    inner = total // dim0 if dim0 else 0
    chunk = -(-dim0 // n)
    cuts = [min(i * chunk, dim0) * inner for i in range(n + 1)]
    start, end = cuts[r], cuts[r + 1]
    if tuple(p.to_local().shape) != ((end - start) // max(inner, 1),
                                     *p.shape[1:]):
        raise ValueError(f"shard of {tuple(p.to_local().shape)} is not "
                         "the torch.chunk of dim 0")
    shared = sorted({c // block for c in cuts[1:-1] if 0 < c < total
                     and c % block})
    row0 = start // block
    rows = -(-end // block) - row0 if end > start else 0
    split = tuple((j - row0, i) for i, j in enumerate(shared)
                  if row0 <= j < row0 + rows)
    return ShardGrid(start, end - start, row0, rows, split, len(shared),
                     p.device_mesh.get_group(mesh_dim))


def _own_span(grid: ShardGrid, row: int, block: int) -> Tuple[int, int, int]:
    """The shard's elements in its local state row ``row``: the flat
    range ``[a, b)`` of the local tensor, and the column of ``a`` in
    the row."""
    off = grid.start - grid.row0 * block
    a = max(row * block - off, 0)
    b = min((row + 1) * block - off, grid.numel)
    return a, b, a + off - row * block


# nu-storage domain tag carried in the optimizer state: 1 = sqrt-domain
# nu.  A state without it (linear-domain nu, the reference's v0) is
# refused by QAdamW.load_state_dict; migrate_qadamw_state_v0 upgrades it.
NU_DOMAIN_SQRT_V1 = 1


def _codec(bits: int, block: int):
    """``(qmu, dqmu, qnu, dqnu)``: mu signed linear, nu sqrt-domain,
    at 8 bits through the kernels, at 4 bits as packed nibbles."""
    if bits == 8:
        def qmu(x):
            return QMoment(*quantize_blockwise(x, block)[:2])

        def dqmu(qm, shape):
            return dequantize_blockwise(qm.values, qm.scales, shape)

        def qnu(x):
            return qmu(torch.sqrt(torch.clamp_min(x, 0.0)))

        def dqnu(qm, shape):
            y = dqmu(qm, shape)
            return y * y
    else:
        def qmu(x):
            return QMoment(*quantize_blockwise_4bit(x, block)[:2])

        def dqmu(qm, shape):
            return dequantize_blockwise_4bit(qm.values, qm.scales, shape)

        def qnu(x):
            return QMoment(*quantize_blockwise_4bit_sqrt(x, block)[:2])

        def dqnu(qm, shape):
            return dequantize_blockwise_4bit_sqrt(qm.values, qm.scales,
                                                  shape)
    return qmu, dqmu, qnu, dqnu


class _LowBitOptimizer(torch.optim.Optimizer):
    """Eager state, moments as (codes, scales) pairs, and a state dict
    that keeps the state's dtypes (torch's own ``load_state_dict``
    would cast the fp32 scales to a bf16 parameter's dtype)."""

    def __init__(self, params, defaults, block_size: int, bits: int):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if bits == 4 and block_size % 2:
            raise ValueError(f"4-bit packing needs an even block, "
                             f"got {block_size}")
        self.block_size, self.bits = block_size, bits
        self._qmu, self._dqmu, self._qnu, self._dqnu = _codec(bits,
                                                              block_size)
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self._param_state(p)

    def _init_state(self, p: torch.Tensor) -> Dict[str, Any]:
        grid = shard_grid(p, self.block_size)
        if grid is not None and self.bits != 8:
            raise NotImplementedError(
                "4-bit state of sharded parameters comes with slice 4.3 of "
                "the port")
        shape = (grid.rows * self.block_size,) if grid else p.shape
        device = p.to_local().device if grid else p.device
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        mu, nu = self._qmu(zeros), self._qnu(zeros)
        return {"step": 0, "mu_values": mu.values, "mu_scales": mu.scales,
                "nu_values": nu.values, "nu_scales": nu.scales}

    def _param_state(self, p: torch.Tensor) -> Dict[str, Any]:
        st = self.state[p]
        if not st:
            st.update(self._init_state(p))
        return st

    @staticmethod
    def _moments(st):
        return (QMoment(st["mu_values"], st["mu_scales"]),
                QMoment(st["nu_values"], st["nu_scales"]))

    @staticmethod
    def _grad(p: torch.Tensor) -> torch.Tensor:
        if p.grad.is_sparse:
            raise RuntimeError("low-bit optimizers take no sparse gradients")
        return p.grad.contiguous()

    def load_state_dict(self, state_dict: Dict[str, Any]):
        """Takes a dict from :meth:`state_dict`, or one without
        ``param_groups`` (parameters in this optimizer's order, its own
        hyperparameters kept), as ``utils.convert.qadamw_state_from_jax``
        gives."""
        params = [p for g in self.param_groups for p in g["params"]]
        saved = state_dict.get("param_groups")
        if saved is None:
            id_map = dict(enumerate(params))
        else:
            if len(saved) != len(self.param_groups) or any(
                len(s["params"]) != len(g["params"])
                for s, g in zip(saved, self.param_groups)
            ):
                raise ValueError("saved param_groups do not match the "
                                 "optimizer's")
            id_map = {i: p for s, g in zip(saved, self.param_groups)
                      for i, p in zip(s["params"], g["params"])}
            for s, g in zip(saved, self.param_groups):
                g.update({k: v for k, v in s.items() if k != "params"})
        state = defaultdict(dict)
        for key, st in state_dict["state"].items():
            p = id_map[key]
            state[p] = {
                k: (v.to(p.device, memory_format=torch.contiguous_format,
                         copy=True) if torch.is_tensor(v) else v)
                for k, v in st.items()
            }
            state[p]["step"] = int(state[p]["step"])
            self._check_state(p, state[p])
        self.state = state
        for p in params:
            self._param_state(p)

    def _check_state(self, p, st):
        want = self._init_state_shapes(p)
        for k, (shape, dtype) in want.items():
            v = st.get(k)
            if v is None or tuple(v.shape) != shape or v.dtype != dtype:
                raise ValueError(
                    f"state {k} of a {tuple(p.shape)} parameter should be "
                    f"{dtype} {shape}, got "
                    f"{None if v is None else (v.dtype, tuple(v.shape))}"
                )

    def _init_state_shapes(self, p):
        grid = shard_grid(p, self.block_size)
        rows = grid.rows if grid else -(-p.numel() // self.block_size)
        width = self.block_size if self.bits == 8 else self.block_size // 2
        codes = torch.int8 if self.bits == 8 else torch.uint8
        return {f"{m}_values": ((rows, width), codes) for m in ("mu", "nu")} | {
            f"{m}_scales": ((rows, 1), torch.float32) for m in ("mu", "nu")
        }


class QAdamW(_LowBitOptimizer):
    """AdamW with int8 (fused CUDA step) or int4 (packed nibbles)
    moments; the reference's ``q_adamw``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 block_size: int = DEFAULT_BLOCK, bits: int = 8):
        super().__init__(
            params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay),
            block_size, bits,
        )

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["nu_domain"] = NU_DOMAIN_SQRT_V1
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]):
        domain = state_dict.get("nu_domain")
        if domain != NU_DOMAIN_SQRT_V1:
            raise ValueError(
                f"q-AdamW state with nu_domain {domain!r}, not "
                f"{NU_DOMAIN_SQRT_V1} (sqrt-domain nu): a state without the "
                "tag stores nu linearly; upgrade it with "
                "migrate_qadamw_state_v0"
            )
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            hyper = dict(b1=group["b1"], b2=group["b2"], eps=group["eps"],
                         lr=group["lr"], wd=group["weight_decay"])
            corrections = {}  # step count -> (bc1, bc2)
            leaves, shards = [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._param_state(p)
                st["step"] += 1
                if st["step"] not in corrections:
                    corrections[st["step"]] = bias_corrections(
                        hyper["b1"], hyper["b2"], st["step"])
                bc1, bc2 = corrections[st["step"]]
                grid = shard_grid(p, self.block_size)
                if grid is not None:
                    leaves += self._whole_rows_leaf(p, st, grid, bc1, bc2)
                    if grid.n_split:
                        shards.append((p, st, grid, bc1, bc2))
                elif self.bits == 8:
                    leaves.append(QAdamLeaf(
                        p, self._grad(p), st["mu_values"], st["mu_scales"],
                        st["nu_values"], st["nu_scales"], bc1, bc2))
                else:
                    self._step_4bit(p, self._grad(p), st, bc1, bc2, **hyper)
            split_leaves, own = self._split_row_leaves(shards)
            # the state was built on each parameter's device at init, or
            # loaded there contiguous and checked (load_state_dict)
            fused_qadam_update_multi_(leaves + split_leaves,
                                      state_checked=True, **hyper)
            for dst, src in own:
                dst.copy_(src)
        return loss

    @staticmethod
    def _state_rows(st, rows: slice):
        return (st["mu_values"][rows], st["mu_scales"][rows],
                st["nu_values"][rows], st["nu_scales"][rows])

    def _whole_rows_leaf(self, p, st, grid: ShardGrid, bc1, bc2):
        """The blocks a shard holds whole, as one leaf of views of the
        shard, its gradient and its state rows (no copy: the kernel
        takes storage off 16 bytes element by element)."""
        block = self.block_size
        split = {r for r, _ in grid.split}
        lo = 1 if 0 in split else 0
        hi = grid.rows - 1 if grid.rows - 1 in split else grid.rows
        if hi <= lo:
            return []
        a = _own_span(grid, lo, block)[0]
        b = _own_span(grid, hi - 1, block)[1]
        return [QAdamLeaf(p.to_local().view(-1)[a:b],
                          p.grad.to_local().reshape(-1)[a:b],
                          *self._state_rows(st, slice(lo, hi)), bc1, bc2)]

    def _split_row_leaves(self, shards):
        """One leaf a split row, over the whole global block: each rank
        puts its elements of the parameter and the gradient at their
        columns, and one sum all-reduce a process group gathers every
        split block of it.  Also the (shard elements, new block
        elements) pairs that hand each rank its part of the update."""
        import torch.distributed as dist

        block = self.block_size
        tables: Dict[Any, Tuple[Any, List[torch.Tensor]]] = {}
        for p, _, grid, _, _ in shards:
            local = p.to_local().view(-1)
            grad = p.grad.to_local().reshape(-1)
            part = torch.zeros(grid.n_split, 2, block, dtype=torch.float32,
                               device=local.device)
            for r, i in grid.split:
                a, b, col = _own_span(grid, r, block)
                part[i, 0, col:col + b - a] = local[a:b]
                part[i, 1, col:col + b - a] = grad[a:b]
            tables.setdefault(id(grid.group), (grid.group, []))[1].append(
                part)
        gathered = {}
        for key, (grp, parts) in tables.items():
            gathered[key] = torch.cat(parts)
            dist.all_reduce(gathered[key], group=grp)
        leaves, own, bases = [], [], {}
        for p, st, grid, bc1, bc2 in shards:
            key = id(grid.group)
            base = bases.get(key, 0)
            bases[key] = base + grid.n_split
            local = p.to_local().view(-1)
            for r, i in grid.split:
                n = min(block, p.numel() - (grid.row0 + r) * block)
                whole = gathered[key][base + i, :, :n].to(p.dtype)
                leaves.append(QAdamLeaf(
                    whole[0], whole[1], *self._state_rows(st, slice(r, r + 1)),
                    bc1, bc2))
                a, b, col = _own_span(grid, r, block)
                own.append((local[a:b], whole[0, col:col + b - a]))
        return leaves, own

    def _step_4bit(self, p, g, st, bc1, bc2, *, b1, b2, eps, lr, wd):
        # dequant -> fp32 AdamW -> requant, the reference's op order
        g = g.float()
        bc1, bc2 = device_scalar(bc1, g), device_scalar(bc2, g)
        qm, qn = self._moments(st)
        mu = b1 * self._dqmu(qm, g.shape) + (1 - b1) * g
        nu = b2 * self._dqnu(qn, g.shape) + (1 - b2) * g * g
        upd = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                     + wd * p.float())
        p.add_(upd.to(p.dtype))
        (st["mu_values"], st["mu_scales"]), (st["nu_values"],
                                             st["nu_scales"]) = (
            self._qmu(mu), self._qnu(nu))


class QAGD(_LowBitOptimizer):
    """AGD with int8 or int4 moments (mu signed linear, nu sqrt
    domain); the reference's ``q_agd``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, delta: float = 1e-5, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 block_size: int = DEFAULT_BLOCK, bits: int = 8):
        super().__init__(
            params, dict(lr=lr, b1=b1, b2=b2, delta=delta, eps=eps,
                         weight_decay=weight_decay),
            block_size, bits,
        )

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, self._param_state(p), group)
        return loss

    def _update(self, p, st, group):
        b1, b2 = group["b1"], group["b2"]
        st["step"] += 1
        count = st["step"]
        f32 = np.float32
        bc1, bc2 = bias_corrections(b1, b2, count)
        bc1_old = float(max(f32(1) - np.power(f32(b1), f32(count) - f32(1)),
                            f32(1e-30)))
        sqrt_bc2 = np.sqrt(f32(bc2))
        floor = float(f32(group["delta"]) * sqrt_bc2)
        coef = float(sqrt_bc2 / f32(bc1))
        g = self._grad(p).float()
        qm, qn = self._moments(st)
        m_old = self._dqmu(qm, g.shape)
        m_new = b1 * m_old + (1 - b1) * g
        if count == 1:
            diff = m_new / device_scalar(bc1, g)
        else:
            diff = (m_new / device_scalar(bc1, g)
                    - m_old / device_scalar(bc1_old, g))
        v_new = b2 * self._dqnu(qn, g.shape) + (1 - b2) * diff * diff
        denom = torch.clamp_min(torch.sqrt(v_new), floor) + group["eps"]
        upd = -group["lr"] * (coef * m_new / denom
                              + group["weight_decay"] * p.float())
        p.add_(upd.to(p.dtype))
        (st["mu_values"], st["mu_scales"]), (st["nu_values"],
                                             st["nu_scales"]) = (
            self._qmu(m_new), self._qnu(v_new))


def q_adamw(params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, weight_decay: float = 0.01,
            block_size: int = DEFAULT_BLOCK, bits: int = 8) -> QAdamW:
    return QAdamW(params, lr=lr, b1=b1, b2=b2, eps=eps,
                  weight_decay=weight_decay, block_size=block_size, bits=bits)


def q_agd(params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          delta: float = 1e-5, eps: float = 1e-8, weight_decay: float = 0.0,
          block_size: int = DEFAULT_BLOCK, bits: int = 8) -> QAGD:
    return QAGD(params, lr=lr, b1=b1, b2=b2, delta=delta, eps=eps,
                weight_decay=weight_decay, block_size=block_size, bits=bits)


def migrate_qadamw_state_v0(state_dict: Dict[str, Any],
                            block_size: int = DEFAULT_BLOCK) -> Dict[str, Any]:
    """Upgrade an 8-bit q-AdamW state dict whose nu is stored linearly
    (``value = q * scale``, no ``nu_domain``) to the sqrt-domain layout
    the fused kernel reads: nu is dequantized with the linear codec and
    requantized in the sqrt domain.  Returns a new state dict."""
    inv = reciprocal(127.0)
    state = {}
    for key, st in state_dict["state"].items():
        values, scales = st["nu_values"], st["nu_scales"]
        rows = values.shape[0]
        if values.shape[1] != block_size:
            raise ValueError(f"codes of width {values.shape[1]}, not the "
                             f"block {block_size}")
        lin = dequantize_blockwise(values, scales, (rows, block_size))
        y = torch.sqrt(torch.clamp_min(lin, 0.0))
        s = torch.clamp_min(y.amax(dim=-1, keepdim=True) * inv, SCALE_FLOOR)
        q = torch.clamp(torch.round(y / s), 0, 127).to(torch.int8)
        state[key] = {**st, "nu_values": q, "nu_scales": s}
    return {**state_dict, "state": state, "nu_domain": NU_DOMAIN_SQRT_V1}
