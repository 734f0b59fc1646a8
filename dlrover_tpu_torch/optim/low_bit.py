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

Sharded parameters (DTensors of any ``Shard``/``Replicate`` placement,
FSDP2's, tensor parallelism's and both at once, the MoE experts') keep
the reference's *global* block grid: the reference quantizes the whole
tensor flattened in blocks of ``block_size``, so a block's scale is the
absmax over every element of it, whichever ranks hold them.  Two
layouts:

- ``Shard(0)`` over one mesh dim at 8 bits (FSDP2 alone, a row-parallel
  weight; a replicated DTensor as one slice, the whole;
  :class:`ShardGrid`): a rank's shard is one contiguous slice of the
  flattening, and it holds the state rows of the blocks that slice
  touches.  The blocks it holds whole go to the fused kernel as views
  of its shard and state; a block that a shard boundary splits is
  gathered whole on every rank that shares it (one sum all-reduce a
  step over every split block of a process group), and each of those
  ranks steps the whole block from the same state, keeping its own
  elements of the new parameter.
- every other placement, and 4-bit state (:class:`PieceGrid`): the
  shard is cut into pieces, each a run of its flat elements inside one
  global block (a column-parallel shard's rows of ``out / t`` columns
  split blocks between ranks everywhere, so gathering them would gather
  whole matrices).  The codes sit at their element's place in the
  shard and each touched block has one scale row.  A step runs the
  split-block mode of the kernels in two launches: each rank's partial
  absmax of the new moments per block, one max all-reduce a step over
  the mesh dims that shard the parameters (a ``[global blocks, 2]``
  buffer, 8 bytes a block), then each rank encodes its own elements
  with the global scale (``ops.quantization.qadam_split_*``; at 4 bits
  the absmax and quantize launches, with the dequantize launch before
  them).  Codes and scales are the reference's bit for bit; the 4-bit
  nibbles pair the shard's own consecutive elements."""

from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.device import is_dtensor
from dlrover_tpu_torch.ops.quantization import (
    DEFAULT_BLOCK,
    PIECE_DTYPE,
    SCALE_FLOOR,
    PieceLayout,
    absmax_pieces,
    bias_corrections,
    dequantize_pieces,
    dequantize_blockwise,
    dequantize_blockwise_4bit,
    dequantize_blockwise_4bit_sqrt,
    device_scalar,
    QAdamLeaf,
    fused_qadam_update_multi_,
    quantize_blockwise,
    quantize_blockwise_4bit,
    quantize_blockwise_4bit_sqrt,
    quantize_pieces,
    qadam_split_absmax,
    qadam_split_apply,
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


def _sharded_dims(p) -> List[int]:
    """The mesh dims over which a DTensor is sharded; raises for a
    placement that is neither a shard nor a replica (``Partial``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    dims = []
    for i, pl in enumerate(p.placements):
        if isinstance(pl, (Shard, _StridedShard)):
            dims.append(i)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"low-bit state of a parameter placed "
                             f"{p.placements}: {pl} is not a shard")
    return dims


def shard_grid(p, block: int) -> Optional[ShardGrid]:
    """The :class:`ShardGrid` of a DTensor parameter sharded on dim 0
    over one mesh dim, or replicated over every one (its local tensor is
    the whole; None for any other parameter).  Shards follow
    ``torch.chunk`` over dim 0, as DTensor and FSDP2 cut them."""
    if not is_dtensor(p):
        return None
    from torch.distributed.tensor import Shard

    dims = _sharded_dims(p)
    if not dims:
        total = p.numel()
        return ShardGrid(0, total, 0, -(-total // block), (), 0, None)
    if (len(dims) != 1 or type(p.placements[dims[0]]) is not Shard
            or p.placements[dims[0]].dim != 0):
        return None
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


class PieceGrid:
    """Where a rank's shard of a DTensor lies on the global block grid,
    by pieces (runs of its flat elements inside one global block):
    the kernels' :class:`~dlrover_tpu_torch.ops.quantization.PieceLayout`,
    the global block of each state row (``blocks``) and each piece's
    global flat start (``starts``), the tensor's global block count,
    and the process groups of the mesh dims that shard it."""

    def __init__(self, layout: PieceLayout, blocks: np.ndarray,
                 starts: np.ndarray, total_rows: int, groups: tuple):
        self.layout, self.blocks, self.starts = layout, blocks, starts
        self.total_rows, self.groups = total_rows, groups
        self._index: Dict[Any, torch.Tensor] = {}

    @property
    def numel(self) -> int:
        return self.layout.numel

    @property
    def rows(self) -> int:
        return self.layout.rows

    def block_index(self, device) -> torch.Tensor:
        t = self._index.get(device)
        if t is None:
            t = torch.from_numpy(self.blocks).to(device)
            self._index[device] = t
        return t


def _runs(shape, box) -> Tuple[np.ndarray, int]:
    """The local box ``box`` of a row-major tensor of ``shape`` as runs
    contiguous in the global flattening: their global starts, in the
    box's own flat order, and their common length."""
    local = [hi - lo for lo, hi in box]
    strides = [int(np.prod(shape[d + 1:], dtype=np.int64))
               for d in range(len(shape))]
    cut = [d for d in range(len(shape)) if local[d] != shape[d]]
    if not cut:
        return np.zeros(1, np.int64), int(np.prod(local, dtype=np.int64))
    k = cut[-1]
    starts = np.array([box[k][0] * strides[k]], np.int64)
    for d in range(k - 1, -1, -1):
        here = (np.arange(local[d], dtype=np.int64) + box[d][0]) * strides[d]
        starts = np.add.outer(here, starts).reshape(-1)
    return starts, local[k] * strides[k]


def box_pieces(shape, box, block: int):
    """The pieces of the local ``box`` of a tensor of ``shape`` on the
    global grid of ``block``: ``(table, blocks, starts)``, the
    ``PIECE_DTYPE`` table in the box's flat order, the global block of
    each state row and each piece's global flat start."""
    if int(np.prod([hi - lo for lo, hi in box], dtype=np.int64)) == 0:
        return (np.zeros(0, PIECE_DTYPE), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    starts, run = _runs(shape, box)
    b0 = starts // block
    count = (starts + run - 1) // block - b0 + 1
    which = np.repeat(np.arange(len(starts)), count)
    j = np.arange(len(which)) - np.repeat(np.cumsum(count) - count, count)
    blk = b0[which] + j
    g0 = np.maximum(starts[which], blk * block)
    g1 = np.minimum(starts[which] + run, (blk + 1) * block)
    blocks, rows = np.unique(blk, return_inverse=True)
    table = np.zeros(len(blk), PIECE_DTYPE)
    table["start"] = which * run + (g0 - starts[which])
    table["len"] = g1 - g0
    table["row"] = rows
    return table, blocks, g0


def piece_grid(p, block: int) -> PieceGrid:
    """The :class:`PieceGrid` of a DTensor parameter: its local box (as
    the sharded checkpoint reads it) cut by the global blocks."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    dims = _sharded_dims(p)
    shape = tuple(int(d) for d in p.shape)
    lshape, offset = compute_local_shape_and_global_offset(
        p.shape, p.device_mesh, p.placements)
    if tuple(p.to_local().shape) != tuple(int(n) for n in lshape):
        raise ValueError(f"local tensor {tuple(p.to_local().shape)} is not "
                         f"the shard {tuple(lshape)} of {p.placements}")
    box = tuple((int(o), int(o) + int(n)) for o, n in zip(offset, lshape))
    table, blocks, starts = box_pieces(shape, box, block)
    numel = int(np.prod(lshape, dtype=np.int64))
    total = -(-int(np.prod(shape, dtype=np.int64)) // block)
    return PieceGrid(PieceLayout(table, numel, len(blocks)), blocks, starts,
                     total, tuple(p.device_mesh.get_group(d) for d in dims))


def reduce_rows_max(items: List[Tuple[PieceGrid, torch.Tensor]]):
    """Max-reduce each grid's per-row maxima (``[rows, k]``, in place)
    over the ranks that shard its parameter: one all-reduce a mesh dim
    a group of parameters, over a ``[global blocks, k]`` buffer (0 where
    a rank holds nothing of a block, below every absmax)."""
    import torch.distributed as dist

    by_groups: Dict[tuple, list] = {}
    for grid, amax in items:
        groups = tuple(g for g in grid.groups
                       if dist.get_world_size(g) > 1)
        if groups:
            by_groups.setdefault(tuple(id(g) for g in groups),
                                 (groups, []))[1].append((grid, amax))
    for groups, entries in by_groups.values():
        amax0 = entries[0][1]
        buf = torch.zeros(sum(g.total_rows for g, _ in entries),
                          amax0.shape[1], dtype=torch.float32,
                          device=amax0.device)
        index, base = [], 0
        for grid, amax in entries:
            idx = grid.block_index(amax.device) + base
            buf.index_copy_(0, idx, amax)
            index.append(idx)
            base += grid.total_rows
        for group in groups:
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        for (_, amax), idx in zip(entries, index):
            amax.copy_(buf.index_select(0, idx))


def _pack(q: torch.Tensor) -> torch.Tensor:
    """Nibbles ``q`` (values 0..15, flat) two a byte, element ``2i`` low."""
    q = q.to(torch.uint8)
    if q.numel() % 2:
        q = torch.cat([q, q.new_zeros(1)])
    return q[0::2] | (q[1::2] << 4)


def _unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=-1)
    return out.reshape(-1)[:n].to(torch.int8)


def _local_flat(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor, flat, sharing its storage."""
    local = t.to_local()
    if not local.is_contiguous():
        raise ValueError("low-bit state needs contiguous local shards")
    return local.view(-1)


def _adamw_fp32(p, g, mu0, nu0, bc1: float, bc2: float, *, b1, b2, eps,
                lr, wd):
    """The 4-bit step's dequant -> fp32 AdamW, in the reference's order
    of operations: ``p`` updated in place, the new ``(mu, nu)`` returned
    for requantization."""
    g = g.float()
    bc1, bc2 = device_scalar(bc1, g), device_scalar(bc2, g)
    mu = b1 * mu0 + (1 - b1) * g
    nu = b2 * nu0 + (1 - b2) * g * g
    upd = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p.float())
    p.add_(upd.to(p.dtype))
    return mu, nu


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

    # whether Shard(0) parameters take the ShardGrid layout at 8 bits
    # (QAdamW's fused step reads it)
    _shard_rows = False

    def _layout(self, p):
        """None (a plain tensor), a :class:`ShardGrid` or a
        :class:`PieceGrid`, kept for the parameter's life."""
        if not is_dtensor(p):
            return None
        grids = self.__dict__.setdefault("_grids", {})
        grid = grids.get(id(p))
        if grid is None:
            if self._shard_rows and self.bits == 8:
                grid = shard_grid(p, self.block_size)
            if grid is None:
                grid = piece_grid(p, self.block_size)
            grids[id(p)] = grid
        return grid

    def _init_state(self, p: torch.Tensor) -> Dict[str, Any]:
        grid = self._layout(p)
        if isinstance(grid, PieceGrid):
            # the codes of zero moments at every row's floor scale
            device = p.to_local().device
            shapes = self._init_state_shapes(p)
            st = {"step": 0}
            for k, (shape, dtype) in shapes.items():
                fill = SCALE_FLOOR if "scales" in k else (
                    0x77 if (self.bits == 4 and k == "mu_values") else 0)
                st[k] = torch.full(shape, fill, dtype=dtype, device=device)
            return st
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
        grid = self._layout(p)
        codes = torch.int8 if self.bits == 8 else torch.uint8
        if isinstance(grid, PieceGrid):
            n = grid.numel if self.bits == 8 else -(-grid.numel // 2)
            values, rows = (n,), grid.rows
        else:
            rows = grid.rows if grid else -(-p.numel() // self.block_size)
            values = (rows, self.block_size if self.bits == 8
                      else self.block_size // 2)
        return {f"{m}_values": (values, codes) for m in ("mu", "nu")} | {
            f"{m}_scales": ((rows, 1), torch.float32) for m in ("mu", "nu")
        }

    def _piece_moments(self, st, grid: PieceGrid):
        """The dequantized moments of a :class:`PieceGrid` state, flat
        fp32: ``(mu, nu)`` (nu from the sqrt domain)."""
        n, layout = grid.numel, grid.layout
        qm, qn = st["mu_values"], st["nu_values"]
        if self.bits == 4:
            qm, qn = _unpack(qm, n) - 7, _unpack(qn, n)
        mu = dequantize_pieces(qm, st["mu_scales"], layout)
        s = dequantize_pieces(qn, st["nu_scales"], layout)
        return mu, s * s

    def _store_piece_moments(self, st, grid: PieceGrid, mu, nu):
        """Quantize flat fp32 moments into a :class:`PieceGrid` state on
        the global grid: the absmax of each, one max-reduce, the codes."""
        layout = grid.layout
        y = torch.sqrt(torch.clamp_min(nu, 0.0))
        amax = torch.stack([absmax_pieces(mu, layout),
                            absmax_pieces(y, layout)], dim=1)
        reduce_rows_max([(grid, amax)])
        qmax_mu, qmax_nu = (127.0, 127.0) if self.bits == 8 else (7.0, 15.0)
        qm, st["mu_scales"] = quantize_pieces(mu, layout, amax[:, 0],
                                              qmax_mu)
        qn, st["nu_scales"] = quantize_pieces(y, layout, amax[:, 1], qmax_nu)
        if self.bits == 4:
            qm, qn = _pack(qm + 7), _pack(qn)
        st["mu_values"], st["nu_values"] = qm, qn


class QAdamW(_LowBitOptimizer):
    """AdamW with int8 (fused CUDA step) or int4 (packed nibbles)
    moments; the reference's ``q_adamw``."""

    _shard_rows = True

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
            leaves, shards, pieces = [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._param_state(p)
                st["step"] += 1
                if st["step"] not in corrections:
                    corrections[st["step"]] = bias_corrections(
                        hyper["b1"], hyper["b2"], st["step"])
                bc1, bc2 = corrections[st["step"]]
                grid = self._layout(p)
                if isinstance(grid, PieceGrid):
                    if self.bits == 8:
                        pieces.append((p, st, grid, bc1, bc2))
                    else:
                        self._step_4bit_pieces(p, st, grid, bc1, bc2,
                                               **hyper)
                elif grid is not None:
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
            self._step_pieces(pieces, hyper)
        return loss

    @staticmethod
    def _step_pieces(pieces, hyper):
        """The 8-bit split-block step of every :class:`PieceGrid`
        parameter of a group: the first launch of each, one max-reduce
        of all their block maxima, the second launch of each."""
        args, maxima = [], []
        for p, st, grid, bc1, bc2 in pieces:
            a = (_local_flat(p), p.grad.to_local().reshape(-1).contiguous(),
                 st["mu_values"], st["mu_scales"], st["nu_values"],
                 st["nu_scales"], grid.layout)
            args.append(a)
            maxima.append(qadam_split_absmax(*a, bc1, bc2, **hyper))
        reduce_rows_max([(grid, amax) for (_, _, grid, _, _), amax
                         in zip(pieces, maxima)])
        for (_, st, _, bc1, bc2), a, amax in zip(pieces, args, maxima):
            st["mu_scales"], st["nu_scales"] = qadam_split_apply(
                *a, amax, bc1, bc2, **hyper)

    def _step_4bit_pieces(self, p, st, grid, bc1, bc2, **hyper):
        # the 4-bit step of _step_4bit over the shard's own elements
        local = _local_flat(p)
        mu, nu = _adamw_fp32(local, p.grad.to_local().reshape(-1),
                             *self._piece_moments(st, grid), bc1, bc2,
                             **hyper)
        self._store_piece_moments(st, grid, mu, nu)

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

    def _step_4bit(self, p, g, st, bc1, bc2, **hyper):
        qm, qn = self._moments(st)
        mu, nu = _adamw_fp32(p, g, self._dqmu(qm, g.shape),
                             self._dqnu(qn, g.shape), bc1, bc2, **hyper)
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
        grid = self._layout(p)
        if grid is not None:
            target = _local_flat(p)
            g = p.grad.to_local().reshape(-1).float()
            m_old, v_old = self._piece_moments(st, grid)
        else:
            target = p
            g = self._grad(p).float()
            qm, qn = self._moments(st)
            m_old = self._dqmu(qm, g.shape)
            v_old = self._dqnu(qn, g.shape)
        m_new = b1 * m_old + (1 - b1) * g
        if count == 1:
            diff = m_new / device_scalar(bc1, g)
        else:
            diff = (m_new / device_scalar(bc1, g)
                    - m_old / device_scalar(bc1_old, g))
        v_new = b2 * v_old + (1 - b2) * diff * diff
        denom = torch.clamp_min(torch.sqrt(v_new), floor) + group["eps"]
        upd = -group["lr"] * (coef * m_new / denom
                              + group["weight_decay"] * target.float())
        target.add_(upd.to(target.dtype))
        if grid is not None:
            self._store_piece_moments(st, grid, m_new, v_new)
            return
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
