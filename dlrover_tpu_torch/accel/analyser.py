"""Model/job analysis feeding the strategy search.

Reference: ``dlrover_tpu/accel/analyser.py`` (role of ATorch's
``atorch/auto/analyser/``).  The reference reads parameter shapes
from ``jax.eval_shape`` of the model's init; here a model with a
dataclass ``config`` is built again from it on the ``meta`` device (no
memory), and the sample batch's leaves give the batch bytes, size and
sequence length.  ``fits_in_hbm`` and ``comm_cost_s`` are copies.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

import numpy as np
import torch


@dataclass
class AnalysisResult:
    num_params: int = 0
    param_bytes: int = 0
    # adam-family optimizer state is ~2x params in fp32
    opt_state_bytes: int = 0
    batch_bytes: int = 0
    seq_len: int = 0
    batch_size: int = 0
    largest_param: int = 0
    per_device_hbm: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def model_state_bytes(self) -> int:
        return self.param_bytes + self.opt_state_bytes


def _device_hbm(device=None) -> int:
    """The card's memory (``torch.cuda.mem_get_info``); on the CPU the
    reference's planning default of 16 GiB, so both packages prune
    alike in the tests."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return 16 * 1024**3


def batch_leaves(batch) -> List[Any]:
    """A batch's arrays in ``jax.tree_util.tree_leaves`` order (dict
    keys sorted)."""
    if isinstance(batch, Mapping):
        return [x for k in sorted(batch) for x in batch_leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [x for v in batch for x in batch_leaves(v)]
    return [batch]


def meta_model(model):
    """The model rebuilt from its dataclass ``config`` on the ``meta``
    device (shapes and dtypes, no memory), or the model itself when it
    has no such config."""
    cfg = getattr(model, "config", None)
    if cfg is not None and dataclasses.is_dataclass(cfg):
        try:
            return type(model)(cfg, device="meta")
        except TypeError:
            pass
    return model


def analyse(context) -> AnalysisResult:
    """Shape-only analysis (no device memory touched)."""
    params = list(meta_model(context.model).parameters())
    num_params = sum(p.numel() for p in params)
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    largest = max((p.numel() for p in params), default=0)

    leaves = batch_leaves(context.sample_batch)
    batch_bytes = sum(int(getattr(x, "nbytes", 0)) for x in leaves)
    first = leaves[0] if leaves else None
    batch_size = int(first.shape[0]) if first is not None else 0
    seq_len = (int(first.shape[1])
               if first is not None and np.ndim(first) > 1 else 0)

    return AnalysisResult(
        num_params=num_params,
        param_bytes=param_bytes,
        opt_state_bytes=2 * num_params * 4,  # adam mu+nu fp32
        batch_bytes=batch_bytes,
        seq_len=seq_len,
        batch_size=batch_size,
        largest_param=largest,
        per_device_hbm=_device_hbm(getattr(context, "device", None)),
    )


# Planning bandwidths (bytes/s per device), H100 SXM data-sheet classes:
# NVLink 4 inside a node (~450 GB/s each way), 400 Gb/s of network a GPU
# between nodes (~50 GB/s).  Exact numbers matter less than the ~9x gap:
# the model only has to ORDER candidates, and the gap is what makes
# cross-node fsdp/tensor prohibitive.  The names keep the reference's.
ICI_BW = 450e9
DCN_BW = 50e9


def comm_cost_s(
    analysis: AnalysisResult,
    data: int,
    fsdp: int,
    tensor: int,
    num_slices: int = 1,
    grad_accum: int = 1,
    sequence: int = 1,
    expert: int = 1,
) -> float:
    """Per-step collective time (seconds) under the multi-node
    placement rule (``parallel.mesh.DCN_AXES``): ``data`` may span
    nodes, ``fsdp``/``tensor`` stay on NVLink.  Ring-collective model:
    allreduce moves ``2(n-1)/n x bytes``, all-gather/reduce-scatter
    ``(n-1)/n x bytes`` each.  Added on top of ``estimate_plan`` by the
    strategy search, whose count sees no collective."""
    grad_bytes = analysis.param_bytes
    t = 0.0
    if data > 1:
        # gradient allreduce once per optimizer step; crosses nodes
        # when nodes tile the data axis
        bw = DCN_BW if num_slices > 1 else ICI_BW
        t += 2 * (data - 1) / data * grad_bytes / bw / grad_accum
    if fsdp > 1:
        # all-gather params (fwd+bwd) + reduce-scatter grads
        t += 3 * (fsdp - 1) / fsdp * grad_bytes / ICI_BW
    if tensor > 1:
        # activation allreduces: 2 per layer fwd+bwd ~ 4x activation
        # bytes; coarse but orders tp=2 vs tp=8 correctly
        t += 4 * (tensor - 1) / tensor * (
            analysis.batch_bytes * 2.0
        ) / ICI_BW
    if sequence > 1:
        t += 4 * (sequence - 1) / sequence * (
            analysis.batch_bytes * 2.0
        ) / ICI_BW
    if expert > 1:
        t += 4 * (expert - 1) / expert * (
            analysis.batch_bytes * 2.0
        ) / ICI_BW
    return t


def fits_in_hbm(
    analysis: AnalysisResult, fsdp_size: int, tensor_size: int,
    remat: bool, activation_factor: float = 4.0,
    seq_shards: int = 1, expert_shards: int = 1,
    expert_param_fraction: float = 0.5,
    half: bool = False, low_bit_opt: bool = False,
    act_offload: bool = False,
) -> bool:
    """Rough memory feasibility check for a candidate plan (a copy of
    the reference's).  Axis credits: ``seq_shards`` divides
    activations, ``expert_shards`` the expert slice of the state.
    Precision credits: ``half`` stores params + grads in bf16 (2B
    each); ``low_bit_opt`` stores Adam moments blockwise-int8 (~2.3B a
    param with scales, against 8B fp32)."""
    n = analysis.num_params
    param_b = 2 * n if half else analysis.param_bytes
    opt_b = (
        int(2.3 * n) if low_bit_opt else analysis.opt_state_bytes
    )
    grad_b = 2 * n if half else 4 * n
    shard = max(1, fsdp_size * tensor_size)
    state = (param_b + opt_b + grad_b) / shard
    if expert_shards > 1:
        f = expert_param_fraction
        state = state * (1.0 - f + f / expert_shards)
    act = (
        analysis.batch_bytes * activation_factor
        / max(1, seq_shards)
    )
    if act_offload:
        # per-block residual checkpoints live in pinned host memory;
        # the card holds ~one block's working set
        act *= 0.1
    elif remat:
        act *= 0.35
    headroom = 0.9 * analysis.per_device_hbm
    return state + act < headroom
