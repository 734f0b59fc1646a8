"""Dry runner: profile or cost-estimate a candidate plan.

Reference: ``dlrover_tpu/accel/dry_runner.py`` (role of ATorch's
``atorch/auto/dry_runner/``).  Two tiers:

- :func:`profile_plan` builds the plan's step and times real steps,
  between CUDA events on the card (as ``chip_smoke.median_ms`` times),
  with the peak the allocator saw.  Unlike the reference, which turns
  any exception into a failed candidate, only running out of memory
  fails a candidate here (``torch.OutOfMemoryError``, ``MemoryError``
  on the CPU): a kernel's build or launch error, or any other fault,
  propagates, so it can never hand the choice to another plan
  silently.
- :func:`estimate_plan` is the compile-free tier.  Where the reference
  reads XLA's cost analysis of the compiled step, the port counts the
  step itself: the plan's model is built on the ``meta`` device (no
  memory), one micro-batch's forward and backward runs under a
  dispatch mode that adds up torch's FLOP formulas
  (``torch.utils.flop_counter``) and the bytes each operator reads and
  writes (views excepted), and the optimizer's bytes are counted by
  formula.  The flash kernels do not run on ``meta`` tensors, so
  attention is counted by formula: 4·b·h·s²·d FLOPs forward and 2.5
  times that backward (five products to the forward's two), halved
  when causal, as PERF.md counts MFU.  A roofline
  ``max(flops / peak, bytes / memory rate)`` for the plan's compute
  dtype ranks candidates without touching the card.
"""

import dataclasses
import gc
import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class DryRunResult:
    ok: bool = False
    step_time_s: float = 0.0
    compile_time_s: float = 0.0
    error: str = ""
    device_peak_bytes: int = 0
    # static-cost tier (estimate_plan)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    est_step_time_s: float = 0.0

    @property
    def steps_per_second(self) -> float:
        return 1.0 / self.step_time_s if self.step_time_s else 0.0


def is_oom(err: BaseException) -> bool:
    """Running out of memory: the only fault that fails a candidate."""
    return isinstance(err, (torch.OutOfMemoryError, MemoryError))


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profile_plan(plan, context, profile_steps: int = 3) -> DryRunResult:
    """Build the plan's step on a copy of the model and time
    ``profile_steps`` steps after a first one (the reference's compile
    step: the kernels' first launches, cuBLAS, the allocator)."""
    from dlrover_tpu_torch.accel.accelerate import build_from_plan

    device = resolve_device(context.device)
    cuda = device.type == "cuda"
    _free(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    built = None
    try:
        built = build_from_plan(plan, context, fresh=True)
        batch = built.place_batch(context.sample_batch)
        state, step = built.state, built.train_step
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        compile_time = time.perf_counter() - t0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            state, metrics = step(state, batch)
        if cuda:
            end.record()
            end.synchronize()
            step_time = start.elapsed_time(end) / 1e3 / profile_steps
        else:
            float(metrics["loss"])
            step_time = (time.perf_counter() - t0) / profile_steps
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    except Exception as e:  # noqa: BLE001 - re-raised unless out of memory
        if not is_oom(e):
            raise
        logger.info("plan ran out of memory: %s", e)
        return DryRunResult(ok=False, error=f"out of memory: {e}")
    finally:
        del built
        _free(device)
    return DryRunResult(
        ok=True, step_time_s=step_time, compile_time_s=compile_time,
        device_peak_bytes=peak,
    )


# per-device peaks for the roofline estimate: FLOP/s by compute dtype
# (dense) and memory bytes/s; H100 SXM from its data sheet (fp32 is the
# CUDA cores' FMA rate, TF32 off)
_CHIP_SPECS = {
    "NVIDIA H100": ({"bfloat16": 989e12, "float16": 989e12,
                     "float32": 67e12}, 3.35e12),
    "cpu": ({"bfloat16": 1e11, "float16": 1e11, "float32": 1e11}, 50e9),
}
# host <-> card copies of the offload tiers (pinned, PCIe 5 class)
HOST_LINK_BW = 50e9


def _chip_spec(device) -> tuple:
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key in sorted(_CHIP_SPECS, key=len, reverse=True):
            if name.startswith(key):
                return _CHIP_SPECS[key]
        raise ValueError(
            f"no roofline peaks for {name!r}: add its FLOP/s and memory "
            "rate to dry_runner._CHIP_SPECS")
    return _CHIP_SPECS["cpu"]


_NO_DATA = {
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided, torch.ops.aten.detach,
    torch.ops.aten.alias, torch.ops.aten.lift_fresh,
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Count(TorchDispatchMode):
    """FLOPs (torch's formulas) and bytes read + written of every
    operator that runs under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_DATA:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(_nbytes(t) for t in leaves)
        return out


_ACTIVE: Dict[str, Any] = {}


class _AttentionCost(torch.autograd.Function):
    """Stands in for the flash kernels on ``meta`` tensors and counts
    them by formula; k and v (and dK, dV) at their own size, the kv
    heads' under GQA."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, s, h, d = q.shape
        flops = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
        ctx.flops = flops
        ctx.kv_shape = tuple(k.shape)
        counter = _ACTIVE["count"]
        counter.flops += flops
        counter.bytes += 2 * _nbytes(q) + _nbytes(k) + _nbytes(v) \
            + 4 * b * h * s
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, dout):
        counter = _ACTIVE["count"]
        counter.flops += 2.5 * ctx.flops
        dk = dout.new_empty(ctx.kv_shape)
        # q, o and dO read, dQ written; k and v read, dK and dV written;
        # lse and Delta read
        counter.bytes += 4 * _nbytes(dout) + 4 * _nbytes(dk) \
            + 8 * dout.shape[0] * dout.shape[1] * dout.shape[2]
        return (torch.empty_like(dout), dk, torch.empty_like(dk), None)


def _attention_cost(q, k, v, causal=True, dtype=None, **_):
    out = _AttentionCost.apply(q, k, v, causal)
    return out.to(dtype) if dtype is not None else out


# as the flash kernels: k and v may carry fewer heads than q
_attention_cost.gqa_aware = True


def _meta_batch(batch, rows: int):
    out = {}
    for k, v in batch.items():
        arr = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = torch.empty((rows,) + tuple(arr.shape[1:]),
                             dtype=arr.dtype, device="meta")
    return out


def _optimizer_bytes(plan, params) -> float:
    """Bytes one optimizer step reads and writes: the param and its
    gradient read, the param written, and the moments read and written
    (two fp32 moments; int8 codes with a scale a block when low-bit)."""
    total = 0.0
    for p in params:
        n, size = p.numel(), p.element_size()
        moments = 2 * (n + 4 * n / 2048) if plan.low_bit_opt else 2 * 4 * n
        total += 3 * n * size + 2 * moments
    return total


def count_step(plan, context) -> Dict[str, float]:
    """The plan's whole step on one device set, counted on ``meta``:
    ``{"flops", "bytes", "optimizer_bytes", "host_bytes", "state_bytes"}``
    for the global batch (before any split over devices)."""
    from dlrover_tpu_torch.accel.accelerate import _apply_plan_to_model

    meta_plan = dataclasses.replace(plan, remat_policy="full")
    if plan.sequence_parallel != "none":
        # the whole sequence on one device set: the ring's and Ulysses'
        # attention is the flash kernels' work, counted by formula
        meta_plan = dataclasses.replace(meta_plan, sequence_parallel="none",
                                        attention_impl="flash")
    model = _apply_plan_to_model(meta_plan, context, device="meta")
    for module in model.modules():
        if getattr(module, "_attn", None) is not None and getattr(
                getattr(module, "config", None), "attention_impl",
                "") == "flash":
            module._attn = _attention_cost
    leaves = [v for v in context.sample_batch.values()]
    rows = int(leaves[0].shape[0])
    micro = rows // max(1, plan.grad_accum)
    batch = _meta_batch(context.sample_batch, micro)
    counter = _Count()
    _ACTIVE["count"] = counter
    try:
        with counter:
            loss = context.loss_fn(model, batch)
            loss.backward()
    finally:
        _ACTIVE.pop("count", None)
    params = [p for n, p in model.named_parameters() if "experts_w" not in n]
    experts = [p for n, p in model.named_parameters() if "experts_w" in n]
    host = 0.0
    if plan.remat and plan.remat_policy == "offload":
        # each block's input to the host and back
        cfg = model.config
        host += 2 * cfg.num_layers * micro * next(iter(
            batch.values())).shape[1] * cfg.hidden_dim * torch.tensor(
                [], dtype=cfg.dtype).element_size()
    if plan.offload_opt_state:
        host += 2 * sum(2 * 4 * p.numel() for p in params + experts)

    def state(ps):
        return sum(p.numel() * p.element_size() * 2 for p in ps) + (
            sum(2 * (p.numel() + 4 * p.numel() / 2048) for p in ps)
            if plan.low_bit_opt else sum(8 * p.numel() for p in ps))

    ga = max(1, plan.grad_accum)
    return {"flops": counter.flops * ga, "bytes": counter.bytes * ga,
            "optimizer_bytes": _optimizer_bytes(plan, params),
            "expert_optimizer_bytes": _optimizer_bytes(plan, experts),
            "host_bytes": host * ga, "state_bytes": state(params),
            "expert_state_bytes": state(experts)}


def estimate_plan(plan, context, num_devices: int = 1) -> DryRunResult:
    """Count the plan's step (nothing runs on the card) and rank it by
    a roofline on ``context.device``'s peaks: per device, the FLOPs and
    the activation bytes split over all devices, the optimizer's bytes
    over the ``fsdp`` x ``tensor`` shards (the MoE experts' over
    ``fsdp`` x ``expert``), and the offload tiers' host copies over the
    host link."""
    t0 = time.perf_counter()
    cost = count_step(plan, context)
    sizes = plan.mesh_config.axis_sizes(num_devices)
    shard = sizes["fsdp"] * sizes["tensor"]
    expert_shard = sizes["fsdp"] * sizes["expert"]
    peak_flops, mem_bw = _chip_spec(context.device)
    flops = cost["flops"] / num_devices
    nbytes = (cost["bytes"] / num_devices + cost["optimizer_bytes"] / shard
              + cost["expert_optimizer_bytes"] / expert_shard)
    est = max(flops / peak_flops.get(plan.compute_dtype,
                                     peak_flops["float32"]),
              nbytes / mem_bw) + cost["host_bytes"] / shard / HOST_LINK_BW
    return DryRunResult(
        ok=True, compile_time_s=time.perf_counter() - t0, flops=flops,
        bytes_accessed=nbytes, est_step_time_s=est,
        device_peak_bytes=int(cost["state_bytes"] / shard
                              + cost["expert_state_bytes"] / expert_shard),
    )
