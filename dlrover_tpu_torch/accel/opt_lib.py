"""Optimization library: named methods that transform an AccelPlan.

Copy of ``dlrover_tpu/accel/opt_lib.py``: every optimization keeps its
name and edits the plan as the reference's does; the plan is then
materialised on ``torch.distributed`` by
:mod:`dlrover_tpu_torch.accel.accelerate`.  ``module_replace`` selects
the CUDA flash kernels, which the strategy search adds when the job runs
on the card; ``fp8`` runs the MLPs' products through
:mod:`dlrover_tpu_torch.ops.fp8`; ``pipeline_parallel`` stage-stacks the
blocks over the ``pipeline`` axis (GPipe or 1F1B,
:mod:`dlrover_tpu_torch.parallel.pipeline`).
Reference of that file: ``OptimizationLibrary`` with 15 registered methods
(``atorch/auto/opt_lib/optimization_library.py:18``; zero1/zero2/fsdp/
parallel_mode/amp_native/tensor_parallel/module_replace/checkpoint/
pipeline_parallel/mixed_parallel/sequence_parallel/half/...).  Each
method here *edits the plan*: mesh axis sizes, partition rules,
remat, dtype, attention impl; ``build_from_plan`` wraps the module.
"""

from typing import Any, Dict

from dlrover_tpu_torch.accel.strategy import AccelPlan
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import fsdp_rules


class Optimization:
    name = "base"
    # mirrors the reference's SEMIAUTO_STRATEGIES: these need a config
    # (axis size etc.) rather than being freely combinable
    semiauto = False

    def apply(self, plan: AccelPlan, config: Dict[str, Any],
              context=None) -> AccelPlan:
        raise NotImplementedError


class ParallelModeOpt(Optimization):
    """Pure data parallelism (torch DDP parity)."""

    name = "parallel_mode"

    def apply(self, plan, config, context=None):
        plan.notes.append("data-parallel over the 'data' mesh axis")
        return plan


class Zero1Opt(Optimization):
    """Optimizer-state sharding, params replicated (ZeRO-1/2 parity:
    reference zero_optimization.py:115,158).  Both shard the optimizer
    state over the fsdp axis; ``build_from_plan`` runs them as
    replicated params with all-reduced gradients and
    ``ZeroRedundancyOptimizer``."""

    name = "zero1"

    def apply(self, plan, config, context=None):
        size = int(config.get("size", 0)) or None
        if size:
            plan.mesh_config.fsdp = size
        elif plan.mesh_config.fsdp == 1:
            plan.mesh_config.fsdp = -1  # absorb remaining devices
            plan.mesh_config.data = 1
        plan.opt_state_rules = fsdp_rules()
        plan.notes.append("optimizer state sharded over 'fsdp'")
        return plan


class Zero2Opt(Zero1Opt):
    name = "zero2"


class FSDPOpt(Optimization):
    """Parameter + optimizer-state sharding (ZeRO-3 / torch FSDP
    parity: zero_optimization.py:240)."""

    name = "fsdp"

    def apply(self, plan, config, context=None):
        size = int(config.get("size", 0)) or None
        if size:
            plan.mesh_config.fsdp = size
        elif plan.mesh_config.fsdp == 1:
            plan.mesh_config.fsdp = -1
            plan.mesh_config.data = 1
        plan.param_rules = fsdp_rules()
        plan.opt_state_rules = None  # follow params
        plan.notes.append("params+opt state sharded over 'fsdp'")
        return plan


class TensorParallelOpt(Optimization):
    """Megatron-style TP via partition rules (reference:
    tensor_parallel_optimization.py + distributed_modules/layers)."""

    name = "tensor_parallel"
    semiauto = True

    def apply(self, plan, config, context=None):
        from dlrover_tpu_torch.parallel.registry import rules_for_model

        plan.mesh_config.tensor = int(config.get("size", 2))
        plan.param_rules = rules_for_model(
            getattr(context, "model", None), use_moe=False
        )
        plan.notes.append(
            f"tensor parallel x{plan.mesh_config.tensor}"
        )
        return plan


class SequenceParallelOpt(Optimization):
    """Ulysses SP / ring CP over the 'sequence' axis (reference:
    sequence_parallel_optimization.py; ring is the TPU package's
    extension).  ``build_from_plan`` rebuilds the model with the ring or
    Ulysses attention and splits the batch's sequence dim."""

    name = "sequence_parallel"
    semiauto = True

    def apply(self, plan, config, context=None):
        plan.mesh_config.sequence = int(config.get("size", 2))
        plan.sequence_parallel = config.get("mode", "ulysses")
        plan.notes.append(
            f"sequence parallel ({plan.sequence_parallel}) "
            f"x{plan.mesh_config.sequence}"
        )
        return plan


class ExpertParallelOpt(Optimization):
    """MoE expert parallelism (reference: moe_layer.py)."""

    name = "expert_parallel"
    semiauto = True

    def apply(self, plan, config, context=None):
        from dlrover_tpu_torch.parallel.registry import rules_for_model

        plan.mesh_config.expert = int(config.get("size", 2))
        plan.param_rules = rules_for_model(
            getattr(context, "model", None), use_moe=True
        )
        plan.notes.append(
            f"expert parallel x{plan.mesh_config.expert}"
        )
        return plan


class MixedParallelOpt(Optimization):
    """TP x FSDP x DP in one mesh (reference:
    mixed_parallel_optimization.py:32)."""

    name = "mixed_parallel"
    semiauto = True

    def apply(self, plan, config, context=None):
        from dlrover_tpu_torch.parallel.registry import rules_for_model

        mc = plan.mesh_config
        mc.tensor = int(config.get("tensor", 1))
        mc.fsdp = int(config.get("fsdp", 1))
        mc.sequence = int(config.get("sequence", 1))
        mc.expert = int(config.get("expert", 1))
        mc.data = int(config.get("data", -1))
        # multi-node: the node count, which data/pipeline must absorb
        # (parallel.mesh.DCN_AXES)
        mc.num_slices = int(config.get("num_slices", 0))
        plan.param_rules = rules_for_model(
            getattr(context, "model", None),
            use_moe=True if mc.expert > 1 else None,
        )
        plan.notes.append(f"mixed parallel {mc}")
        return plan


class AmpNativeOpt(Optimization):
    """bf16 compute policy (reference amp_optimization.py; bf16 needs
    no grad scaler)."""

    name = "amp_native"

    def apply(self, plan, config, context=None):
        plan.compute_dtype = config.get("dtype", "bfloat16")
        plan.notes.append(f"compute dtype {plan.compute_dtype}")
        return plan


class HalfOpt(AmpNativeOpt):
    """Half STORAGE: params kept in bf16 as well as compute
    (reference half_optimization converts module weights; amp_native
    is compute-only).  Halves parameter memory."""

    name = "half"

    def apply(self, plan, config, context=None):
        plan = super().apply(plan, config, context)
        plan.param_dtype = config.get("param_dtype", "bfloat16")
        plan.notes.append(f"param dtype {plan.param_dtype}")
        return plan


class LowBitOptimizerOpt(Optimization):
    """Blockwise low-bit AdamW moments (int8 through the fused CUDA
    step, or int4 packed) replacing the user optimizer — the optimizer family
    as a searchable dimension, like the reference's
    ``q_adamw/q_adafactor`` (atorch/optimizers/low_bit/).  4x (8x)
    less optimizer memory than fp32 Adam."""

    name = "low_bit_opt"

    def apply(self, plan, config, context=None):
        plan.low_bit_opt = int(config.get("bits", 8))
        # the user can carry their own hyperparams into the swapped
        # optimizer (learning_rate accepts an optax schedule callable,
        # so an existing warmup/cosine schedule survives the swap)
        user_hp = dict(
            getattr(context, "extra", {}).get(
                "optimizer_hyperparams", {}
            )
        ) if context is not None else {}
        lr = user_hp.get(
            "learning_rate", config.get("learning_rate", 3e-4)
        )
        plan.low_bit_opt_config = {
            "learning_rate": lr if callable(lr) else float(lr),
            "weight_decay": float(
                user_hp.get(
                    "weight_decay", config.get("weight_decay", 0.1)
                )
            ),
        }
        plan.notes.append(
            f"int{plan.low_bit_opt} optimizer moments (q_adamw)"
        )
        return plan


class Fp8Opt(Optimization):
    """FP8 (e4m3, dynamic scaling) matmuls where the model supports it
    (reference: Fp8Optimization + TransformerEngine patching; here
    :mod:`dlrover_tpu_torch.ops.fp8`, ``torch._scaled_mm`` on the card).
    ``build_from_plan`` degrades it to bf16 on a card without fp8
    tensor cores (compute capability below 8.9)."""

    name = "fp8"

    def apply(self, plan, config, context=None):
        plan.fp8 = True
        plan.notes.append("fp8 (e4m3) matmuls")
        return plan


class CheckpointOpt(Optimization):
    """Activation rematerialization (reference:
    checkpoint_optimization.py -> torch.utils.checkpoint per block).
    A model built with GPT's ``save_attn`` policy keeps it: that policy
    is remat per block too, and only the model config chooses it."""

    name = "checkpoint"

    def apply(self, plan, config, context=None):
        plan.remat = True
        cfg = getattr(getattr(context, "model", None), "config", None)
        if getattr(cfg, "remat_policy", None) == "save_attn":
            plan.remat_policy = "save_attn"
        plan.notes.append("activation remat per block" + (
            f" ({plan.remat_policy})" if plan.remat_policy != "full" else ""))
        return plan


class SelectiveOffloadCheckpointOpt(Optimization):
    """Selective offloading activation checkpoint (reference:
    auto/opt_lib/selective_offloading_checkpoint.py:1): remat whose
    per-block residual checkpoints live in pinned host memory between
    forward and backward instead of on the card
    (``torch.autograd.graph.save_on_cpu``) — activation memory drops to
    ~one block's working set at the price of D2H/H2D copies.  On the
    CPU there is no host to offload to: build_from_plan runs plain
    remat there."""

    name = "offload_activation"

    def apply(self, plan, config, context=None):
        plan.remat = True
        plan.remat_policy = "offload"
        plan.notes.append(
            "activation remat with pinned_host checkpoint offload"
        )
        return plan


class ModuleReplaceOpt(Optimization):
    """Kernel swap-in: flash attention (reference:
    module_replace_optimization.py swapping HF attention for
    FlashAttnModule)."""

    name = "module_replace"

    def apply(self, plan, config, context=None):
        plan.attention_impl = config.get("attention", "flash")
        plan.notes.append(f"attention impl {plan.attention_impl}")
        return plan


class PipelineParallelOpt(Optimization):
    """Pipeline stages over the 'pipeline' axis: build_from_plan
    routes block stacks through the model's ``to_pipelined`` hook
    (reference: pipeline_parallel_optimization.py:56).

    ``schedule="gpipe"`` (default) runs the forward pipeline under
    autograd — any model/loss.  ``schedule="1f1b"`` runs the
    interleaved schedule (O(stages) activation stash) via the model's
    ``loss_and_grads_1f1b`` hook, which fuses next-token CE at the last
    stage — the user loss_fn is bypassed and the batch must carry
    ``x``/``y`` token arrays."""

    name = "pipeline_parallel"
    semiauto = True

    def apply(self, plan, config, context=None):
        plan.mesh_config.pipeline = int(config.get("size", 2))
        plan.pipeline_microbatches = int(config.get("microbatches", 4))
        plan.pipeline_schedule = str(config.get("schedule", "gpipe"))
        if plan.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"unknown pipeline schedule "
                f"{plan.pipeline_schedule!r} (gpipe | 1f1b)"
            )
        plan.notes.append(
            f"pipeline x{plan.mesh_config.pipeline} "
            f"({plan.pipeline_schedule} schedule, "
            f"{plan.pipeline_microbatches} microbatches)"
        )
        return plan


class OffloadOptStateOpt(Optimization):
    """Host-offloaded optimizer states (reference: adam_offload.py
    PartitionAdam).  ``build_from_plan`` wraps the optimizer in
    :func:`dlrover_tpu_torch.optim.offload`: the moments live in
    pinned host memory and stream host->card->host chunk by chunk
    around the update on a side stream."""

    name = "offload_opt"

    def apply(self, plan, config, context=None):
        plan.offload_opt_state = True
        plan.notes.append("optimizer states host-offloaded")
        return plan


class OptimizationLibrary:
    """Name -> Optimization registry (reference:
    optimization_library.py:18,40)."""

    def __init__(self):
        self._opts: Dict[str, Optimization] = {}
        for cls in (
            ParallelModeOpt, Zero1Opt, Zero2Opt, FSDPOpt,
            TensorParallelOpt, SequenceParallelOpt, ExpertParallelOpt,
            MixedParallelOpt, AmpNativeOpt, HalfOpt, Fp8Opt,
            CheckpointOpt, SelectiveOffloadCheckpointOpt,
            ModuleReplaceOpt, PipelineParallelOpt,
            OffloadOptStateOpt, LowBitOptimizerOpt,
        ):
            self.register(cls())

    def register(self, opt: Optimization):
        self._opts[opt.name] = opt

    def __contains__(self, name: str) -> bool:
        return name in self._opts

    def __getitem__(self, name: str) -> Optimization:
        return self._opts[name]

    def names(self):
        return sorted(self._opts)

    def apply_strategy(self, strategy, context=None) -> AccelPlan:
        plan = AccelPlan()
        for name, config in strategy.opts:
            if name not in self._opts:
                logger.warning("unknown optimization %s; skipping", name)
                continue
            plan = self._opts[name].apply(plan, config or {}, context)
        return plan
