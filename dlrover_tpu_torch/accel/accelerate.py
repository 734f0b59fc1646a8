"""auto_accelerate: strategy -> plan -> a train step on torch.distributed.

Reference: ``dlrover_tpu/accel/accelerate.py`` (``auto_accelerate``,
``build_from_plan``; the role of ATorch's ``auto_accelerate()``,
``atorch/auto/accelerate.py:406``): wrap (model, optimizer, loss,
batch) into a :class:`ModelContext`, load or search a
:class:`Strategy`, apply it, return the accelerated artifacts.

Where the reference jits one step with GSPMD shardings, here a plan
becomes:

- a :class:`~dlrover_tpu_torch.parallel.mesh.Mesh` over the process
  group's ranks (one device each; a world of one with no process group
  shards nothing);
- the model rebuilt with the plan's config knobs (remat and its policy,
  attention impl, compute and param dtypes) when any differs, its
  weights copied, else the model itself; with sequence parallelism the
  attention is the ring or Ulysses over the mesh's ``sequence`` axis
  (the reference's ``accelerate.py:90-96``), and the batch's sequence
  dim is split over it;
- MoE layers gate over the global batch, and their expert kernels
  become DTensors over the ``expert`` and ``tensor`` axes as the plan's
  rules place them (:func:`~dlrover_tpu_torch.parallel.moe.attach_mesh`;
  ``moe_rules``: ``("expert", "fsdp", "tensor")``);
- each parameter's placements from the plan's rules
  (:func:`~dlrover_tpu_torch.parallel.sharding.param_placements`):
  DTensor applies the tensor axis to the Dense layers and splits
  ``wte`` and ``lm_head`` by vocab, FSDP2's ``fully_shard`` applies the
  fsdp axis (HSDP with data);
- ZeRO-1/2 plans (params replicated, optimizer state over fsdp) run
  ``ZeroRedundancyOptimizer``; pure data parallelism all-reduces the
  gradients in the step;
- the optimizer: the user's, or q-AdamW over the plan's parameters
  when the plan is low-bit (``accelerate.py:203`` of the reference),
  wrapped by :func:`dlrover_tpu_torch.optim.offload` for
  ``offload_opt`` (on the CPU it is a no-op, as the reference notes);
- ``pipeline_parallel``: the model through its ``to_pipelined`` hook
  (the reference's ``accelerate.py:180-199``), its blocks stage-stacked
  over the ``pipeline`` axis (``pipeline_rules``; each rank's DTensor
  shard its stage), embed and head replicated; with no process group
  every stage runs in this process (a mesh of pipeline 1, noted in the
  plan).  The ``1f1b`` schedule bypasses the user's loss (the last
  stage fuses next-token CE; the batch carries ``x``/``y``) and refuses
  gradient accumulation, as the reference does (``:281-310``);
- ``fp8``: the MLPs' products in e4m3 on a card with fp8 tensor cores
  (compute capability 8.9 and up) and on the CPU (the plain version,
  as the reference keeps its software path under test); elsewhere the
  reference's degrade to bf16, with its note;
- the step: :func:`~dlrover_tpu_torch.trainer.elastic_trainer.make_train_step`
  with the plan's gradient accumulation, its loss and gradients averaged
  over the ranks that hold distinct tokens (data x fsdp x sequence:
  each rank's loss is the mean over its own tokens, and the parameters
  are replicated over the sequence group).

Every entry point runs on the card unless ``device="cpu"`` is passed.
"""

import copy
import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from dlrover_tpu_torch.accel.model_context import ModelContext
from dlrover_tpu_torch.accel.opt_lib import OptimizationLibrary
from dlrover_tpu_torch.accel.strategy import AccelPlan, Strategy
from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.mesh import Mesh, build_mesh, set_global_mesh
from dlrover_tpu_torch.parallel.moe import attach_mesh
from dlrover_tpu_torch.parallel.sharding import (
    TOKEN_AXES,
    apply_fsdp,
    apply_tensor_parallel,
    batch_shard,
    param_placements,
    shards_over,
)
from dlrover_tpu_torch.trainer.elastic_trainer import (
    TrainState,
    make_train_step,
    to_device,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass
class BuiltPlan:
    mesh: Mesh
    train_step: Callable
    state: TrainState
    plan: AccelPlan
    model: Any
    device: torch.device

    def place_batch(self, batch):
        """This rank's rows of a global batch (split over data x fsdp),
        on the device."""
        return to_device(batch_shard(batch, self.mesh), self.device)


@dataclass
class AccelerateResult:
    train_step: Callable
    state: TrainState
    mesh: Mesh
    plan: AccelPlan
    strategy: Strategy
    model: Any
    place_batch: Callable
    # the search's candidates when the strategy was searched
    search: Any = None


def _note(plan: AccelPlan, note: str):
    if note not in plan.notes:
        plan.notes.append(note)


def _hardware_supports_fp8(device) -> bool:
    """Native fp8 matmul units: a CUDA card of compute capability 8.9
    and up (Ada, Hopper).  The CPU returns True so the plain path stays
    test-covered, as the reference's does."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_capability(device) >= (8, 9)
    return device.type in ("cpu", "meta")


def _apply_plan_to_model(plan: AccelPlan, context: ModelContext,
                         device=None, fresh: bool = False):
    """The model with the plan's config knobs (remat, remat policy,
    attention impl, compute and param dtypes) when it has a dataclass
    config: rebuilt on ``device`` (its own by default) with its weights
    copied (cast to a new param dtype) when a knob differs or ``fresh``
    asks for a copy, else the model itself.  ``device="meta"`` gives
    shapes only (the cost count)."""
    model = context.model
    cfg = getattr(model, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg):
        if device is not None and torch.device(device).type == "meta":
            raise ValueError(f"{type(model).__name__} has no dataclass "
                             "config to count its step on the meta device")
        return copy.deepcopy(model) if fresh else model
    updates: Dict[str, Any] = {}
    if hasattr(cfg, "remat") and plan.remat != cfg.remat:
        updates["remat"] = plan.remat
    if hasattr(cfg, "remat_policy") and plan.remat_policy != cfg.remat_policy:
        updates["remat_policy"] = plan.remat_policy
    attention_impl = plan.attention_impl
    if plan.sequence_parallel == "ring":
        attention_impl = "ring"
    elif plan.sequence_parallel == "ulysses":
        attention_impl = ("ulysses_flash" if plan.attention_impl == "flash"
                          else "ulysses")
    if (hasattr(cfg, "attention_impl")
            and attention_impl != cfg.attention_impl):
        updates["attention_impl"] = attention_impl
    if hasattr(cfg, "dtype") and plan.compute_dtype in _DTYPES:
        if cfg.dtype != _DTYPES[plan.compute_dtype]:
            updates["dtype"] = _DTYPES[plan.compute_dtype]
    if (plan.param_dtype and hasattr(cfg, "param_dtype")
            and plan.param_dtype in _DTYPES
            and cfg.param_dtype != _DTYPES[plan.param_dtype]):
        updates["param_dtype"] = _DTYPES[plan.param_dtype]
    if plan.fp8 and hasattr(cfg, "fp8") and not cfg.fp8:
        if _hardware_supports_fp8(resolve_device(context.device)):
            updates["fp8"] = True
        else:
            logger.warning("fp8: no fp8 matmul units on this card; "
                           "running bf16 instead")
            _note(plan, "fp8 degraded to bf16 (no hw fp8 units)")
    meta = device is not None and torch.device(device).type == "meta"
    if not updates and not fresh and not meta:
        return model
    new = type(model)(dataclasses.replace(cfg, **updates), device="meta")
    if meta:
        return new
    target = device or next(model.parameters()).device
    new = new.to_empty(device=target)
    with torch.no_grad():
        new.load_state_dict(model.state_dict())
    return new


def _token_axes(mesh: Mesh, fsdp: bool):
    """The axes whose ranks hold distinct tokens and whose gradients the
    step averages itself: data x fsdp x sequence, less data and fsdp
    when FSDP2 reduces over them."""
    axes = ("sequence",) if fsdp else TOKEN_AXES
    return [a for a in axes if mesh.shape[a] > 1]


def _grad_allreduce(mesh: Mesh, axes):
    """The gradient average over ``axes`` (a sum over each axis's group,
    divided by their ranks' count): one flattened buffer a dtype, for
    plain, tensor-parallel and FSDP2-sharded (local) gradients alike.
    An expert's gradient is reduced with the rest: the ranks of these
    axes hold the same experts."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    groups = [mesh.group(a) for a in axes]
    n = math.prod(mesh.shape[a] for a in axes)

    def hook(module):
        by_dtype: Dict[torch.dtype, list] = {}
        for p in module.parameters():
            if p.grad is not None:
                g = p.grad
                g = g.to_local() if hasattr(g, "to_local") else g
                by_dtype.setdefault(g.dtype, []).append(g)
        for grads in by_dtype.values():
            flat = _flatten_dense_tensors(grads)
            for group in groups:
                dist.all_reduce(flat, group=group)
            flat.div_(n)
            for g, synced in zip(grads, _unflatten_dense_tensors(flat,
                                                                 grads)):
                g.copy_(synced)

    return hook


def _make_optimizer(plan: AccelPlan, context: ModelContext, params, mesh,
                    zero: bool, device: torch.device):
    if plan.low_bit_opt:
        from dlrover_tpu_torch.optim import q_adamw

        cfg = plan.low_bit_opt_config
        lr = cfg.get("learning_rate", 3e-4)
        if callable(lr):
            raise ValueError("low_bit_opt takes a float learning_rate; "
                             "drive it with a torch LR scheduler")
        # NOTE: this REPLACES the user's optimizer with blockwise
        # low-bit AdamW, as the reference's q_adamw swap does
        logger.warning("low_bit_opt: replacing the user optimizer with "
                       "q_adamw(bits=%d, %s)", plan.low_bit_opt, cfg)

        def factory(ps):
            return q_adamw(ps, lr=float(lr),
                           weight_decay=float(cfg.get("weight_decay", 0.1)),
                           bits=plan.low_bit_opt)
    else:
        factory = context.optimizer
    if zero:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        optimizer = ZeroRedundancyOptimizer(
            params, optimizer_class=lambda groups, **_: factory(groups),
            process_group=mesh.group("fsdp"))
    else:
        optimizer = factory(params)
    if plan.offload_opt_state:
        if device.type == "cpu":
            logger.warning("offload_opt: the CPU is the host; running "
                           "un-offloaded")
            _note(plan, "offload_opt degraded to no-op on cpu")
        else:
            from dlrover_tpu_torch.optim.offload import Offload

            optimizer = Offload(optimizer)
    return optimizer


def build_from_plan(plan: AccelPlan, context: ModelContext,
                    fresh: bool = False) -> BuiltPlan:
    """Materialize a plan: mesh, model, placements, optimizer and step.
    ``fresh`` builds on a copy of the model (the dry runs), leaving the
    caller's weights untouched."""
    import torch.distributed as dist

    device = resolve_device(context.device)
    stages = plan.mesh_config.pipeline
    mesh_config = plan.mesh_config
    if stages > 1 and not (dist.is_available() and dist.is_initialized()):
        # no process group: every stage runs in this process
        mesh_config = dataclasses.replace(mesh_config, pipeline=1)
        _note(plan, f"pipeline x{stages}: every stage in this process")
    mesh = build_mesh(mesh_config, device_type=device.type)
    set_global_mesh(mesh)
    model_plan = plan
    if plan.remat_policy == "offload" and device.type == "cpu":
        # no host to offload to: this build remats plainly, the plan
        # keeps its lever for the card
        logger.warning("offload_activation: the CPU is the host; "
                       "degrading to plain remat on cpu")
        _note(plan, "offload_activation degraded to plain remat on cpu")
        model_plan = dataclasses.replace(plan, remat_policy="full")
    model = _apply_plan_to_model(model_plan, context, fresh=fresh)
    if stages > 1:
        # the block stack goes through the pipeline schedule; the plan's
        # param placement becomes stage-stacked (pipeline axis on the
        # blocks' leading dim, embed/head replicated)
        if not hasattr(model, "to_pipelined"):
            raise ValueError(
                f"{type(model).__name__} has no to_pipelined hook; "
                "pipeline_parallel needs a stage-decomposable model")
        from dlrover_tpu_torch.parallel.sharding import pipeline_rules

        model = model.to_pipelined(stages, plan.pipeline_microbatches)
        if plan.param_rules.rules:
            logger.warning("pipeline_parallel overrides param rules %s with "
                           "stage-stacked placement", plan.param_rules.rules)
        plan.param_rules = pipeline_rules()
        plan.opt_state_rules = None
    use_1f1b = stages > 1 and plan.pipeline_schedule == "1f1b"
    loss_fn = context.loss_fn
    if use_1f1b:
        if not hasattr(model, "loss_and_grads_1f1b"):
            raise ValueError(
                f"{type(model).__name__} has no loss_and_grads_1f1b hook; "
                "the 1f1b schedule needs it (use schedule='gpipe' for "
                "arbitrary models/losses)")
        if plan.grad_accum > 1:
            raise ValueError("grad_accum composes with the gpipe schedule "
                             "only; 1f1b already microbatches inside the "
                             "pipeline")
        logger.warning("pipeline schedule 1f1b: the user loss_fn is "
                       "bypassed — the last stage fuses next-token cross "
                       "entropy")
        _note(plan, "1f1b: user loss_fn bypassed (fused next-token CE)")

        def loss_fn(module, batch):
            return module.loss_and_grads_1f1b(batch["x"], batch["y"])
    placements = param_placements(model, mesh.shape, plan.param_rules)
    attach_mesh(model, mesh, placements)
    opt_placements = param_placements(model, mesh.shape,
                                      plan.effective_opt_rules())
    fsdp = mesh.distributed and shards_over(placements, "fsdp")
    if mesh.distributed and mesh.shape["tensor"] > 1:
        apply_tensor_parallel(model, mesh, placements)
    if fsdp:
        apply_fsdp(model, mesh)
    zero = (mesh.distributed and not fsdp and mesh.shape["fsdp"] > 1
            and shards_over(opt_placements, "fsdp"))
    params = list(model.parameters())
    plain = [p for p in params if not is_dtensor(p)]
    if stages > 1 and len(plain) < len(params):
        # the replicated embed and head and the stage DTensors in groups
        # of their own (the model's order): a foreach step, CUDA's
        # default, takes no mix of plain tensors and DTensors
        params = [{"params": plain},
                  {"params": [p for p in params if is_dtensor(p)]}]
    optimizer = _make_optimizer(plan, context, params, mesh, zero, device)
    # the 1F1B schedule averages its loss and gradients itself
    reduce_axes = (_token_axes(mesh, fsdp)
                   if mesh.distributed and not use_1f1b else [])
    hook = _grad_allreduce(mesh, reduce_axes) if reduce_axes else None
    step_fn = make_train_step(loss_fn, optimizer, plan.grad_accum,
                              device=device, grad_hook=hook,
                              backward=not use_1f1b)
    loss_axes = (_token_axes(mesh, False)
                 if mesh.distributed and not use_1f1b else [])

    def train_step(state, batch):
        state, metrics = step_fn(state, batch)
        if loss_axes:
            import torch.distributed as dist

            loss = metrics["loss"].clone()
            for axis in loss_axes:
                dist.all_reduce(loss, group=mesh.group(axis))
            metrics["loss"] = loss / math.prod(mesh.shape[a]
                                               for a in loss_axes)
        return state, metrics

    return BuiltPlan(mesh=mesh, train_step=train_step,
                     state=TrainState.create(model, optimizer), plan=plan,
                     model=model, device=device)


# ---------------------------------------------------------------------------
# strategy search — see strategy_search.py
# ---------------------------------------------------------------------------


def auto_accelerate(
    model,
    optim_factory: Callable,
    loss_fn: Callable,
    sample_batch,
    strategy: Optional[Strategy] = None,
    load_strategy: Optional[str] = None,
    save_strategy: Optional[str] = None,
    dry_run_candidates: bool = True,
    device=None,
    grad_accum: int = 1,
    extra: Optional[Dict] = None,
    rank_mode: str = "profile",
    profile_top_k: int = 1,
    cost_budget: int = 0,
) -> AccelerateResult:
    """Pick (or load) a strategy and build its train step.

    Semi-auto: pass ``strategy``.  Auto: candidates are generated over
    the process group's world (1 without one), memory-pruned,
    optionally dry-run (``rank_mode``/``profile_top_k``/``cost_budget``
    select the tier, see
    :func:`dlrover_tpu_torch.accel.strategy_search.search_strategy`),
    and the fastest is kept.  ``extra`` feeds ``ModelContext.extra``:
    ``{"search_optimizer": True}`` opts in to the int8-moment optimizer
    swap.  ``model`` is a module holding its weights,
    ``optim_factory(params)`` builds its optimizer and
    ``loss_fn(module, batch)`` its loss.  Runs on ``device``, the card
    unless ``"cpu"`` is passed."""
    import torch.distributed as dist

    device = resolve_device(device)
    context = ModelContext(
        model=model, optim_factory=optim_factory, loss_fn=loss_fn,
        sample_batch=sample_batch, extra=dict(extra or {}), device=device,
    )
    lib = OptimizationLibrary()
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)

    if load_strategy and os.path.exists(load_strategy):
        strategy = Strategy.load(load_strategy)
        logger.info("loaded strategy %s", strategy.names())

    search = None
    if strategy is None:
        from dlrover_tpu_torch.accel.strategy_search import (
            generate_candidates,
            search_strategy,
        )

        if dry_run_candidates:
            search = search_strategy(
                context, world,
                grad_accums=(grad_accum,) if grad_accum > 1 else (1, 2),
                rank_mode=rank_mode, profile_top_k=profile_top_k,
                cost_budget=cost_budget,
            )
            strategy = search.best.strategy
            if grad_accum == 1:
                grad_accum = search.best.grad_accum
        else:
            strategy = generate_candidates(context, world)[0].strategy
        logger.info("selected strategy %s", strategy.names())

    if save_strategy:
        strategy.save(save_strategy)

    plan = lib.apply_strategy(strategy, context)
    plan.grad_accum = grad_accum
    built = build_from_plan(plan, context)
    return AccelerateResult(
        train_step=built.train_step, state=built.state, mesh=built.mesh,
        plan=plan, strategy=strategy, model=built.model,
        place_batch=built.place_batch, search=search,
    )
