"""High-level Trainer: the training loop with flash checkpoints,
metrics, phase profiling and loss-spike detection.

Reference: ``dlrover_tpu/trainer/trainer.py`` (``TrainingArguments``,
``Trainer``).  The loop, the checkpoint cadence (a memory save every
``save_steps``, a storage save every ``save_storage_steps``, a final
storage save), the resume (params and the trainer's counters come
back, the optimizer is built fresh), the step histogram, the phase
profile and the loss-spike detection are the reference's; the step is
:func:`dlrover_tpu_torch.trainer.elastic_trainer.make_train_step` on
one GPU.  The params are saved under their flax paths
(:func:`dlrover_tpu_torch.utils.convert.params_tree`), so a checkpoint
of the JAX package's ``Trainer`` resumes this one and the other way
round.  As in the reference, the model is built through
:func:`dlrover_tpu_torch.accel.auto_accelerate` with ``strategy`` and
``dry_run_candidates``; with neither, the plan is plain data
parallelism in the model's own compute dtype (``parallel_mode`` and
``amp_native`` at the config's ``dtype``), which leaves the model as it
is (the reference would take the search's first candidate, whose
``amp_native`` recasts an fp32 model to bf16).  As in the reference,
the plan is built first and the checkpoint restored onto it: the params
come back through ``load_checkpoint(target_state=...)`` onto the built
model's own tensors, so a plan that shards them (DTensors under FSDP2
or tensor parallelism) saves through the sharded checkpoint (each rank
its own shard file) and resumes resharded, at any world size; the MoE
experts of an expert-parallel plan are such DTensors too.
"""

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from dlrover_tpu_torch.accel import OptimizationLibrary, Strategy
from dlrover_tpu_torch.accel.accelerate import auto_accelerate
from dlrover_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event, set_event_source
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainState,
    to_device,
)
from dlrover_tpu_torch.utils.convert import params_tree

_REG = get_registry()
_STEP_SECONDS = _REG.histogram(
    "dlrover_train_step_seconds",
    "Wall time of one (dispatch+sync) training step",
)
_LOSS_GAUGE = _REG.gauge(
    "dlrover_train_loss", "Latest training loss"
)
_LOSS_SPIKE_TOTAL = _REG.counter(
    "dlrover_loss_spike_total", "Loss spikes above the EMA threshold"
)


@dataclass
class TrainingArguments:
    """Reference: ``AtorchArguments`` (atorch/trainer/atorch_args.py)."""

    output_dir: str = "/tmp/dlrover_tpu_out"
    max_steps: int = 100
    global_batch_size: int = 8
    micro_batch_size: int = 8
    learning_rate: float = 1e-3
    logging_steps: int = 10
    save_steps: int = 50
    save_storage_steps: int = 0  # 0 = same as save_steps
    eval_steps: int = 0          # 0 = no periodic eval
    strategy: Optional[Strategy] = None
    dry_run_candidates: bool = False
    resume_from_checkpoint: bool = True
    # loss-spike detection (reference: loss_spike_utils)
    loss_spike_factor: float = 3.0
    loss_ema_beta: float = 0.98


class Trainer:
    """``loss_fn(model, batch) -> scalar``; ``optim_factory(params)
    -> torch.optim.Optimizer`` (default: AdamW with optax's ``adamw``
    defaults, weight decay 1e-4 on every parameter; the low-bit family
    of :mod:`dlrover_tpu_torch.optim` plugs in the same way, e.g.
    ``lambda ps: q_adamw(ps, lr=3e-4, weight_decay=0.1)`` for int8
    AdamW moments).  Runs on ``device``, the GPU unless ``"cpu"`` is
    passed.  After :meth:`train`, ``last_restore_phases`` holds the
    resume's tier and stage times (empty when it started fresh)."""

    def __init__(
        self,
        model: torch.nn.Module,
        args: TrainingArguments,
        train_data: Iterable,
        loss_fn: Callable,
        optim_factory: Optional[Callable] = None,
        eval_data: Optional[Iterable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if args.strategy is not None:
            # an optimization of a later slice raises here, not after
            # the first batch
            OptimizationLibrary().apply_strategy(args.strategy)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.train_data = train_data
        self.eval_data = eval_data
        self.loss_fn = loss_fn
        self.optim_factory = optim_factory or self._default_optim
        self.state: Optional[TrainState] = None
        self.train_step: Optional[Callable] = None
        self._accel = None
        self._checkpointer: Optional[Checkpointer] = None
        self.last_restore_phases: Dict[str, Any] = {}
        self.loss_spikes: List[Dict[str, float]] = []
        self._loss_ema: Optional[float] = None

    @staticmethod
    def default_strategy(model) -> Strategy:
        """Plain data parallelism that leaves the model as it is: a plan
        defaults to bf16 compute, "xla" attention and no remat, so the
        model config's own are named."""
        opts = [("parallel_mode", {})]
        cfg = getattr(model, "config", None)
        if isinstance(getattr(cfg, "dtype", None), torch.dtype):
            opts.append(("amp_native",
                         {"dtype": str(cfg.dtype).removeprefix("torch.")}))
        if getattr(cfg, "attention_impl", "xla") != "xla":
            opts.append(("module_replace",
                         {"attention": cfg.attention_impl}))
        if getattr(cfg, "remat", False):
            opts.append(("offload_activation", {})
                        if getattr(cfg, "remat_policy", "full") == "offload"
                        else ("checkpoint", {}))
        return Strategy(opts=opts)

    def _default_optim(self, params):
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, and a
        # weight decay of 1e-4 on every leaf (torch's default is 1e-2)
        return torch.optim.AdamW(
            params, lr=self.args.learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=1e-4,
        )

    # -- build -------------------------------------------------------------

    def _build(self, start_step: int, sample_batch):
        args = self.args
        grad_accum = (
            max(1, args.global_batch_size // args.micro_batch_size)
            if args.global_batch_size > args.micro_batch_size
            else 1
        )
        strategy = args.strategy
        if strategy is None and not args.dry_run_candidates:
            strategy = self.default_strategy(self.model)
        # the checkpoint is restored onto the built model afterwards; the
        # optimizer stays fresh, as the reference's _try_resume builds it
        self._accel = auto_accelerate(
            self.model, self.optim_factory, self.loss_fn, sample_batch,
            strategy=strategy, dry_run_candidates=args.dry_run_candidates,
            device=self.device, grad_accum=grad_accum,
        )
        self.model = self._accel.model
        self.state = self._accel.state
        self.state.step = start_step
        self.train_step = self._accel.train_step
        self._elastic = ElasticTrainer(
            global_batch_size=args.global_batch_size,
            micro_batch_size=args.micro_batch_size,
            dp_size=1,
        )

    def place_batch(self, batch):
        if self._accel is not None:
            return self._accel.place_batch(batch)
        return to_device(batch, self.device)

    # -- checkpoint --------------------------------------------------------

    def _try_resume(self) -> int:
        """Restore the last checkpoint's params onto the built model's
        own tensors (shm, then storage; resharded onto DTensors); the
        step it was taken at, or 0.  The optimizer stays as built, fresh,
        as the reference's ``_try_resume`` builds it."""
        if not self.args.resume_from_checkpoint:
            return 0
        step, _ = self._checkpointer.load_checkpoint(
            target_state={"params": params_tree(self.model)})
        if step is None:
            return 0
        self.last_restore_phases = self._checkpointer.last_restore_phases
        logger.info("resumed training from step %s", step)
        return int(step)

    def _save(self, step: int, to_storage: bool):
        self._checkpointer.save_checkpoint(
            step,
            {
                "params": params_tree(self.model),
                "trainer": self._elastic.state_dict(),
            },
            storage_type=(
                StorageType.DISK if to_storage else StorageType.MEMORY
            ),
        )

    # -- loss spike --------------------------------------------------------

    def _check_loss_spike(self, step: int, loss: float):
        if self._loss_ema is None:
            self._loss_ema = loss
            return
        if loss > self.args.loss_spike_factor * self._loss_ema:
            logger.warning(
                "loss spike at step %s: %.4f (ema %.4f)",
                step, loss, self._loss_ema,
            )
            self.loss_spikes.append({"step": step, "loss": loss})
            _LOSS_SPIKE_TOTAL.inc()
            emit_event(
                "loss_spike", step=step, loss=loss,
                ema=round(self._loss_ema, 6),
                factor=self.args.loss_spike_factor,
            )
        beta = self.args.loss_ema_beta
        self._loss_ema = beta * self._loss_ema + (1 - beta) * loss

    # -- loops -------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        """Run from the last checkpoint (with ``resume_from_checkpoint``)
        to ``max_steps``; returns ``{"final_loss", "steps", "losses",
        "step_seconds"}`` (plus ``eval_loss`` when evaluating), the last
        two one entry per step taken, and on the card ``peak_bytes``,
        the allocator's peak before the final save adds its snapshot."""
        set_event_source("trainer")
        data_iter = iter(self.train_data)
        batch = next(data_iter)
        self._build(0, batch)
        # a plan whose params are DTensors persists every rank's shard
        sharded = any(is_dtensor(p) for p in self.model.parameters())
        self._checkpointer = Checkpointer(self.args.output_dir,
                                          replicated=not sharded)
        start_step = self._try_resume()
        self.state.step = start_step
        self._elastic.global_step = start_step

        step = start_step
        metrics_out: Dict[str, Any] = {"losses": [], "step_seconds": []}
        loss = float("nan")
        save_storage_steps = (
            self.args.save_storage_steps or self.args.save_steps
        )
        while step < self.args.max_steps:
            step_start = time.perf_counter()
            with self._elastic.profile("h2d"):
                placed = self.place_batch(batch)
            with self._elastic.profile("compute") as phase:
                self.state, metrics = self.train_step(self.state, placed)
                phase.block(metrics)
            step += 1
            loss = float(metrics["loss"])
            step_seconds = time.perf_counter() - step_start
            _STEP_SECONDS.observe(step_seconds)
            _LOSS_GAUGE.set(loss)
            metrics_out["losses"].append(loss)
            metrics_out["step_seconds"].append(step_seconds)
            self._elastic.report_step(metrics)
            self._check_loss_spike(step, loss)
            if step % self.args.logging_steps == 0:
                logger.info(
                    "step %s loss %.4f grad_norm %.3f",
                    step, loss, float(metrics["grad_norm"]),
                )
            with self._elastic.profile("checkpoint"):
                if (self.args.save_steps
                        and step % self.args.save_steps == 0):
                    self._save(step, step % save_storage_steps == 0)
            if self.args.eval_steps and step % self.args.eval_steps == 0:
                metrics_out["eval_loss"] = self.evaluate()
            with self._elastic.profile("data_wait"):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    data_iter = iter(self.train_data)
                    batch = next(data_iter)
        # final storage save; flush in-flight snapshots first so the
        # save cannot be skipped as busy, then flush it too so a
        # process exit right after train() cannot lose it
        self._checkpointer.wait()
        if self.device.type == "cuda":
            metrics_out["peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        self._save(step, True)
        self._checkpointer.wait()
        # the next train() builds its own: end this one's writer thread,
        # which would otherwise keep the engine and its snapshot (on the
        # card) alive after the Trainer is gone; the shm segment stays
        self._checkpointer.close()
        metrics_out.update({"final_loss": loss, "steps": step})
        return metrics_out

    @torch.no_grad()
    def evaluate(self) -> float:
        if self.eval_data is None:
            return float("nan")
        self.model.eval()
        losses = [
            float(self.loss_fn(self.model, self.place_batch(batch)))
            for batch in self.eval_data
        ]
        self.model.train()
        return float(np.mean(losses)) if losses else float("nan")
