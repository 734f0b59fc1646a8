"""High-level Trainer: the training loop with metrics, phase profiling
and loss-spike detection.

Reference: ``dlrover_tpu/trainer/trainer.py`` (``TrainingArguments``,
``Trainer``).  The loop, the step histogram, the phase profile and the
loss-spike detection are the reference's; the step is
:func:`dlrover_tpu_torch.trainer.elastic_trainer.make_train_step` on
one GPU.  Two options of the reference belong to later slices of the
port and raise ``NotImplementedError`` until then: ``strategy``
(``auto_accelerate``, slice 4) and the flash checkpoint
(``save_steps``/``resume_from_checkpoint``, slice 3).  The port
saves no checkpoint yet.
"""

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event, set_event_source
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainState,
    make_train_step,
    to_device,
)

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
    """Reference: ``AtorchArguments`` (atorch/trainer/atorch_args.py).

    ``save_steps`` defaults to 0 here and ``resume_from_checkpoint``
    to False: the flash checkpoint comes with slice 3 of the port,
    and with it the reference's ``output_dir`` and
    ``save_storage_steps``; ``dry_run_candidates`` comes with
    ``strategy`` in slice 4.
    """

    max_steps: int = 100
    global_batch_size: int = 8
    micro_batch_size: int = 8
    learning_rate: float = 1e-3
    logging_steps: int = 10
    save_steps: int = 0
    eval_steps: int = 0          # 0 = no periodic eval
    strategy: Optional[Any] = None
    resume_from_checkpoint: bool = False
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
    passed."""

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
            raise NotImplementedError(
                "TrainingArguments.strategy needs auto_accelerate, which "
                "comes with slice 4 of the port (scale-out)"
            )
        if args.save_steps or args.resume_from_checkpoint:
            raise NotImplementedError(
                "save_steps/resume_from_checkpoint need the flash "
                "checkpoint, which comes with slice 3 of the port"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.train_data = train_data
        self.eval_data = eval_data
        self.loss_fn = loss_fn
        self.optim_factory = optim_factory or self._default_optim
        self.state: Optional[TrainState] = None
        self.train_step: Optional[Callable] = None
        self.loss_spikes: List[Dict[str, float]] = []
        self._loss_ema: Optional[float] = None

    def _default_optim(self, params):
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, and a
        # weight decay of 1e-4 on every leaf (torch's default is 1e-2)
        return torch.optim.AdamW(
            params, lr=self.args.learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=1e-4,
        )

    # -- build -------------------------------------------------------------

    def _build(self):
        args = self.args
        grad_accum = (
            max(1, args.global_batch_size // args.micro_batch_size)
            if args.global_batch_size > args.micro_batch_size
            else 1
        )
        optimizer = self.optim_factory(self.model.parameters())
        self.state = TrainState.create(self.model, optimizer)
        self.train_step = make_train_step(
            self.loss_fn, optimizer, grad_accum, device=self.device
        )
        self._elastic = ElasticTrainer(
            global_batch_size=args.global_batch_size,
            micro_batch_size=args.micro_batch_size,
            dp_size=1,
        )

    def place_batch(self, batch):
        return to_device(batch, self.device)

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
        """Run to ``max_steps``; returns ``{"final_loss", "steps",
        "losses", "step_seconds"}`` (plus ``eval_loss`` when
        evaluating), the last two one entry per step."""
        set_event_source("trainer")
        data_iter = iter(self.train_data)
        batch = next(data_iter)
        self._build()

        step = 0
        metrics_out: Dict[str, Any] = {"losses": [], "step_seconds": []}
        loss = float("nan")
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
            if self.args.eval_steps and step % self.args.eval_steps == 0:
                metrics_out["eval_loss"] = self.evaluate()
            with self._elastic.profile("data_wait"):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    data_iter = iter(self.train_data)
                    batch = next(data_iter)
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
