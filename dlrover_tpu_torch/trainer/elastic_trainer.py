"""Elastic training loop utilities in PyTorch.

Reference: ``dlrover_tpu/trainer/elastic_trainer.py``.  Keeps the
*global* batch size fixed as the world resizes by adjusting gradient
accumulation, counts steps, profiles each step's phases and writes the
runtime-metrics file and the ``train_step``/``step_phases`` events the
agent's collectors read.

Where the reference builds one jitted step that scans the
micro-batches with ``lax.scan``, :func:`make_train_step` here runs a
Python loop of forward/backward passes that accumulate into ``.grad``
and then one ``optimizer.step()``, with loss and gradients averaged
over the micro-batches exactly as the reference averages them.

:func:`init_torch_distributed` is the counterpart of the reference's
``init_jax_distributed``: it forms the ``torch.distributed`` process
group from the agent's env contract.  :func:`train_state_tree` and
:func:`restore_train_state` carry the whole train state (params,
optimizer slots, step) through a checkpoint, as the reference's
``restore_train_state`` does.  The AOT step resolution
(``resolve_train_step``) comes with slice 8 of the port.
"""

import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_REPORTED_STEP = _REG.gauge(
    "dlrover_trainer_reported_step",
    "Latest step the trainer wrote to the agent-tailed metrics file",
)
_GRAD_ACCUM_GAUGE = _REG.gauge(
    "dlrover_trainer_grad_accum",
    "Gradient-accumulation factor keeping the global batch fixed",
)
_STEP_PHASE_SECONDS = _REG.histogram(
    "dlrover_step_phase_seconds",
    "Per-step wall time by phase (data_wait / h2d / compute / "
    "checkpoint / report / other)",
)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, Mapping):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _synchronize(x):
    """Wait for the device work behind ``x`` (a tensor or a
    dict/list of them) when it lives on a CUDA device."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepPhaseProfiler:
    """Always-on phase breakdown of one training step.

    The diagnosis layer tells a *data-starved* trainer (input pipeline
    dominates) from a *slow* one (compute dominates) from a *hung* one
    by real per-phase durations.  Cost per phase is two
    ``perf_counter`` reads and a dict add.

    The canonical phases are ``data_wait``, ``h2d``, ``compute``
    (bracket with :meth:`PhaseHandle.block` so asynchronous CUDA work
    does not leak into the next phase), ``checkpoint`` and ``report``;
    arbitrary names are accepted.  Un-profiled remainder of the step
    lands in ``other``.
    """

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._step_started = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        handle = PhaseHandle()
        try:
            yield handle
        finally:
            if handle.pending is not None:
                _synchronize(handle.pending)
            dt = time.perf_counter() - start
            self._acc[name] = self._acc.get(name, 0.0) + dt

    def add(self, name: str, seconds: float):
        """Record an externally-timed phase."""
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)

    def finish_step(self) -> Dict[str, float]:
        """Close the step: returns ``{phase: seconds, ...,
        "total_s", "other_s"}`` and resets for the next step."""
        now = time.perf_counter()
        total = max(0.0, now - self._step_started)
        phases = {k: round(v, 6) for k, v in self._acc.items()}
        profiled = sum(self._acc.values())
        phases["total_s"] = round(total, 6)
        phases["other_s"] = round(max(0.0, total - profiled), 6)
        self._acc.clear()
        self._step_started = now
        return phases


class PhaseHandle:
    """Yielded by :meth:`StepPhaseProfiler.phase`; ``block(x)`` marks
    ``x`` so the phase ends with a ``torch.cuda.synchronize`` of its
    device, and the recorded duration covers the device work, not just
    the launches."""

    __slots__ = ("pending",)

    def __init__(self):
        self.pending = None

    def block(self, x):
        self.pending = x
        return x


@dataclass
class TrainState:
    """The module, its optimizer and the count of optimizer steps."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, module, optimizer, step: int = 0):
        return cls(module=module, optimizer=optimizer, step=step)


def to_device(batch, device: torch.device):
    """A dict of arrays or tensors (or one of them) on ``device``."""
    if isinstance(batch, Mapping):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=True)


def global_grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of ``grads`` (``optax.global_norm``).  DTensor
    gradients (FSDP2, tensor parallel) are summed per mesh and
    placements and reduced once per group, so a sharded gradient counts
    once."""
    plain = [g for g in grads if not is_dtensor(g)]
    total = (torch.stack([g.float().square().sum() for g in plain]).sum()
             if plain else None)
    groups: Dict[Any, Any] = {}
    for g in grads:
        if is_dtensor(g):
            key = (id(g.device_mesh), tuple(g.placements))
            sq = g.float().square().sum()
            groups[key] = sq if key not in groups else groups[key] + sq
    for sq in groups.values():
        full = sq.full_tensor()
        total = full if total is None else total + full
    return total.sqrt()


def make_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    grad_accum: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    grad_hook: Optional[Callable[[torch.nn.Module], None]] = None,
    backward: bool = True,
):
    """Build the ``(state, batch) -> (state, metrics)`` step.

    ``loss_fn(module, batch) -> scalar``.  ``batch`` is a dict of
    arrays or tensors, moved to ``device`` (the GPU unless ``"cpu"``
    is passed).  With ``grad_accum > 1`` its leading dim must be
    ``grad_accum * micro``: the micro-batches are its consecutive
    slices, their gradients are summed in ``.grad`` and divided by
    ``grad_accum``, and the loss is their mean, as in the reference.
    ``grad_hook(module)``, when given, runs after the backward passes and
    before the gradients are averaged and measured (the data-parallel
    all-reduce of :mod:`dlrover_tpu_torch.accel.accelerate`).  With
    ``backward=False`` the loss function leaves the gradients in
    ``.grad`` itself and returns its loss detached (the 1F1B pipeline,
    whose schedule runs the backward).
    ``metrics`` holds 0-d tensors ``loss`` and ``grad_norm`` (the
    global L2 norm of the averaged gradients, as ``optax.global_norm``).
    """
    device = resolve_device(device)

    def step_fn(state: TrainState, batch):
        batch = to_device(batch, device)
        module = state.module
        module.train()
        optimizer.zero_grad(set_to_none=True)
        micro = {
            k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                         + tuple(v.shape[1:]))
            for k, v in batch.items()
        }
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(grad_accum):
            loss = loss_fn(module, {k: v[i] for k, v in micro.items()})
            if backward:
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        loss = loss_sum / grad_accum
        if grad_hook is not None:
            grad_hook(module)
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        for g in grads:
            g.div_(grad_accum)
        grad_norm = global_grad_norm(grads)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step_fn


class ElasticTrainer:
    """Step/epoch accounting with a fixed global batch across resizes
    (reference: trainer.py GradientState + _ElasticOptimizer)."""

    def __init__(
        self,
        global_batch_size: int,
        micro_batch_size: int,
        dp_size: Optional[int] = None,
        metrics_path: Optional[str] = None,
    ):
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.dp_size = dp_size or env_utils.get_world_size()
        if global_batch_size % (micro_batch_size * self.dp_size):
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"micro {micro_batch_size} x dp {self.dp_size}"
            )
        self.grad_accum = global_batch_size // (
            micro_batch_size * self.dp_size
        )
        self.global_step = 0
        self._metrics_path = metrics_path or os.getenv(
            "DLROVER_METRICS_FILE",
            os.path.join(
                tempfile.gettempdir(), f"dlrover_metrics_{os.getuid()}.json"
            ),
        )
        self._epoch = 0
        self._restart_count = env_utils.get_restart_count()
        self.profiler = StepPhaseProfiler()
        self.last_step_phases: Dict[str, float] = {}
        _GRAD_ACCUM_GAUGE.set(self.grad_accum)
        logger.info(
            "elastic trainer: global_batch=%s micro=%s dp=%s accum=%s",
            global_batch_size, micro_batch_size, self.dp_size,
            self.grad_accum,
        )

    @property
    def local_batch_size(self) -> int:
        """Samples this data-parallel rank consumes per step."""
        return self.micro_batch_size * self.grad_accum

    def profile(self, name: str):
        """``with trainer.profile("data_wait"): batch = next(it)`` —
        see :class:`StepPhaseProfiler`.  For the compute phase,
        ``with trainer.profile("compute") as p: state, m = step(...);
        p.block(m)``."""
        return self.profiler.phase(name)

    def report_step(self, metrics: Optional[Dict[str, Any]] = None):
        """Advance the step counter and write the metrics file the
        agent monitor tails."""
        report_start = time.perf_counter()
        self.global_step += 1
        _REPORTED_STEP.set(self.global_step)
        step_event = {
            "step": self.global_step,
            "restart_count": self._restart_count,
            "node_rank": env_utils.get_node_rank(),
        }
        if metrics and "loss" in metrics:
            try:
                step_event["loss"] = float(metrics["loss"])
            except (TypeError, ValueError):
                pass
        emit_event("train_step", **step_event)
        # chaos hook AFTER the event: a kill rule at step N must leave
        # step N's completion in the log before the process dies; a
        # slow rule stretches the observable step time (straggler)
        _chaos.fire("trainer.step", step=self.global_step)
        self.profiler.add(
            "report", time.perf_counter() - report_start
        )
        phases = self.profiler.finish_step()
        self.last_step_phases = phases
        for name, seconds in phases.items():
            if name == "total_s":
                continue
            _STEP_PHASE_SECONDS.observe(
                seconds,
                phase="other" if name == "other_s" else name,
            )
        emit_event("step_phases", **{
            **phases,
            "step": self.global_step,
            "node_rank": env_utils.get_node_rank(),
        })
        record = {
            "global_step": self.global_step,
            "timestamp": time.time(),
            "epoch": self._epoch,
            "phases": phases,
        }
        if metrics:
            record.update(
                {
                    k: float(v)
                    for k, v in metrics.items()
                    if isinstance(v, (int, float))
                    or getattr(v, "ndim", 1) == 0
                }
            )
        tmp = self._metrics_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self._metrics_path)
        except OSError as e:
            logger.debug("metrics file write failed: %s", e)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def state_dict(self) -> Dict[str, int]:
        return {"global_step": self.global_step, "epoch": self._epoch}

    def load_state_dict(self, state: Dict[str, int]):
        self.global_step = int(state.get("global_step", 0))
        self._epoch = int(state.get("epoch", 0))


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The whole train state as a checkpoint tree, of the state's own
    tensors (no copies): ``{"params", "opt_state", "step"}``, with the
    params under their flax paths
    (:func:`~dlrover_tpu_torch.utils.convert.params_tree`) and each of
    the optimizer's per-parameter slots (Adam's ``exp_avg``,
    ``exp_avg_sq`` and ``step``) nested the same way under its name."""
    from dlrover_tpu_torch.utils.convert import flax_path, _set, params_tree

    names = {id(p): n for n, p in state.module.named_parameters()}
    slots: Dict[str, Any] = {}
    for p, st in state.optimizer.state.items():
        for key, value in st.items():
            _set(slots.setdefault(key, {}), flax_path(names[id(p)]), value)
    return {"params": params_tree(state.module), "opt_state": slots,
            "step": state.step}


def restore_train_state(state: TrainState, restored) -> TrainState:
    """Load a restored :func:`train_state_tree` into ``state`` in
    place: the params are copied onto the module's tensors, the slots
    go through ``optimizer.load_state_dict`` (which places them as the
    optimizer keeps them), and the step comes back.  The optimizer is
    never stepped or re-initialised, as in the reference, where the
    restore supplies params and slots alike."""
    from dlrover_tpu_torch.checkpoint.checkpointer import restore_to_template
    from dlrover_tpu_torch.utils.convert import flax_path, params_tree

    restore_to_template(params_tree(state.module), restored["params"])
    names = {id(p): n for n, p in state.module.named_parameters()}
    order = [p for g in state.optimizer.param_groups for p in g["params"]]
    slots = restored.get("opt_state") or {}
    per_param = {}
    for i, p in enumerate(order):
        st = {}
        for key, tree in slots.items():
            node = tree
            for part in flax_path(names[id(p)]):
                node = node[part]
            st[key] = node
        if st:
            per_param[i] = st
    state.optimizer.load_state_dict({
        "state": per_param,
        "param_groups": state.optimizer.state_dict()["param_groups"],
    })
    state.step = int(restored["step"])
    return state


def init_torch_distributed(
    device: Optional[Union[str, torch.device]] = None,
) -> bool:
    """Form the ``torch.distributed`` process group from the agent's
    env contract (reference: ``init_jax_distributed``, itself the
    analog of ``dist.init_process_group`` with the agent's
    MASTER_ADDR/PORT, training.py:430-447): the coordinator address
    the master's rendezvous handed out, this process's id and the
    number of processes.  ``False`` for one process (no group is
    formed), ``True`` once the group is up: ``nccl`` on the card,
    ``gloo`` when the caller names the CPU.  On the card each process
    takes ``cuda:LOCAL_RANK`` first (one process a GPU), so the port's
    entry points, which run on the current device, use it."""
    coordinator = env_utils.get_coordinator_addr()
    num_processes = int(os.getenv("DLROVER_NUM_PROCESSES", "1"))
    if not coordinator or num_processes <= 1:
        return False
    if device is None and torch.cuda.is_available():
        torch.cuda.set_device(env_utils.get_local_rank())
    device = resolve_device(device)
    process_id = int(os.getenv("DLROVER_PROCESS_ID", "0"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    logger.info(
        "torch.distributed initialized (%s): process %s/%s via %s",
        backend, process_id, num_processes, coordinator,
    )
    return True
