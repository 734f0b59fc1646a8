"""RL model engine: per-role models with PER-ROLE strategies.

Reference: ``dlrover_tpu/rl/model_engine.py`` (``ModelEngine``,
``atorch/rl/model_engine/model_engine.py:35``: actor, critic, ref and
reward models, each accelerated with its OWN strategy).  The engine
builds:

- trainable roles (actor, critic): a train step through the port's
  :func:`~dlrover_tpu_torch.accel.auto_accelerate`, each role with an
  explicit :class:`~dlrover_tpu_torch.accel.Strategy` or its own bounded
  strategy SEARCH (``RoleSpec.search=True``, with ``rank_mode`` and
  ``cost_budget``), so the critic can land on another plan than the
  actor.  A role's state is the plan's :class:`TrainState` (its module,
  optimizer and step); the loss is ``loss_fn(module, batch)`` and the
  optimizer ``optim_factory(params)``, the port's ``auto_accelerate``
  contract;
- frozen roles (ref, reward): the role's module run under ``no_grad`` on
  its given ``params`` (a state dict, copied onto the device) or on its
  own weights, optionally under an explicit inference layout
  (``RoleSpec.mesh`` + ``RoleSpec.rules``: a copy of the module with its
  Dense layers tensor-parallel over the mesh, DTensor) instead of
  replicated.

All roles share the process's device (and process group); moving state
between role layouts (refreshing the frozen ref from the actor) is a
copy per parameter, timed per role in :attr:`reshard_stats`.
"""

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.accel import Strategy, auto_accelerate
from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger


class ModelRole:
    ACTOR = "actor"
    CRITIC = "critic"
    REF = "ref"
    REWARD = "reward"

    TRAINABLE = (ACTOR, CRITIC)
    FROZEN = (REF, REWARD)


@dataclass
class RoleSpec:
    model: Any
    loss_fn: Optional[Callable] = None       # trainable roles
    optim_factory: Optional[Callable] = None
    strategy: Optional[Strategy] = None
    params: Any = None                       # frozen roles: given params
    # per-role strategy SEARCH (trainable roles): generate/prune/rank
    # candidates for THIS role's model+loss instead of accepting the
    # declared strategy
    search: bool = False
    rank_mode: str = "cost_model"   # chip-free default for searches
    cost_budget: int = 0
    # frozen roles: explicit inference layout (a Mesh + partition
    # rules); None = the module as it is (replicated)
    mesh: Any = None
    rules: Any = None


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _full(p: torch.Tensor) -> torch.Tensor:
    return (p.full_tensor() if is_dtensor(p) else p).detach()


def _copy_into_layout(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A copy of the whole tensor ``src`` in ``like``'s dtype, device
    and layout (``like`` a DTensor: this rank's box of it, cut locally
    with no collective)."""
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        local = src.to(like.to_local().device, dtype=like.dtype)
        return distribute_tensor(local, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return src.to(like.device, dtype=like.dtype, copy=True)


class RLModelEngine:
    """``sample_batch`` shapes the trainable roles' plans (the strategy
    search dry-runs on it); ``device`` is where every role runs, the
    card unless ``"cpu"`` is passed."""

    def __init__(self, sample_batch, roles: Dict[str, RoleSpec],
                 device=None):
        self._sample_batch = sample_batch
        self._roles = roles
        self.device = resolve_device(device)
        self._accel: Dict[str, Any] = {}
        self._frozen_models: Dict[str, torch.nn.Module] = {}
        self._frozen_params: Dict[str, Optional[Dict[str, torch.Tensor]]] = {}
        self._frozen_sharded = set()
        # per-role layout-transition timings (seconds), e.g. the ref
        # refresh from the actor's train layout
        self.reshard_stats: Dict[str, List[float]] = {}

    def build(self):
        for name, spec in self._roles.items():
            if name in ModelRole.TRAINABLE:
                self._build_trainable(name, spec)
            else:
                self._build_frozen(name, spec)
        return self

    def _build_trainable(self, name: str, spec: RoleSpec):
        if spec.loss_fn is None or spec.optim_factory is None:
            raise ValueError(
                f"trainable role {name} needs loss_fn and optim_factory")
        if spec.search:
            # this role's own bounded search: candidates are generated
            # against ITS model/loss, so the critic (scalar head) may
            # rank another winner than the actor
            self._accel[name] = auto_accelerate(
                spec.model, spec.optim_factory, spec.loss_fn,
                self._sample_batch, strategy=None,
                dry_run_candidates=True, rank_mode=spec.rank_mode,
                cost_budget=spec.cost_budget, device=self.device,
            )
        else:
            self._accel[name] = auto_accelerate(
                spec.model, spec.optim_factory, spec.loss_fn,
                self._sample_batch,
                strategy=spec.strategy or Strategy(
                    opts=[("parallel_mode", {})]),
                dry_run_candidates=False, device=self.device,
            )
        logger.info(
            "built trainable role %s with strategy %s%s", name,
            self._accel[name].strategy.names(),
            " (searched)" if spec.search else "",
        )

    def _build_frozen(self, name: str, spec: RoleSpec):
        model = spec.model
        params = None
        if spec.params is not None:
            params = {k: torch.as_tensor(v).detach().to(self.device,
                                                         copy=True)
                      for k, v in spec.params.items()}
        if spec.mesh is not None:
            # explicit inference layout: a copy of the module whose
            # Dense layers are sliced over the mesh's tensor axis
            from dlrover_tpu_torch.parallel.sharding import (
                apply_tensor_parallel,
                param_placements,
            )

            model = copy.deepcopy(model)
            if params is not None:
                model.load_state_dict(params)
                params = None
            rules = (spec.rules if spec.rules is not None
                     else _default_frozen_rules())
            apply_tensor_parallel(
                model, spec.mesh,
                param_placements(model, spec.mesh.shape, rules))
            self._frozen_sharded.add(name)
        self._frozen_models[name] = model
        self._frozen_params[name] = params

    # -- accessors -----------------------------------------------------------

    def train_step(self, role: str):
        return self._accel[role].train_step

    def state(self, role: str):
        return self._accel[role].state

    def set_state(self, role: str, state):
        self._accel[role].state = state

    def place_batch(self, role: str, batch):
        return self._accel[role].place_batch(batch)

    def infer(self, role: str, inputs):
        """Frozen-role forward (ref logprobs / reward scores), whole on
        every rank (a tensor-sliced head's vocab-sharded logits are
        gathered)."""
        from dlrover_tpu_torch.rl.rollout import _inference_apply

        return _full(_inference_apply(self._frozen_models[role])(
            self._frozen_params[role], inputs))

    def frozen_params(self, role: str) -> Dict[str, torch.Tensor]:
        """The tensors the frozen ``role`` runs on, by name."""
        params = self._frozen_params[role]
        if params is None:
            return dict(self._frozen_models[role].named_parameters())
        return params

    def sync_ref_from_actor(self):
        """Refresh the frozen reference policy from the actor (the
        periodic ref update some RLHF recipes use).  A real device copy,
        not aliasing: the actor's train step updates its parameters in
        place.  Each copy takes the ref's own dtype and layout (a
        tensor-sliced ref takes its box of the actor's whole tensor);
        the transition is timed into :attr:`reshard_stats`."""
        actor = self._accel[ModelRole.ACTOR].state.module
        t0 = time.perf_counter()
        src = {n: _full(p) for n, p in actor.named_parameters()}
        out = {name: _copy_into_layout(src[name], like)
               for name, like in self.frozen_params(ModelRole.REF).items()}
        _sync(self.device)
        self.reshard_stats.setdefault(ModelRole.REF, []).append(
            time.perf_counter() - t0)
        self._frozen_params[ModelRole.REF] = out

    def record_reshard(self, role: str, seconds: float) -> None:
        """External layout transitions (the hybrid rollout engine's
        actor train->rollout copy) report here so the per-role
        accounting is complete."""
        self.reshard_stats.setdefault(role, []).append(seconds)

    def role_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-role strategy + layout + reshard accounting: the
        multi-model ModelEngine contract."""
        report: Dict[str, Dict[str, Any]] = {}
        for name in self._roles:
            entry: Dict[str, Any] = {}
            if name in self._accel:
                entry["kind"] = "trainable"
                entry["strategy"] = self._accel[name].strategy.names()
                entry["searched"] = bool(self._roles[name].search)
            else:
                entry["kind"] = "frozen"
                entry["layout"] = ("sharded" if name in self._frozen_sharded
                                   else "replicated")
            ts = self.reshard_stats.get(name, [])
            entry["reshards"] = len(ts)
            if ts:
                entry["mean_reshard_s"] = round(sum(ts) / len(ts), 4)
            report[name] = entry
        return report


def _default_frozen_rules():
    from dlrover_tpu_torch.parallel.sharding import gpt_tp_rules

    return gpt_tp_rules()
