"""Hybrid train/rollout layouts for RLHF (reference:
``dlrover_tpu/rl/hybrid_engine.py``; ``atorch/rl/ds_hybrid_engine/`` +
``atorch/rl/model_engine/model_engine.py:35``).

The hybrid engine keeps the actor in its TRAINING layout (FSDP- or
data-parallel) and copies it into an INFERENCE layout (tensor-sliced,
no optimizer state) for generation: training wants the parameters
scattered to fit optimizer state, autoregressive decode wants them
tensor-sliced so each matmul of the one-token step is wide on every
card.

Where the reference re-tiles each leaf with one ``jax.device_put``, the
port keeps a decode-mode copy of the actor on the rollout mesh (its
Dense layers tensor-parallel under ``gpt_tp_rules``, DTensor, built once)
and every reshard fills fresh tensors in that layout: each train
parameter is gathered whole (``full_tensor()`` of an FSDP2 shard, an
all-gather) and each rank keeps its box of it (``distribute_tensor``
with no source rank, a local cut).  The train state is untouched, and
each swap is timed.  Prompts are split over the rollout mesh's data
ranks when they divide, and the rollouts gathered back whole.
"""

import time
from typing import Any, Dict, List, Optional

import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import (
    PartitionRules,
    apply_tensor_parallel,
    batch_shard,
    gpt_tp_rules,
    param_placements,
    token_shard,
)
from dlrover_tpu_torch.rl.generation import decode_variant
from dlrover_tpu_torch.rl.model_engine import (
    ModelRole,
    RLModelEngine,
    _copy_into_layout,
    _full,
    _sync,
)


class HybridRolloutEngine:
    """Reshard the actor between its train layout and a rollout layout.

    Parameters
    ----------
    engine:
        the built :class:`RLModelEngine` (owns the actor's train state
        in its training layout).
    rollout_mesh:
        the :class:`~dlrover_tpu_torch.parallel.mesh.Mesh` generation
        runs on, over the same ranks as training but with its own axes
        (train data 2 -> rollout tensor 2, train fsdp 4 -> rollout
        tensor 4).
    rollout_rules:
        parameter partition rules for the decode layout; the GPT
        tensor-parallel rules by default (column/row sliced matmuls).
    """

    def __init__(self, engine: RLModelEngine, rollout_mesh,
                 rollout_rules: Optional[PartitionRules] = None):
        self._engine = engine
        self.rollout_mesh = rollout_mesh
        self.rollout_rules = rollout_rules or gpt_tp_rules()
        self.reshard_times: List[float] = []
        self._rollout_model = None
        self._shard = (0, 1)

    @property
    def rollout_model(self):
        """The actor's decode variant in the rollout layout (built at
        first use; its own weights are never read: every generation
        runs on the params of a reshard)."""
        if self._rollout_model is None:
            actor = self._engine.state(ModelRole.ACTOR).module
            model = decode_variant(actor).to_empty(device=self._engine.device)
            mesh = self.rollout_mesh
            if mesh.distributed and mesh.shape["tensor"] > 1:
                apply_tensor_parallel(
                    model, mesh,
                    param_placements(model, mesh.shape, self.rollout_rules))
            self._rollout_model = model
        return self._rollout_model

    def reshard_actor_for_rollout(self) -> Dict[str, torch.Tensor]:
        """Actor train-layout params -> rollout-layout params.

        A COPY in the rollout layout, by name (what
        :func:`~dlrover_tpu_torch.rl.generation.generate` binds), so
        the train state, which the next step updates in place, stays
        untouched; timed to the end of the copies."""
        actor = self._engine.state(ModelRole.ACTOR).module
        targets = dict(self.rollout_model.named_parameters())
        t0 = time.perf_counter()
        out = {name: _copy_into_layout(_full(p), targets[name])
               for name, p in actor.named_parameters()}
        _sync(self._engine.device)
        dt = time.perf_counter() - t0
        self.reshard_times.append(dt)
        # the engine's per-role accounting sees every layout
        # transition, including this external one
        self._engine.record_reshard(ModelRole.ACTOR, dt)
        logger.debug("actor train->rollout reshard: %.4fs", dt)
        return out

    def place_rollout_batch(self, prompts: torch.Tensor) -> torch.Tensor:
        """This rank's prompt rows on the rollout mesh: the batch dim
        over its data x fsdp ranks when the size divides, whole
        otherwise (the reference's fallback)."""
        i, n, _, _ = token_shard(self.rollout_mesh)
        if n > 1 and prompts.shape[0] % n == 0:
            self._shard = (i, n)
            return batch_shard({"p": prompts}, self.rollout_mesh)["p"]
        self._shard = (0, 1)
        return prompts

    def gather_rollout_batch(self, *tensors):
        """The whole batch of each rollout output again (its rows from
        every data rank, in order), after :meth:`place_rollout_batch`
        split the prompts."""
        i, n = self._shard
        if n == 1:
            return tensors
        import torch.distributed as dist

        world = dist.get_world_size()
        index = [None] * world
        dist.all_gather_object(index, i)
        out = []
        for t in tensors:
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous())
            first = {}
            for rank, j in enumerate(index):
                first.setdefault(j, parts[rank])
            out.append(torch.cat([first[j] for j in range(n)]))
        return tuple(out)

    def stats(self) -> Dict[str, Any]:
        ts = self.reshard_times
        return {
            "reshards": len(ts),
            "last_reshard_s": round(ts[-1], 4) if ts else None,
            "mean_reshard_s": (
                round(sum(ts) / len(ts), 4) if ts else None
            ),
        }
