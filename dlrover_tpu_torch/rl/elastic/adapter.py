"""PPO-iteration flash checkpoints: the four-role state rides the flash
engine through the sparse-adapter contract.

Reference: ``dlrover_tpu/rl/elastic/adapter.py``.
:class:`PPOStateAdapter` has the surface
:class:`~dlrover_tpu_torch.checkpoint.engine.CheckpointEngine` asks of a
registered adapter (``export_for_checkpoint`` / ``import_state`` / the
delta-chain and cross-world hooks), so ``Checkpointer.register_sparse``
accepts it and the PPO state nests under the reserved ``__kv__`` key of
every flash snapshot, beside whatever dense state the script saves.

What one snapshot carries:

- both trainable roles' FULL train states (params, optimizer slots,
  step: :func:`~dlrover_tpu_torch.trainer.elastic_trainer.
  train_state_tree`) as host copies, taken when the save is called (the
  next step updates the parameters and slots in place while the async
  writer still reads the snapshot);
- the PPO cursor: rollout leases completed, PPO updates taken and the
  loop's RNG key, the coordinates a replacement needs to resume at the
  last completed rollout lease rather than the iteration's start;
- the partially accumulated rollout buffer (the experience batches of
  the in-flight iteration), so a mid-iteration kill loses at most the
  lease that was being generated, and THAT lease requeues through the
  master and regenerates bit-identically.

The import rebuilds each role in place onto the engine's CURRENT train
state (:func:`~dlrover_tpu_torch.trainer.elastic_trainer.
restore_train_state`: the params copied onto the module's tensors, the
slots through the optimizer), which is also the cross-world path: a
replicated host state lands on whatever layout the new world built.
"""

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import is_dtensor
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.rl.model_engine import ModelRole

ROLES_KEY = "__roles__"
BUFFER_KEY = "__buffer__"
CURSOR_KEY = "__cursor__"


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.full_tensor() if is_dtensor(leaf) else leaf
        return t.detach().to("cpu", copy=True)
    return leaf


class PPOCursor:
    """Where the PPO loop is, in lease coordinates.

    ``leases_done`` counts rollout leases whose batch is IN the buffer
    (or already trained on); ``ppo_updates`` counts completed PPO train
    steps (the trainer's global step); ``rng_key`` is the loop's root
    RNG key as host numpy.  All three ride every flash snapshot and
    come back on restore, so the replacement's first action (skip and
    ack an already-buffered lease, or train on the restored buffer) is
    decided by the cursor, not by guesswork."""

    def __init__(self, leases_done: int = 0, ppo_updates: int = 0,
                 rng_key: Optional[np.ndarray] = None):
        self.leases_done = int(leases_done)
        self.ppo_updates = int(ppo_updates)
        self.rng_key = None if rng_key is None else np.array(rng_key)

    def to_state(self) -> Dict[str, Any]:
        out = {
            "leases_done": int(self.leases_done),
            "ppo_updates": int(self.ppo_updates),
        }
        if self.rng_key is not None:
            out["rng_key"] = np.array(self.rng_key)
        return out

    def load_state(self, state: Dict[str, Any]) -> None:
        self.leases_done = int(np.asarray(state["leases_done"]))
        self.ppo_updates = int(np.asarray(state["ppo_updates"]))
        key = state.get("rng_key")
        self.rng_key = None if key is None else np.array(key)


class PPOStateAdapter:
    """Checkpoint adapter for an :class:`~dlrover_tpu_torch.rl.
    model_engine.RLModelEngine` + replay buffer + :class:`PPOCursor`.

    ``include_roles=True`` (the default) carries the trainable roles'
    train states in the snapshot, whole: right for replicated PPO state
    (the single-worker RL job, or per-rank identical state).  Sharded
    actors should save their train state through the DENSE state dict
    (per-rank shards) and run the adapter with ``include_roles=False``
    so only buffer + cursor ride the ``__kv__`` subtree."""

    def __init__(self, engine, buffer=None, cursor=None,
                 roles=(ModelRole.ACTOR, ModelRole.CRITIC),
                 include_roles: bool = True):
        self._engine = engine
        self._buffer = buffer
        self.cursor = cursor if cursor is not None else PPOCursor()
        self._role_names = tuple(roles)
        self._include_roles = include_roles

    # -- export --------------------------------------------------------------

    def export_state(self) -> Dict[str, Any]:
        """The PPO subtree of one flash snapshot: host leaves only
        (copies, taken now)."""
        from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves
        from dlrover_tpu_torch.trainer.elastic_trainer import (
            train_state_tree,
        )

        out: Dict[str, Any] = {CURSOR_KEY: self.cursor.to_state()}
        if self._include_roles:
            out[ROLES_KEY] = {
                role: map_leaves(
                    lambda _path, leaf: _host_copy(leaf),
                    train_state_tree(self._engine.state(role)))
                for role in self._role_names
            }
        batches: Dict[str, Any] = {}
        for i, batch in enumerate(self._buffer_batches()):
            batches[f"b{i:04d}"] = {k: np.array(v) for k, v in batch.items()}
        if batches:
            out[BUFFER_KEY] = batches
        out[CURSOR_KEY]["buffer_batches"] = len(batches)
        return out

    def _buffer_batches(self) -> List[Dict[str, np.ndarray]]:
        if self._buffer is None:
            return []
        return self._buffer.batches()

    def export_for_checkpoint(
        self, step: Optional[int] = None,
        rank: Optional[int] = None, durable: bool = False,
    ) -> Dict[str, Any]:
        """Engine entry point (the sparse adapter's): every save exports
        the full PPO subtree; there is no delta mode, the state is the
        roles + buffer, and the shm segment must stand alone."""
        return self.export_state()

    # -- import --------------------------------------------------------------

    def import_state(
        self, state: Dict[str, Any], tier: str = "",
        step: Optional[int] = None, rank: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Rebuild engine states, buffer and cursor from a restored
        (plain nested dict) subtree, in place on the engine's current
        train states."""
        from dlrover_tpu_torch.trainer.elastic_trainer import (
            restore_train_state,
        )

        t0 = time.perf_counter()
        roles = state.get(ROLES_KEY)
        restored_roles = 0
        if self._include_roles and roles:
            for role in self._role_names:
                saved = roles.get(role)
                if saved is None:
                    logger.warning(
                        "PPO checkpoint step %s carries no %r role "
                        "state; role left at its fresh init", step, role,
                    )
                    continue
                restore_train_state(self._engine.state(role), saved)
                restored_roles += 1
        rows = 0
        if self._buffer is not None:
            self._buffer.reset()
            from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves

            batches = state.get(BUFFER_KEY) or {}
            for name in sorted(batches):
                # the buffer keeps what it is given, and a restore may
                # hand over views of the shm segment or a rank file's
                # mmap: it gets private copies
                self._buffer.add(map_leaves(
                    lambda _, leaf: (leaf.clone()
                                     if isinstance(leaf, torch.Tensor)
                                     else leaf), batches[name]))
            rows = int(self._buffer.num)
        cursor_state = state.get(CURSOR_KEY)
        if cursor_state:
            want = cursor_state.pop("buffer_batches", None)
            self.cursor.load_state(cursor_state)
            if want is not None and self._buffer is not None:
                got = len(self._buffer.batches())
                if int(np.asarray(want)) != got:
                    raise RuntimeError(
                        f"PPO checkpoint step {step} is torn: cursor "
                        f"says {int(np.asarray(want))} buffered "
                        f"batch(es), snapshot carries {got}"
                    )
        seconds = time.perf_counter() - t0
        logger.info(
            "PPO state restored from %s step %s: %d role(s), %d buffered "
            "sample(s), cursor leases=%d updates=%d (%.3fs)",
            tier or "?", step, restored_roles, rows,
            self.cursor.leases_done, self.cursor.ppo_updates, seconds,
        )
        # lands in stats.extra -> the checkpoint_restore event and the
        # timeline's "+kv" restore stage, as sparse tables do
        return {
            "kv_s": round(seconds, 4),
            "kv_rows": rows,
            "rl_roles": restored_roles,
        }

    # -- delta-chain / cross-world hooks (engine contract) -------------------

    def delta_checkpoints_enabled(self) -> bool:
        return False

    def delta_full_every(self) -> int:
        return 0

    def checkpoint_chain_poison(self) -> None:
        """No delta chain to poison: every export is a full base."""

    def import_chain(
        self, links: List[Dict[str, Any]], tier: str = "",
        step: Optional[int] = None, rank: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Defensive: every PPO export is a full base, so a 'chain'
        restore is just its newest link."""
        return self.import_state(links[-1], tier=tier, step=step, rank=rank)

    def import_shards_streaming(
        self, chains: Dict[int, List[Dict[str, Any]]],
        world_size: int = 1, rank: int = 0, from_world: int = 1,
        tier: str = "storage", step: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Cross-world restore: PPO host state is replicated across
        ranks (unlike kv shards), so any old rank's newest link is the
        whole state: import the lowest present rank's."""
        if not chains:
            raise RuntimeError(
                f"cross-world PPO restore of step {step}: no source "
                "shards readable"
            )
        src = chains[min(chains)]
        info = self.import_state(src[-1], tier=tier, step=step, rank=rank)
        info["rl_from_world"] = int(from_world)
        return info
