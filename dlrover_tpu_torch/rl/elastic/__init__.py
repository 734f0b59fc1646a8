"""Elastic control plane for the PPO loop (reference:
``dlrover_tpu/rl/elastic/``).

- rollout leases (:mod:`.lease`): rollout batches are master-dispatched
  shard leases; a dead rollout worker's in-flight batch requeues
  through the journaled dispatch/ack machinery and is REGENERATED
  bit-identically (the batch is a pure function of the lease id), so
  exactly-once rollout accounting is decidable from
  ``shard_dispatch``/``shard_ack`` events alone;
- PPO-iteration flash checkpoints (:mod:`.adapter`): the four-role
  state (actor and critic train states, the iteration cursor, the
  partially accumulated rollout buffer) rides the flash engine through
  a :class:`PPOStateAdapter` with the sparse adapter's surface, so a
  mid-iteration kill restores to the last completed rollout lease;
- the AOT-routed role steps (:func:`.lease.resolve_role_steps`) come
  with slice 8.2 of the port and raise naming it.
"""

from dlrover_tpu_torch.rl.elastic.adapter import PPOCursor, PPOStateAdapter
from dlrover_tpu_torch.rl.elastic.lease import (
    lease_prompts,
    lease_rng,
    resolve_role_steps,
)

__all__ = [
    "PPOCursor",
    "PPOStateAdapter",
    "lease_prompts",
    "lease_rng",
    "resolve_role_steps",
]
