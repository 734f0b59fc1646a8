"""Rollout leases: deterministic batch derivation.

Reference: ``dlrover_tpu/rl/elastic/lease.py``.  A rollout lease is one
master-dispatched shard task (the journaled dispatch/ack/requeue
machinery of :class:`~dlrover_tpu_torch.master.task_manager.
TaskManager`) whose id IS the rollout's identity: prompts and the
generation RNG both derive purely from the lease id, so a lease
requeued off a dead worker and regenerated on its replacement produces
the bit-identical experience batch, exactly-once rollout semantics with
no rollout-side journal.
"""

from typing import Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device


def lease_prompts(
    lease_id: int,
    batch_size: int,
    prompt_len: int,
    vocab_size: int,
    base_seed: int = 20_000,
) -> np.ndarray:
    """The prompt batch of one rollout lease: a pure function of the
    lease id (counter-based PRNG), never of worker identity or restart
    history.  The JAX package's, bit for bit."""
    rng = np.random.default_rng(base_seed + int(lease_id))
    return rng.integers(
        0, vocab_size, (batch_size, prompt_len), dtype=np.int32
    )


def lease_rng(seed: int, lease_id: int, device=None) -> torch.Generator:
    """The generation RNG of one rollout lease: a ``torch.Generator`` on
    ``device`` (the card unless ``"cpu"`` is passed) seeded from
    ``(seed, lease_id)`` alone (the reference folds the lease id into
    the job's key), so it is replayable on any incarnation, independent
    of how many leases this worker saw before."""
    state = np.random.SeedSequence(
        [int(seed), int(lease_id)]).generate_state(1, np.uint32)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(state))


def resolve_role_steps(
    engine,
    batch: Dict,
    roles=None,
    cache_dir: Optional[str] = None,
    label_prefix: str = "rl",
) -> Dict[str, object]:
    """Route the trainable roles' train steps through the AOT step
    cache (:func:`dlrover_tpu_torch.common.aot_cache.resolve_step`) so
    an RL respawn finds its actor/critic steps' kernel libraries loaded
    before their first calls — the same recovery the dense loop gets.

    Returns ``{role: Resolution}``; call ``resolved[role].fn(state,
    placed_batch)`` exactly like ``engine.train_step(role)``.  Each
    role gets its own label (``rl_actor_step`` / ``rl_critic_step``),
    so the warm fast path resolves per role without example builds."""
    from dlrover_tpu_torch.common.aot_cache import resolve_step
    from dlrover_tpu_torch.rl.model_engine import ModelRole

    if roles is None:
        roles = ModelRole.TRAINABLE
    resolved = {}
    for role in roles:
        def example_args(role=role):
            return (
                engine.state(role),
                engine.place_batch(role, batch),
            )

        resolved[role] = resolve_step(
            engine.train_step(role),
            example_args,
            label=f"{label_prefix}_{role}_step",
            cache_dir=cache_dir,
        )
    return resolved
