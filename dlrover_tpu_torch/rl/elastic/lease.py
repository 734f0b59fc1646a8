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
from dlrover_tpu_torch.common.slices import SLICE_8_2


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
    """The reference routes the trainable roles' train steps through
    its AOT executable cache so an RL respawn deserializes its compiled
    steps instead of re-tracing them.  The port's step is eager; its
    compiled-step cache comes with slice 8.2."""
    raise NotImplementedError(
        "resolve_role_steps (the AOT-cached actor and critic steps) is "
        f"not ported yet: it comes with {SLICE_8_2}")
