"""Serving plane: train-to-serve embedding publication.

Copy of ``dlrover_tpu/serving/__init__.py`` (the port imports nothing of the JAX
package).

The reference system exists to power recommendation **serving** —
DLRover/TFPlus ship dirty-row delta checkpoints
(``tfplus/kv_variable/python/training/checkpoint_manager.py:72``)
precisely so a continuously-trained multi-GB embedding table can be
republished to read replicas without full-table stalls.  This package
closes that loop on the sparse-elasticity infrastructure the
checkpoint PRs built:

- :class:`~dlrover_tpu_torch.serving.publisher.EmbeddingPublisher` — the
  trainer-side half.  Publishes **generations** of a
  :class:`~dlrover_tpu_torch.checkpoint.sparse.SparseStateAdapter`'s tables
  through the committed-storage tier: a *base* generation is a full
  snapshot, a *delta* generation carries only the rows touched since
  the previous publish (plus eviction tombstones) — the export stall
  is O(rows touched per interval), never O(table).  Every generation
  commits with the done-file discipline (blobs + manifest, then a
  ``DONE`` marker, then an atomic tracker advance), so a trainer
  killed mid-publish leaves an ignorable partial directory and its
  replacement's next publish is exactly-once at a fresh generation.

- :class:`~dlrover_tpu_torch.serving.replica.ServingReplica` — the
  read-only serving half.  Ingests committed generations
  incrementally (base, then the delta chain) while serving lookup
  traffic through the native host-gather path; per-generation content
  digests (the order-independent additive sums from the sparse
  checkpoint work) are re-computed over what was actually applied and
  must match the manifest, so the event log alone proves the replica
  never served a torn, uncommitted or partially-ingested generation.
  Generation transitions are atomic with respect to lookups (a swap
  lock held for the O(delta) apply), bounding lookup p99 under
  concurrent ingest by the delta size.

- ``python -m dlrover_tpu_torch.serving`` — a standalone replica process:
  polls the serving directory, ingests, and drives seeded lookup
  traffic, emitting ``serving_publish`` / ``serving_ingest`` /
  ``serving_freshness`` / ``serving_lookup_stats`` events plus the
  ``dlrover_serving_*`` metrics the bench and chaos invariants read.

- The **serving fleet** (ROADMAP item 4's routing tier):
  :class:`~dlrover_tpu_torch.serving.pool.ReplicaPool` supervises N replica
  processes over one publisher directory, and
  :class:`~dlrover_tpu_torch.serving.router.LookupRouter`
  (``python -m dlrover_tpu_torch.serving.router``) fronts them — journaled
  membership/drain records (a router respawn replays to the same
  routing table), splitmix64 HRW key-consistent routing with
  least-loaded fallback and optional hedging, the drain protocol that
  makes base re-bases invisible to traffic, and a routed-QPS/
  freshness feed into the Brain datastore for pool sizing.
"""

from dlrover_tpu_torch.serving.publisher import (
    EmbeddingPublisher,
    SERVING_TRACKER,
    committed_generation,
)
from dlrover_tpu_torch.serving.replica import ServingReplica

__all__ = [
    "EmbeddingPublisher",
    "LookupRouter",
    "ReplicaPool",
    "RoutingTable",
    "SERVING_TRACKER",
    "ServingReplica",
    "committed_generation",
]


def __getattr__(name):
    # router/pool import the comm + journal stacks; lazy so plain
    # publisher/replica users never pay for them
    if name in ("LookupRouter", "RoutingTable"):
        from dlrover_tpu_torch.serving import router

        return getattr(router, name)
    if name == "ReplicaPool":
        from dlrover_tpu_torch.serving.pool import ReplicaPool

        return ReplicaPool
    raise AttributeError(name)
