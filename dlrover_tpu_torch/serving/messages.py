"""Serving-fleet message schema (router <-> replicas <-> load).

Copy of ``dlrover_tpu/serving/messages.py`` (the port imports nothing of the JAX
package).

Same shape as the control plane's :mod:`dlrover_tpu_torch.common.messages`:
typed ``@dataclass`` payloads dispatched by class over the socket
transport's two verbs — ``report`` (fire-and-ack: replica heartbeats)
and ``get`` (request/response: lookups, drain grants, table reads).
Living under ``dlrover_tpu_torch.*`` keeps them inside the transport's
restricted-unpickler allowlist.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common.messages import Message


@dataclass
class ReplicaStatus(Message):
    """Heartbeat-style status report a replica pushes to the router
    every ``--heartbeat`` seconds AND immediately after a generation
    apply (so admission at a new base is prompt, not poll-bound)."""

    replica_id: int = -1
    addr: str = ""
    generation: int = -1
    draining: bool = False
    respawned: bool = False
    lookups: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    qps: float = 0.0


@dataclass
class DrainRequest(Message):
    """Replica asks to leave rotation before applying a base
    generation (the re-base swap must be invisible to traffic)."""

    replica_id: int = -1
    target_generation: int = -1


@dataclass
class DrainResponse(Message):
    """``granted=False`` means another member is already draining (or
    the pool would drop below ``min_available``): the replica keeps
    serving its current generation and retries on its next poll."""

    granted: bool = False
    reason: str = ""


@dataclass
class LookupRequest(Message):
    """One routed lookup batch.  ``shard_key`` is the key-consistent
    routing handle (callers that partition traffic pass their shard's
    key; the load harness passes ``keys[0]``)."""

    keys: Optional[np.ndarray] = None
    table: Optional[str] = None
    shard_key: int = 0
    min_generation: int = -1


@dataclass
class LookupResponse(Message):
    values: Optional[np.ndarray] = None
    generation: int = -1
    replica_id: int = -1
    outcome: str = "ok"


@dataclass
class RoutingTableRequest(Message):
    """Debug/test read of the router's live table (the determinism
    test compares it against a cold journal replay)."""


@dataclass
class RoutingTableResponse(Message):
    members: Dict[int, Dict] = field(default_factory=dict)
    generation_floor: int = -1
    journal_seq: int = 0
