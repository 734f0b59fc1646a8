"""Fleet observatory: synthetic-agent load harness + control-plane
scoreboard + SLO-green capacity search, and the routed-lookup load.

Copy of ``dlrover_tpu/fleet/__init__.py`` (the port imports nothing of
the JAX package), exporting what the reference's does:

- :class:`~dlrover_tpu_torch.fleet.synthetic_agent.SyntheticAgent`
  drives a REAL :class:`~dlrover_tpu_torch.agent.master_client.
  MasterClient` through the production verb mix (rendezvous join,
  heartbeats, step/speed reports, shard lease/ack, KV barriers, session
  resync after forced reconnects) with configurable cadence, jitter and
  fault mix;
- :class:`~dlrover_tpu_torch.fleet.runner.FleetRunner` ramps hundreds of
  them against ONE real journal-backed master in-process (or in
  ``agent_pack`` subprocesses) and performs the SLO-green capacity
  search (max sustained agents), emitting ``fleet_capacity``;
- :class:`~dlrover_tpu_torch.fleet.scoreboard.Scoreboard` watches the
  control plane while they run — windowed per-verb latency quantiles
  over ``dlrover_rpc_seconds``, servicer in-flight, connection fan-in,
  journal append lock-wait and fsync-batch depth — emitted as periodic
  ``fleet_report`` events.

:mod:`dlrover_tpu_torch.fleet.lookup_load` (``LookupStats``,
``SyntheticLookupAgent``, ``LookupLoadHarness``) is the serving fleet's
routed-lookup load, which its scenario drives through the router; the
reference's package leaves it out of ``__all__`` too.
"""

from dlrover_tpu_torch.fleet.runner import FleetRunner
from dlrover_tpu_torch.fleet.scoreboard import Scoreboard
from dlrover_tpu_torch.fleet.synthetic_agent import (
    AgentProfile,
    SyntheticAgent,
)

__all__ = [
    "AgentProfile",
    "FleetRunner",
    "Scoreboard",
    "SyntheticAgent",
]
