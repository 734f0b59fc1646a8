"""Fleet observatory (reference: ``dlrover_tpu/fleet/``).

Only the routed-lookup load harness so far,
:mod:`dlrover_tpu_torch.fleet.lookup_load` (``LookupStats``,
``SyntheticLookupAgent``, ``LookupLoadHarness``), which the serving
fleet scenario drives through the router.  The synthetic-agent
control-plane load (``runner``, ``scoreboard``, ``synthetic_agent``,
``agent_pack``) comes with slice 9.2 of the port.
"""

from dlrover_tpu_torch.fleet.lookup_load import (
    LookupLoadHarness,
    LookupStats,
    SyntheticLookupAgent,
)

__all__ = [
    "LookupLoadHarness",
    "LookupStats",
    "SyntheticLookupAgent",
]
