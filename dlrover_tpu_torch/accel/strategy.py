"""Strategy and acceleration-plan data model.

Copy of ``dlrover_tpu/accel/strategy.py``: the same fields and the
same JSON, so a strategy one package saves loads into an equal plan in
the other.  In the port a plan compiles to a ``DeviceMesh``, each
parameter's placements (FSDP2 on ``fsdp``, DTensor on ``tensor``) and
the model's config knobs (:mod:`dlrover_tpu_torch.accel.accelerate`).
Reference of that file: ATorch's ``Strategy`` — an ordered list of
``(opt_name, config, tunable)`` applied by ``model_transform``
(``atorch/auto/accelerate.py:34,406``).  Here the application target
is an :class:`AccelPlan`: the declarative sharding/compile bundle a
strategy's optimizations emit, which ``auto_accelerate`` turns into a
jitted sharded train step.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.parallel.sharding import PartitionRules, replicated_rules


@dataclass
class AccelPlan:
    """What a strategy compiles down to."""

    mesh_config: MeshConfig = field(default_factory=MeshConfig)
    # parameter + (optionally different) optimizer-state placement
    param_rules: PartitionRules = field(default_factory=replicated_rules)
    opt_state_rules: Optional[PartitionRules] = None
    remat: bool = False
    # "full" | "offload" (pinned host memory) | "save_attn" (GPT)
    remat_policy: str = "full"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "xla"
    sequence_parallel: str = "none"  # none | ulysses | ring
    grad_accum: int = 1
    pipeline_microbatches: int = 4
    # "gpipe" (autodiff over the forward pipeline, any loss) or
    # "1f1b" (interleaved schedule, O(stages) activation ring,
    # fused next-token CE at the last stage)
    pipeline_schedule: str = "gpipe"
    fp8: bool = False
    # optimizer states live in host DRAM between steps
    # (reference: adam_offload.py; here optim.offload)
    offload_opt_state: bool = False
    # parameter STORAGE dtype ("" = leave the model's default); the
    # "half" optimization sets bfloat16 — halves param HBM, the
    # single-chip lever the reference's half_optimization pulls
    param_dtype: str = ""
    # replace the user optimizer with blockwise low-bit AdamW
    # (0 = off; 8/4 = moment bits) — reference: the low-bit optimizer
    # family as a searchable dimension (atorch/optimizers/low_bit)
    low_bit_opt: int = 0
    low_bit_opt_config: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def effective_opt_rules(self) -> PartitionRules:
        return (
            self.opt_state_rules
            if self.opt_state_rules is not None
            else self.param_rules
        )


@dataclass
class Strategy:
    """Ordered (opt_name, config) pairs, JSON-serializable
    (reference: strategy save/load, auto/accelerate.py:246,305)."""

    opts: List[Tuple[str, Dict[str, Any]]] = field(default_factory=list)

    def names(self) -> List[str]:
        return [n for n, _ in self.opts]

    def to_json(self) -> str:
        return json.dumps({"opts": self.opts})

    @classmethod
    def from_json(cls, text: str) -> "Strategy":
        data = json.loads(text)
        return cls(opts=[(n, c) for n, c in data["opts"]])

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Strategy":
        with open(path) as f:
            return cls.from_json(f.read())
