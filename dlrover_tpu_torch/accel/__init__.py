"""Auto-acceleration: strategy search emitting torch.distributed plans.

Reference: ``dlrover_tpu/accel/`` (ATorch's ``atorch/auto/``): a
strategy is a declarative bundle (mesh shape, partition rules,
remat/dtype policy, grad accumulation, optimizer levers) that
``auto_accelerate`` turns into FSDP2/DTensor placements and a train
step.
"""

from dlrover_tpu_torch.accel.accelerate import AccelerateResult, auto_accelerate
from dlrover_tpu_torch.accel.model_context import ModelContext
from dlrover_tpu_torch.accel.opt_lib import OptimizationLibrary
from dlrover_tpu_torch.accel.strategy import AccelPlan, Strategy

__all__ = [
    "AccelPlan",
    "AccelerateResult",
    "ModelContext",
    "OptimizationLibrary",
    "Strategy",
    "auto_accelerate",
]
