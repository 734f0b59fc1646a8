"""Optimizers of the port (reference: ``dlrover_tpu/optim/``): the
low-bit family, whose moments live as blockwise int8 or int4 codes
through the CUDA kernels of :mod:`dlrover_tpu_torch.ops.quantization`,
and the factored CAME / Adafactor family.
"""

from dlrover_tpu_torch.optim.came import (
    CAME,
    QAdafactor,
    came,
    q_adafactor,
    q_came,
)
from dlrover_tpu_torch.optim.low_bit import (
    NU_DOMAIN_SQRT_V1,
    QAGD,
    QAdamW,
    QMoment,
    migrate_qadamw_state_v0,
    q_adamw,
    q_agd,
)

__all__ = [
    "CAME",
    "NU_DOMAIN_SQRT_V1",
    "QAdafactor",
    "QAGD",
    "QAdamW",
    "QMoment",
    "came",
    "migrate_qadamw_state_v0",
    "q_adafactor",
    "q_adamw",
    "q_agd",
    "q_came",
]
