"""Optimizers of the port (reference: ``dlrover_tpu/optim/``): the
low-bit family, whose moments live as blockwise int8 or int4 codes
through the CUDA kernels of :mod:`dlrover_tpu_torch.ops.quantization`,
the factored CAME / Adafactor family, AGD, WSAM, bf16 params over fp32
masters and host-offloaded states.  ``local_sgd`` (DiLoCo) comes with
slice 4.3 of the port.
"""

from dlrover_tpu_torch.optim.agd import AGD, agd
from dlrover_tpu_torch.optim.bf16 import (
    Fp32Master,
    OptaxAdamW,
    adamw_bf16,
    with_fp32_master,
)

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
from dlrover_tpu_torch.optim.offload import Offload, adamw_offload, offload
from dlrover_tpu_torch.optim.wsam import WSAM, sam_gradient, wsam

__all__ = [
    "AGD",
    "CAME",
    "Fp32Master",
    "Offload",
    "OptaxAdamW",
    "WSAM",
    "adamw_bf16",
    "adamw_offload",
    "agd",
    "offload",
    "sam_gradient",
    "with_fp32_master",
    "wsam",
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
