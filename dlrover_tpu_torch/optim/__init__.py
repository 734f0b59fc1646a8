"""Optimizers of the port (reference: ``dlrover_tpu/optim/``): the
low-bit family, whose moments live as blockwise int8 or int4 codes
through the CUDA kernels of :mod:`dlrover_tpu_torch.ops.quantization`,
the factored CAME / Adafactor family, AGD, WSAM, bf16 params over fp32
masters and host-offloaded states, and DiLoCo local SGD (``local_sgd``).
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
from dlrover_tpu_torch.optim.local_sgd import (
    DilocoState,
    diloco_outer_step,
    diloco_outer_step_dist,
    init_diloco,
    reduce_deltas,
    replicate_for_local_training,
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
    "DilocoState",
    "Fp32Master",
    "Offload",
    "OptaxAdamW",
    "WSAM",
    "adamw_bf16",
    "adamw_offload",
    "agd",
    "diloco_outer_step",
    "diloco_outer_step_dist",
    "init_diloco",
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
    "reduce_deltas",
    "replicate_for_local_training",
]
