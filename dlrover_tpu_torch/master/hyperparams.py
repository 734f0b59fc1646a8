"""Initial/runtime training-config generation from job stats.

Copy of ``dlrover_tpu/master/hyperparams.py`` (the port imports
nothing of the JAX package).

Reference: ``SimpleStrategyGenerator``
(``dlrover/python/master/hyperparams/simple_strategy_generator.py``)
— derives dataloader workers / micro-batch / grad-accum from observed
node resources and model info; the result lands in the tunable
``ParallelConfig`` the agents poll (auto-tuning loop).
"""

import math
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import (
    ModelInfo,
    NodeResourceStats,
    ParallelConfig,
)


class SimpleStrategyGenerator:
    def __init__(self, global_batch_size: int = 0):
        self._global_batch_size = global_batch_size
        self._version = 0

    def generate(
        self,
        resource_stats: Dict[int, NodeResourceStats],
        model_info: ModelInfo,
        dp_size: int = 1,
        hbm_bytes: int = 16 * 1024**3,
    ) -> ParallelConfig:
        """Heuristics:
        - dataloader workers ~ half the free CPU share per node;
        - micro batch bounded by HBM headroom after model+opt state
          (4 bytes/param params + 8 bytes/param adam, bf16 compute);
        - grad accumulation fills the fixed global batch.
        """
        self._version += 1
        cpu = 0.0
        if resource_stats:
            cpu = sum(
                s.cpu_percent for s in resource_stats.values()
            ) / len(resource_stats)
        dataloader_workers = max(1, int((100.0 - cpu) / 25.0))

        micro = 8
        if model_info.num_params:
            state_bytes = model_info.num_params * 12 / max(dp_size, 1)
            free = max(hbm_bytes - state_bytes, hbm_bytes * 0.1)
            # rough activation cost per sample: 20 bytes/param^(2/3)
            per_sample = max(
                1.0, 20.0 * model_info.num_params ** (2.0 / 3.0)
            )
            micro = max(1, int(free / per_sample))
            micro = 2 ** min(int(math.log2(micro)), 6)

        grad_accum = 1
        if self._global_batch_size:
            grad_accum = max(
                1, self._global_batch_size // (micro * max(dp_size, 1))
            )
        config = ParallelConfig(
            dataloader_workers=dataloader_workers,
            micro_batch_size=micro,
            gradient_accumulation=grad_accum,
            version=self._version,
        )
        logger.info("generated parallel config %s", config)
        return config
