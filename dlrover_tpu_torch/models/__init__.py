"""Model zoo of the port (``dlrover_tpu/models``): GPT in this slice."""

from dlrover_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    count_params,
    cross_entropy_loss,
)

__all__ = ["GPT", "GPTConfig", "count_params", "cross_entropy_loss"]
