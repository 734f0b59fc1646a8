"""Model zoo of the port (``dlrover_tpu/models``): GPT, the Llama
family, their pipelined forms, the chunked loss and DeepFM so far."""

from dlrover_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from dlrover_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    count_params,
    cross_entropy_loss,
)
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.models.losses import (
    chunked_cross_entropy,
    chunked_loss_fn,
)

__all__ = [
    "DeepFM",
    "DeepFMConfig",
    "GPT",
    "GPTConfig",
    "Llama",
    "LlamaConfig",
    "chunked_cross_entropy",
    "chunked_loss_fn",
    "count_params",
    "cross_entropy_loss",
]
