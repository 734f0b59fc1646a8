"""In-process training library of the port (``dlrover_tpu/trainer``):
the elastic step accounting, the high-level Trainer on one GPU and the
elastic sampler."""

from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainState,
    make_train_step,
)
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

__all__ = ["ElasticTrainer", "ElasticDistributedSampler", "TrainState",
           "make_train_step"]
