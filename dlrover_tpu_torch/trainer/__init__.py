"""In-process training library of the port (``dlrover_tpu/trainer``):
the elastic step accounting and the high-level Trainer on one GPU."""

from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainState,
    make_train_step,
)

__all__ = ["ElasticTrainer", "TrainState", "make_train_step"]
