"""In-process training library of the port (``dlrover_tpu/trainer``):
the elastic step accounting, the high-level Trainer on one GPU, the
elastic sampler and the platform starter.

The names below load at first use, so the starter
(``python -m dlrover_tpu_torch.trainer.starter``), which runs the
launcher in its own process, loads no torch, as the launcher does not.
"""

import importlib

_EXPORTS = {
    "ElasticTrainer": "dlrover_tpu_torch.trainer.elastic_trainer",
    "TrainState": "dlrover_tpu_torch.trainer.elastic_trainer",
    "make_train_step": "dlrover_tpu_torch.trainer.elastic_trainer",
    "ElasticDistributedSampler": "dlrover_tpu_torch.trainer.sampler",
}

__all__ = ["ElasticTrainer", "ElasticDistributedSampler", "TrainState",
           "make_train_step"]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
