"""Flash checkpoint: in-memory snapshots of PyTorch state dicts with
asynchronous persistence from the agent process.

Port of ``dlrover_tpu/checkpoint/__init__.py`` (reference:
``dlrover/python/elastic_agent/torch/ckpt_saver.py`` +
``dlrover/trainer/torch/flash_checkpoint/``)."""

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

__all__ = [
    "AsyncCheckpointSaver",
    "CheckpointEngine",
    "Checkpointer",
    "StorageType",
]
