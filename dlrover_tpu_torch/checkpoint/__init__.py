"""Flash checkpoint: in-memory snapshots of PyTorch state dicts with
asynchronous persistence from the agent process.

Port of ``dlrover_tpu/checkpoint/__init__.py`` (reference:
``dlrover/python/elastic_agent/torch/ckpt_saver.py`` +
``dlrover/trainer/torch/flash_checkpoint/``).  The names load at first
use, so the agent's process can import the saver without torch."""

import importlib

_EXPORTS = {
    "AsyncCheckpointSaver": "dlrover_tpu_torch.checkpoint.saver",
    "CheckpointEngine": "dlrover_tpu_torch.checkpoint.engine",
    "Checkpointer": "dlrover_tpu_torch.checkpoint.checkpointer",
    "StorageType": "dlrover_tpu_torch.checkpoint.checkpointer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
