"""User-facing flash-checkpoint API.

Copy of ``dlrover_tpu/checkpoint/checkpointer.py`` (reference:
``Checkpointer`` ABC + ``DdpCheckpointer``,
``dlrover/trainer/torch/flash_checkpoint/checkpointer.py:23``,
``ddp.py:25``).  One class covers replicated state dicts (DDP parity)
and per-process shards (``replicated=False``).  The orbax tier of the
reference (``orbax_dir``/``orbax_every``, a re-shardable durable copy
through ``torch.distributed.checkpoint``) comes with slice 8 of the
port, the restore onto a sharded template (``load_checkpoint(
target_state=...)``) with slice 4.2.
"""

import threading
from enum import Enum
from typing import Any, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves


class RestoreHandle:
    """A restore running on a background thread, so its read/assemble
    stages overlap the caller's own setup (model build, optimizer
    init).  ``result()`` joins and returns ``(step, state)`` exactly as
    the synchronous call would (it IS the same code on another
    thread).

    Not a ``concurrent.futures`` future on purpose: executor threads
    are non-daemon, and a restore wedged on a dead storage tier must
    never block process exit in this crash-heavy path."""

    def __init__(self, fn, args=(), kwargs=None):
        self._value: Optional[tuple] = None
        self._exc: Optional[Exception] = None

        def run():
            try:
                self._value = fn(*args, **(kwargs or {}))
            except Exception as e:  # noqa: BLE001 - re-raised
                self._exc = e

        self._thread = threading.Thread(
            target=run, daemon=True, name="restore-async"
        )
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None):
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError("restore still running")
        if self._exc is not None:
            raise self._exc
        return self._value


class StorageType(Enum):
    MEMORY = 0
    DISK = 1


class Checkpointer:
    """Save/load state dicts of tensors with a short step stall.

    Usage::

        ckpt = Checkpointer("/ckpt/dir")
        ckpt.save_checkpoint(step, {"params": params, "opt": opt_state},
                             storage_type=StorageType.DISK)
        step, state = ckpt.load_checkpoint()
    """

    def __init__(
        self,
        checkpoint_dir: str,
        replicated: bool = True,
        deletion_keep_latest: int = 0,
        orbax_dir: str = "",
        orbax_every: int = 0,
        **engine_kwargs,
    ):
        if orbax_dir or orbax_every:
            raise NotImplementedError(
                "the orbax tier (orbax_dir/orbax_every) comes with slice "
                "8 of the port"
            )
        self.checkpoint_dir = checkpoint_dir
        self._engine = CheckpointEngine(
            checkpoint_dir,
            replicated=replicated,
            deletion_keep_latest=deletion_keep_latest,
            **engine_kwargs,
        )

    @property
    def engine(self) -> CheckpointEngine:
        return self._engine

    def register_sparse(self, adapter) -> None:
        self._engine.register_sparse(adapter)

    def save_checkpoint(
        self,
        step: int,
        state_dict: Any,
        path: str = "",
        storage_type: StorageType = StorageType.DISK,
    ) -> bool:
        if storage_type == StorageType.MEMORY:
            return self._engine.save_to_memory(step, state_dict, path)
        return self._engine.save_to_storage(step, state_dict, path)

    @property
    def last_restore_phases(self):
        """Stage breakdown of the last restore (``tier``, ``read_s``,
        ``assemble_s``, ``h2d_s``, ``total_s``, ``workers``) — the
        same numbers the ``checkpoint_restore`` event carries."""
        return dict(self._engine.last_restore_phases)

    def load_checkpoint(
        self, target_state: Any = None, orbax_dir: str = "",
    ) -> Tuple[Optional[int], Any]:
        """``(step, state)``: shm first, then storage; the state is a
        nested dict of private CPU tensors and scalars
        (:func:`restore_to_template` copies it onto the caller's
        tensors).  ``(None, {})`` when there is no checkpoint."""
        if target_state is not None:
            return self._engine.load_sharded(target_state)
        if orbax_dir:
            raise NotImplementedError(
                "the orbax tier comes with slice 8 of the port"
            )
        return self._engine.load()

    def load_checkpoint_async(
        self, target_state: Any = None, orbax_dir: str = "",
    ) -> RestoreHandle:
        """:meth:`load_checkpoint` on a background thread: start it
        FIRST, build the model and optimizer while the read+assemble
        stages run, then ``handle.result()``.  One restore at a time:
        do not save or load through this checkpointer until
        ``result()`` returned."""
        return RestoreHandle(
            self.load_checkpoint,
            kwargs={
                "target_state": target_state, "orbax_dir": orbax_dir,
            },
        )

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until in-flight async snapshot writes reach shared
        memory (call before process exit so the last save is
        restorable)."""
        return self._engine.wait_async(timeout=timeout)

    def close(self):
        self._engine.close()


@torch.no_grad()
def restore_to_template(template, restored, stats=None):
    """Copy a restored checkpoint (plain nested dicts of CPU tensors —
    the shm format flattens state dicts to string paths) onto
    ``template``: every tensor leaf of the template gets the restored
    bytes in place, on its own device; the containers come back as the
    template's (named tuples, lists, tuples), numpy leaves as numpy,
    other leaves as restored.  Returns the rebuilt tree.

    Missing leaves raise ``KeyError``; a shape or dtype that differs
    from the template's raises ``ValueError``.  With ``stats`` (a
    :class:`~.restore.RestoreStats`), the copies' wall time, through
    the end of the device copies, is added to ``stats.h2d_s``.
    """
    import time

    def lookup(path):
        node = restored
        for key in path:
            if isinstance(node, dict) and key in node:
                node = node[key]
            else:
                raise KeyError(
                    f"checkpoint is missing leaf '{'/'.join(path)}'"
                )
        return node

    devices = set()

    def put(path, tleaf):
        val = lookup(path)
        if isinstance(tleaf, torch.Tensor):
            if (tuple(val.shape) != tuple(tleaf.shape)
                    or val.dtype != tleaf.dtype):
                raise ValueError(
                    f"leaf '{'/'.join(path)}': checkpoint has "
                    f"{val.dtype}{list(val.shape)}, the template "
                    f"{tleaf.dtype}{list(tleaf.shape)}"
                )
            tleaf.copy_(val, non_blocking=tleaf.is_cuda)
            if tleaf.is_cuda:
                devices.add(tleaf.device)
            return tleaf
        if isinstance(tleaf, np.ndarray):
            return val.numpy() if isinstance(val, torch.Tensor) else val
        return val

    t0 = time.perf_counter()
    out = map_leaves(put, template)
    for device in devices:
        torch.cuda.synchronize(device)
    if stats is not None:
        stats.h2d_s += time.perf_counter() - t0
    return out
