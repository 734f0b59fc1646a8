"""User-facing flash-checkpoint API.

Copy of ``dlrover_tpu/checkpoint/checkpointer.py`` (reference:
``Checkpointer`` ABC + ``DdpCheckpointer``,
``dlrover/trainer/torch/flash_checkpoint/checkpointer.py:23``,
``ddp.py:25``).  One class covers replicated state dicts (DDP parity)
and per-process shards (``replicated=False``, DTensor state).
``load_checkpoint(target_state=...)`` restores onto the target's own
tensors, resharded (``CheckpointEngine.load_sharded``), and the orbax
tier (``orbax_dir``/``orbax_every``) writes every Nth storage save as a
reshardable durable copy through ``torch.distributed.checkpoint``
(:mod:`dlrover_tpu_torch.checkpoint.orbax_compat`), the last resort of
a restore.
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
        """``orbax_dir`` + ``orbax_every``: additionally write every Nth
        storage save through the orbax tier, the reshardable durable
        copy a topology change restores from (reference: the DCP tier
        next to flash saves)."""
        self.checkpoint_dir = checkpoint_dir
        self._engine = CheckpointEngine(
            checkpoint_dir,
            replicated=replicated,
            deletion_keep_latest=deletion_keep_latest,
            **engine_kwargs,
        )
        self._orbax_dir = orbax_dir
        self._orbax_every = orbax_every
        self._orbax = None
        self._orbax_waiter: Optional[threading.Thread] = None
        self._orbax_hung = False
        self._orbax_dirty = False
        self._storage_saves = 0

    def _orbax_tier(self):
        if self._orbax is None and self._orbax_dir:
            from dlrover_tpu_torch.checkpoint.orbax_compat import (
                GlobalCheckpointer,
            )

            self._orbax = GlobalCheckpointer(self._orbax_dir)
        return self._orbax

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
        ok = self._engine.save_to_storage(step, state_dict, path)
        # the durable tier is independent of the flash tier: a flash
        # save skipped as busy must not starve the orbax cadence, and
        # the cadence counts SAVES (not raw step numbers, which may
        # never hit the modulo)
        self._storage_saves += 1
        if (
            self._orbax_every
            and (self._storage_saves - 1) % self._orbax_every == 0
            and self._orbax_tier() is not None
        ):
            # DCP stages a CPU copy before returning, so the next
            # in-place update cannot reach the write
            self._orbax_tier().save(step, state_dict)
            self._orbax_dirty = True
        return ok

    @property
    def last_restore_phases(self):
        """Stage breakdown of the last restore (``tier``, ``read_s``,
        ``assemble_s``, ``h2d_s``, ``total_s``, ``workers``) — the
        same numbers the ``checkpoint_restore`` event carries."""
        return dict(self._engine.last_restore_phases)

    def load_checkpoint(
        self, target_state: Any = None, orbax_dir: str = "",
    ) -> Tuple[Optional[int], Any]:
        """``(step, state)``.  Without ``target_state``: shm first, then
        storage, then the orbax tier (``orbax_dir`` or the configured
        one); the state is a nested dict of private CPU tensors and
        scalars (:func:`restore_to_template` copies it onto the
        caller's tensors).  With ``target_state`` (a tree of DTensors,
        tensors and other leaves): every tensor of the target is
        restored in place, resharded onto its placements, from shm,
        then every rank file of storage, then the orbax tier
        (``CheckpointEngine.load_sharded``).  ``(None, {})`` when there
        is no checkpoint.

        Both paths run the staged restore pipeline
        (``DLROVER_RESTORE_WORKERS`` sizes the pool, ``1`` is the exact
        serial path)."""
        if target_state is not None:
            return self._engine.load_sharded(
                target_state, orbax_dir=orbax_dir or self._orbax_dir
            )
        step, state = self._engine.load()
        if step is None and (orbax_dir or self._orbax_dir):
            # shm and flash storage gone (a replaced node): the durable
            # tier is the last resort even without a target; a per-call
            # orbax_dir overrides the configured one
            if orbax_dir and orbax_dir != self._orbax_dir:
                from dlrover_tpu_torch.checkpoint.orbax_compat import (
                    GlobalCheckpointer,
                )

                tier = GlobalCheckpointer(orbax_dir)
                try:
                    return tier.restore()
                finally:
                    tier.close()
            tier = self._orbax_tier()
            if tier is not None:
                step, state = tier.restore()
                if step is not None:
                    return step, state
        return step, state

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
        memory AND in-flight orbax-tier writes complete (call before
        process exit so the last save is restorable).  The timeout
        bounds the whole call: a hung store cannot block a preemption
        grace period."""
        import time as _time

        deadline = _time.monotonic() + timeout
        # split the budget only when the durable tier has pending work
        orbax_pending = self._orbax is not None and (
            self._orbax_dirty or self._orbax_waiter is not None
        )
        engine_budget = (
            max(0.1, timeout * 0.7) if orbax_pending else timeout
        )
        ok = self._engine.wait_async(timeout=engine_budget)
        if orbax_pending:
            # a stale waiter entered the wait BEFORE saves issued since,
            # so only a fresh wait that completes counts as success
            stale = self._orbax_waiter
            if stale is not None and stale.is_alive():
                stale.join(timeout=max(0.05, deadline - _time.monotonic()))
                if stale.is_alive():
                    self._orbax_hung = True
                    return False
            fresh = threading.Thread(target=self._orbax.wait, daemon=True)
            fresh.start()
            fresh.join(timeout=max(0.05, deadline - _time.monotonic()))
            timed_out = fresh.is_alive()
            self._orbax_waiter = fresh if timed_out else None
            self._orbax_hung = timed_out
            self._orbax_dirty = timed_out
            ok = ok and not timed_out
        return ok

    def close(self):
        if self._orbax is not None and not self._orbax_hung:
            # a wait() that already timed out means the store is hung;
            # an unbounded wait here would outlast the caller's bound
            self._orbax.close()
        self._engine.close()


@torch.no_grad()
def restore_to_template(template, restored, stats=None):
    """Copy a restored checkpoint (plain nested dicts of CPU tensors —
    the shm format flattens state dicts to string paths) onto
    ``template``: every tensor leaf of the template gets the restored
    bytes in place, on its own device; the containers come back as the
    template's (named tuples, lists, tuples), numpy leaves as numpy,
    other leaves as restored.  Returns the rebuilt tree.

    A DTensor leaf of the template takes its own box of the restored
    full tensor into its local part.  Missing leaves raise
    ``KeyError``; a shape or dtype that differs from the template's
    raises ``ValueError``.  With ``stats`` (a
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

    from dlrover_tpu_torch.checkpoint.sharded import is_dtensor, local_box

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
            dst = tleaf
            if is_dtensor(tleaf):
                # this rank's box of the full tensor into its local part
                dst = tleaf.to_local()
                val = val[tuple(slice(lo, hi) for lo, hi in
                                local_box(tleaf))]
            dst.copy_(val, non_blocking=dst.is_cuda)
            if dst.is_cuda:
                devices.add(dst.device)
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
