"""Staged, pipelined checkpoint restore executor.

Copy of ``dlrover_tpu/checkpoint/restore.py`` (``RestoreStats``,
``StagedRestore``).  The save side of the flash checkpoint is nearly
free (the training stall is one on-device copy); the restore side is
the recovery promise — "seconds-order restore from host shared memory"
(reference: ckpt_saver.py) — so it overlaps its stages instead of
running them one leaf after another:

- **read**: storage shard blobs attach as mmap views (posix), so byte
  k+1 is paged in while byte k is being assembled;
- **assemble**: each leaf is copied out of the segment (or the mmap)
  into a private CPU tensor as ~64 MB chunks on a small thread pool;
  torch's CPU ``copy_`` releases the GIL for the copy AND the page
  faults it triggers, the dominant restore term on a cold mapping;
- **h2d**: the caller copies the private tensors to its devices
  (:func:`dlrover_tpu_torch.checkpoint.checkpointer.restore_to_template`).

The target-state restore (``CheckpointEngine.load_sharded``) runs the
same stages over views of the segment or the mmaps: the pool assembles
each target box that no saved box matches exactly (the ``assemble``
stage, a bounded window of leaves ahead), and the caller's thread copies
each box into its target's own tensor (``h2d``; a box that one saved box
matches goes there straight from the view).

``DLROVER_RESTORE_WORKERS`` sizes the pool; ``1`` bypasses the pool
and runs the copies inline in order.  Stage wall times land in
:class:`RestoreStats` (``read_s``/``assemble_s``/``h2d_s``), which the
engine exports to the restore span, event and histograms.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

RESTORE_WORKERS_ENV = "DLROVER_RESTORE_WORKERS"
RESTORE_CHUNK_MB_ENV = "DLROVER_RESTORE_CHUNK_MB"

_DEFAULT_CHUNK_MB = 64


def restore_workers() -> int:
    """Pool size for the restore pipeline.  Default: half the host's
    cores capped at 8 — restore shares the host with the agent and the
    respawning trainer, and memcpy saturates memory bandwidth long
    before it saturates cores."""
    val = os.getenv(RESTORE_WORKERS_ENV, "").strip()
    if val:
        try:
            return max(1, int(val))
        except ValueError:
            pass
    return min(8, max(2, (os.cpu_count() or 4) // 2))


def chunk_bytes() -> int:
    try:
        mb = int(os.getenv(RESTORE_CHUNK_MB_ENV, str(_DEFAULT_CHUNK_MB)))
    except ValueError:
        mb = _DEFAULT_CHUNK_MB
    return max(1, mb) * 2**20


@dataclass
class RestoreStats:
    """Per-restore stage accounting (seconds of main-thread wall per
    stage; with mmap-lazy reads the page-fault cost lands in
    ``assemble_s``, where the faulting copies actually run)."""

    read_s: float = 0.0
    assemble_s: float = 0.0
    h2d_s: float = 0.0
    bytes: int = 0
    workers: int = field(default_factory=restore_workers)
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_phases(self) -> Dict[str, Any]:
        phases = {
            "read_s": round(self.read_s, 6),
            "assemble_s": round(self.assemble_s, 6),
            "h2d_s": round(self.h2d_s, 6),
            "bytes": int(self.bytes),
            "workers": int(self.workers),
        }
        phases.update(self.extra)
        return phases


class _InlineFuture:
    """Future-shaped LAZY call so the workers==1 path runs the exact
    serial sequence behind the same driving code: nothing executes at
    submit time — the work runs when (and in the order) the driving
    loop consumes ``result()``."""

    __slots__ = ("_fn", "_args", "_done", "_value", "_exc")

    def __init__(self, fn, args):
        self._fn = fn
        self._args = args
        self._done = False
        self._value = None
        self._exc = None

    def result(self):
        if not self._done:
            self._done = True
            try:
                self._value = self._fn(*self._args)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                self._exc = e
            self._fn = self._args = None
        if self._exc is not None:
            raise self._exc
        return self._value


class StagedRestore:
    """Owns the restore thread pool (or nothing, when workers==1).

    Use as a context manager; ``submit`` returns something with
    ``.result()``.  With one worker every submit executes inline when
    its result is read, which makes the pipeline the exact serial path.
    """

    def __init__(self, workers: Optional[int] = None):
        self.workers = workers if workers is not None else restore_workers()
        self._pool: Optional[ThreadPoolExecutor] = None

    def __enter__(self) -> "StagedRestore":
        if self.workers > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="ckpt-restore",
            )
        return self

    def __exit__(self, *exc):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        return False

    def submit(self, fn: Callable, *args):
        if self._pool is None:
            return _InlineFuture(fn, args)
        return self._pool.submit(fn, *args)

    def map_ordered(self, fn: Callable, items: Iterable) -> List:
        """Run ``fn`` over ``items`` concurrently, results in input
        order (inline when serial)."""
        futs = [self.submit(fn, item) for item in items]
        return [f.result() for f in futs]

    def map_pipelined(self, fn: Callable, items: Iterable, depth: int = 2):
        """Generator of ``fn(item)`` results in input order with at most
        ``depth`` calls in flight (reference ``restore.py:185``): the
        streaming reshard partitions window k+1 on the pool while the
        caller imports window k, so memory stays ~``depth`` windows.
        Serial (one worker), the inline futures run each call when its
        result is read."""
        from collections import deque

        pending: deque = deque()
        for item in items:
            pending.append(self.submit(fn, item))
            if len(pending) >= max(1, depth):
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    def copy_chunked(self, dst: torch.Tensor, src: torch.Tensor) -> List:
        """``dst.copy_(src)`` of two flat uint8 tensors, split into
        ~chunk_bytes pieces on the pool; returns the futures.  Splitting
        a single large leaf is what parallelizes the page faults of a
        cold shm mapping."""
        step = chunk_bytes()
        return [
            self.submit(_copy, dst[lo:lo + step], src[lo:lo + step])
            for lo in range(0, src.numel(), step)
        ]

    def detach_flat(self, metas: Dict, buf,
                    stats: Optional[RestoreStats] = None
                    ) -> Dict[str, torch.Tensor]:
        """A private CPU tensor for every ``TensorMeta`` in ``metas``,
        copied out of ``buf`` (a shm segment, raw bytes or an mmap);
        wall time into ``stats.assemble_s``."""
        from dlrover_tpu_torch.checkpoint.shm_handler import (
            _buffer_bytes,
            torch_dtype,
        )

        t0 = time.perf_counter()
        out: Dict[str, torch.Tensor] = {}
        pending: List = []
        nbytes = 0
        for key, m in metas.items():
            dst = torch.empty(tuple(m.shape), dtype=torch_dtype(m.dtype))
            out[key] = dst
            raw = dst.reshape(-1).view(torch.uint8)
            pending.extend(self.copy_chunked(
                raw, _buffer_bytes(buf, m.offset, raw.numel())))
            nbytes += raw.numel()
        for f in pending:
            f.result()
        if stats is not None:
            stats.assemble_s += time.perf_counter() - t0
            stats.bytes += nbytes
        return out


def _copy(dst: torch.Tensor, src: torch.Tensor):
    dst.copy_(src)


def detach_flat(metas: Dict, buf, stats: Optional[RestoreStats] = None,
                workers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One-shot convenience around :meth:`StagedRestore.detach_flat`."""
    with StagedRestore(workers) as staged:
        return staged.detach_flat(metas, buf, stats)
