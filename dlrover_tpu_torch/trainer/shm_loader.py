"""Cross-process shared-memory data loader.

Reference: ATorch's shm dataloader + GPU preloader
(``atorch/data/shm_dataloader.py:284``, ``atorch/data/preloader.py:194``):
worker processes materialize batches into shared memory so the
training process never blocks on sample IO/collation, and a preloader
keeps the next batch resident on the accelerator.

Copy of ``dlrover_tpu/trainer/shm_loader.py``:

- ``num_workers`` spawned processes each read+collate whole batches
  and memcpy them into slots of a shared-memory ring (one segment per
  worker, ``slots_per_worker`` slots each, sized on first batch).  The
  workers never touch CUDA (the reference's keep JAX on the CPU the
  same way): ``CUDA_VISIBLE_DEVICES`` is emptied before anything in
  them could initialise CUDA.
- the trainer process wraps each finished slot in zero-copy
  ``np.frombuffer`` views and copies them to the device on a side
  stream (:class:`~dlrover_tpu_torch.trainer.dataset.DevicePlacer`);
  the consumer's stream waits on the copy's event.  Each segment is
  page-locked once with ``cudaHostRegister``, so the copy is a DMA
  straight out of the slot (``stats()["route"] == "registered"``); a
  segment that CUDA refuses to register stops the loader with that
  error.
- a slot is recycled once the CUDA event of its host-to-device copy
  has completed (the reference waits until its device batch has been
  superseded twice and is ready: an async ``device_put`` must not read
  a slot a worker is overwriting).  On the CPU the slot is read before
  :meth:`place` returns.
- a worker whose trainer died (a SIGKILL runs no cleanup) unlinks its
  segment and exits (the reference's wait for their next task forever).
- ``stats()`` reports cumulative ``input_wait_s`` — the time the
  training loop actually blocked on input — so the input-bound
  fraction of step time is measured instead of guessed.

Worker tasks carry explicit sample-index lists, so the elastic
sharding contract is preserved: the parent fetches indices from the
master's sharding service (or a local splitter) and workers only do
the expensive part (read + collate).  Batches arrive in task order.
"""

import multiprocessing as mp
import os
import pickle
import queue
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np



@dataclass
class _ArrayMeta:
    key: str
    shape: Tuple[int, ...]
    dtype: str
    offset: int


def _collate_to_layout(batch) -> Tuple[List[_ArrayMeta], int, Dict]:
    """Flatten a collated batch (dict of arrays or single array) into
    a contiguous layout; returns (metas, total_bytes, arrays)."""
    if isinstance(batch, np.ndarray):
        arrays = {"": batch}
    elif isinstance(batch, dict):
        arrays = {k: np.asarray(v) for k, v in batch.items()}
    else:
        raise TypeError(
            f"collate_fn must yield dict or ndarray, got {type(batch)}"
        )
    metas, offset = [], 0
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        arrays[key] = a
        metas.append(_ArrayMeta(key, tuple(a.shape), str(a.dtype),
                                offset))
        offset += a.nbytes
    return metas, offset, arrays


def _worker_main(
    worker_id: int,
    read_fn_blob: bytes,
    collate_blob: bytes,
    shm_name: str,
    slot_bytes: int,
    num_slots: int,
    task_q,
    free_q,
    result_q,
):
    """Worker process: read samples, collate, memcpy into a free shm
    slot, report (batch_id, slot, metas)."""
    # FIRST, before the read and collate functions are unpickled (which
    # may import torch): the workers do numpy-only read/collate/memcpy
    # and must never open the card — a CUDA context in each worker
    # would cost device memory the trainer needs
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from dlrover_tpu_torch.common.multi_process import get_or_create_shm

    parent = os.getppid()

    def get(q):
        """The next item of ``q``; None once the trainer is gone (a
        SIGKILLed trainer can neither stop its workers nor unlink their
        segments: the worker does both itself)."""
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if os.getppid() != parent:
                    shm.unlink()
                    return None

    read_fn = pickle.loads(read_fn_blob)
    collate = pickle.loads(collate_blob)
    shm = get_or_create_shm(shm_name, slot_bytes * num_slots)
    try:
        while True:
            task = get(task_q)
            if task is None:
                return
            batch_id, indices = task
            try:
                samples = [read_fn(i) for i in indices]
                batch = collate(samples)
                metas, total, arrays = _collate_to_layout(batch)
                if total > slot_bytes:
                    raise ValueError(
                        f"batch needs {total}B > slot {slot_bytes}B"
                    )
                slot = get(free_q)
                if slot is None:
                    return
                base = slot * slot_bytes
                for m in metas:
                    dst = np.frombuffer(
                        shm.buf,
                        dtype=np.dtype(m.dtype),
                        count=int(np.prod(m.shape, dtype=np.int64)),
                        offset=base + m.offset,
                    ).reshape(m.shape)
                    np.copyto(dst, arrays[m.key])
                    del dst
                result_q.put((batch_id, worker_id, slot, metas))
            except Exception as e:  # noqa: BLE001
                result_q.put((batch_id, worker_id, -1, repr(e)))
    finally:
        try:
            # frombuffer views from the copy loop may not be GC'd
            # yet; a BufferError here is cosmetic (the parent owns
            # the segment's lifetime)
            import gc

            gc.collect()
            shm.close()
        except BufferError:
            pass


class ShmDataLoader:
    """Process-parallel loader: index batches -> shm slots -> device
    tensors.

    ``read_fn(index) -> sample`` and ``collate_fn(samples) -> batch``
    must be picklable (spawn start method: a CUDA parent cannot fork
    safely).  ``index_iter`` yields sample indices (an
    ``ElasticDataset``'s sharding client, a range, ...).  Batches are
    torch tensors on ``device`` (the GPU unless another is named).
    """

    def __init__(
        self,
        read_fn: Callable[[int], Any],
        batch_size: int,
        index_iter,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 2,
        slots_per_worker: int = 2,
        slot_bytes: Optional[int] = None,
        device=None,
        device_prefetch: int = 2,
        on_batch_done: Optional[Callable[[int], None]] = None,
        name: str = "shmloader",
    ):
        from dlrover_tpu_torch.trainer.dataset import (
            DevicePlacer,
            default_collate,
        )

        if num_workers < 1:
            raise ValueError("num_workers >= 1")
        self.batch_size = batch_size
        self._read_fn = read_fn
        self._collate = collate_fn or default_collate
        self._index_iter = iter(index_iter)
        self._num_workers = num_workers
        self._placer = DevicePlacer(device)
        self._device_prefetch = max(1, device_prefetch)
        # progress invariant: the parent holds up to device_prefetch
        # slots un-recycled, and each worker's free list is PRIVATE —
        # in the worst case every held slot belongs to ONE worker, so
        # that worker needs device_prefetch + 1 slots or it blocks in
        # free_q.get() forever while the parent waits in
        # result_q.get()
        self._slots = max(slots_per_worker, self._device_prefetch + 1)
        self._on_batch_done = on_batch_done
        self._name = f"{name}_{os.getpid()}_{id(self) & 0xffffff:x}"
        self._slot_bytes = slot_bytes
        self._ctx = mp.get_context("spawn")
        self._procs: List = []
        self._shms: List = []
        self._registered: List[int] = []
        self._route = "cpu"
        self._input_wait_s = 0.0
        self._batches = 0
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def _probe_slot_bytes(self) -> Tuple[int, Optional[Any], int]:
        """Size slots from one locally-built batch (+25% headroom for
        ragged batches).  The probe batch and its sample count are
        RETURNED for delivery — re-reading its indices through a worker
        would run every sample's (possibly expensive) read twice."""
        probe = []
        for _ in range(self.batch_size):
            try:
                probe.append(next(self._index_iter))
            except StopIteration:
                break
        if not probe:
            return 0, None, 0
        samples = [self._read_fn(i) for i in probe]
        batch = self._collate(samples)
        _, total, _ = _collate_to_layout(batch)
        if len(probe) < self.batch_size:
            # short final batch: size from per-sample bytes
            total = int(total * self.batch_size / len(probe))
        return int(total * 1.25), batch, len(probe)

    def _register(self, shm):
        """Page-lock ``shm``'s mapping for DMA (``cudaHostRegister``);
        raises where CUDA refuses it."""
        import torch

        size = self._slot_bytes * self._slots
        view = np.frombuffer(shm.buf, dtype=np.uint8, count=size)
        ptr = view.ctypes.data
        del view  # no export of the buffer may outlive this
        err = torch.cuda.cudart().cudaHostRegister(ptr, size, 0)
        if int(err) != 0:
            raise RuntimeError(
                f"cudaHostRegister of shm segment {shm.name} "
                f"({size} bytes) failed: {err}"
            )
        self._registered.append(ptr)

    def _start(self):
        from dlrover_tpu_torch.common.multi_process import get_or_create_shm

        probe_batch, self._probe_count = None, 0
        if self._slot_bytes is None:
            self._slot_bytes, probe_batch, self._probe_count = (
                self._probe_slot_bytes()
            )
            if not self._slot_bytes:
                self._started = True
                self._probe_batch = None
                return
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        self._free_qs = []
        read_blob = pickle.dumps(self._read_fn)
        collate_blob = pickle.dumps(self._collate)
        for w in range(self._num_workers):
            shm_name = f"{self._name}_w{w}"
            self._shms.append(
                get_or_create_shm(
                    shm_name, self._slot_bytes * self._slots
                )
            )
            free_q = self._ctx.Queue()
            for s in range(self._slots):
                free_q.put(s)
            self._free_qs.append(free_q)
            p = self._ctx.Process(
                target=_worker_main,
                args=(w, read_blob, collate_blob, shm_name,
                      self._slot_bytes, self._slots, self._task_q,
                      free_q, self._result_q),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        if self._placer.device.type == "cuda":
            try:
                for shm in self._shms:
                    self._register(shm)
            except RuntimeError:
                self.shutdown()
                raise
            self._route = "registered"
        self._probe_batch = probe_batch
        self._started = True

    def _unregister(self):
        import torch

        for ptr in self._registered:
            torch.cuda.cudart().cudaHostUnregister(ptr)
        self._registered = []

    def shutdown(self):
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except Exception:  # noqa: BLE001
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        if self._registered:
            import torch

            # no copy may still be reading a segment it unregisters
            torch.cuda.synchronize(self._placer.device)
            self._unregister()
        for shm in self._shms:
            # a consumer may still hold numpy views of a slot: unlink
            # regardless (the mapping dies with the last reference),
            # and tolerate a close that must wait
            try:
                shm.unlink()
            except Exception:  # noqa: BLE001
                pass
            try:
                shm.close()
            except Exception:  # noqa: BLE001
                pass
        self._procs, self._shms = [], []
        self._started = False

    # -- iteration ----------------------------------------------------------

    def _next_index_batch(self) -> Optional[List[int]]:
        out = []
        for _ in range(self.batch_size):
            try:
                out.append(next(self._index_iter))
            except StopIteration:
                break
        return out or None

    def _view_batch(self, worker_id: int, slot: int, metas):
        shm = self._shms[worker_id]
        base = slot * self._slot_bytes
        arrays = {}
        for m in metas:
            arrays[m.key] = np.frombuffer(
                shm.buf, dtype=np.dtype(m.dtype),
                count=int(np.prod(m.shape, dtype=np.int64)),
                offset=base + m.offset,
            ).reshape(m.shape)
        if list(arrays) == [""]:
            return arrays[""]
        return arrays

    def _place(self, batch):
        """The device batch and the event a slot's reuse waits for (None
        on the CPU, where the slot was read before this returned)."""
        return self._placer.place(
            batch, src_pinned=self._route == "registered"
        )

    def __iter__(self):
        if not self._started:
            self._start()
        if self._probe_batch is not None:
            # deliver the sizing-probe batch directly (already read
            # and collated in-process)
            batch, self._probe_batch = self._probe_batch, None
            self._batches += 1
            yield self._placer.place(batch)[0]
            if self._on_batch_done is not None:
                self._on_batch_done(self._probe_count)
        if not self._procs:
            return
        inflight = 0
        max_inflight = self._num_workers * self._slots
        done = False
        # (copy event, worker, slot): a slot goes back to its worker
        # once the copy out of it has completed
        hold: List[Tuple[Any, int, int]] = []
        # results arrive in worker-completion order; deliver in
        # batch_id order (deterministic run-to-run, like the torch
        # multiprocessing loader's task-index reordering)
        pending: Dict[int, Tuple[int, int, Any]] = {}
        # samples in each batch not yet acked (the last may be short)
        sizes: Dict[int, int] = {}
        next_id = 0
        expect_id = 0
        try:
            while True:
                while inflight < max_inflight and not done:
                    idx = self._next_index_batch()
                    if idx is None:
                        done = True
                        break
                    self._task_q.put((next_id, idx))
                    sizes[next_id] = len(idx)
                    next_id += 1
                    inflight += 1
                if inflight == 0 and expect_id not in pending:
                    break
                t0 = time.perf_counter()
                while expect_id not in pending:
                    try:
                        batch_id, worker_id, slot, metas = (
                            self._result_q.get(timeout=5.0)
                        )
                    except queue.Empty:
                        if not any(p.is_alive() for p in self._procs):
                            # e.g. spawn could not import __main__
                            # (script without a main guard): fail
                            # loudly instead of waiting forever
                            raise RuntimeError(
                                "all shm loader workers died; check "
                                "worker stderr (a spawned worker "
                                "needs picklable fns and an "
                                "importable __main__)"
                            )
                        continue
                    if slot < 0:
                        raise RuntimeError(
                            f"shm loader worker {worker_id} failed: "
                            f"{metas}"
                        )
                    pending[batch_id] = (worker_id, slot, metas)
                    inflight -= 1
                self._input_wait_s += time.perf_counter() - t0
                worker_id, slot, metas = pending.pop(expect_id)
                count = sizes.pop(expect_id)
                expect_id += 1
                dev, event = self._place(
                    self._view_batch(worker_id, slot, metas)
                )
                hold.append((event, worker_id, slot))
                self._recycle(hold, keep=self._device_prefetch)
                self._batches += 1
                yield dev
                if self._on_batch_done is not None:
                    self._on_batch_done(count)
        finally:
            # a consumer that broke out mid-epoch may still have a
            # copy reading a slot; wait before a worker can overwrite it
            self._recycle(hold, keep=0)

    def _recycle(self, hold, keep: int):
        """Free every held slot whose copy has completed, waiting for
        the oldest copies while more than ``keep`` are held."""
        while hold:
            event, w, s = hold[0]
            if event is not None and not event.query():
                if len(hold) <= keep:
                    return
                event.synchronize()
            hold.pop(0)
            self._free_qs[w].put(s)

    def stats(self) -> Dict[str, Any]:
        """Cumulative input-side accounting for the input-bound
        fraction (reference capability: the shm loader's wait-free
        claim, shm_dataloader.py:284), and how batches reach their
        device: ``registered`` (DMA out of the page-locked slot) or
        ``cpu``."""
        return {
            "input_wait_s": round(self._input_wait_s, 4),
            "batches": self._batches,
            "route": self._route,
        }
