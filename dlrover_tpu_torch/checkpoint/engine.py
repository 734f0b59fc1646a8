"""Trainer-process checkpoint engine: shm write + async persist enqueue.

Copy of the dense path of ``dlrover_tpu/checkpoint/engine.py``
(reference: ``CheckpointEngine`` / ``FullCheckpointEngine``,
``dlrover/trainer/torch/flash_checkpoint/engine.py:135,291``,
``full_ckpt_engine.py``): ``save_to_memory`` copies the state dict
into agent-owned shared memory under the shm lock; ``save_to_storage``
additionally enqueues a SAVE event the agent persists asynchronously;
``load`` prefers the shm snapshot (process restart with the agent
alive) and falls back to storage.

The snapshot.  The JAX engine's asynchronous save is safe because a
``jax.Array`` never changes: it copies on the device and lets a writer
thread fetch the copy.  Torch tensors change in place (AdamW's step,
the q-AdamW kernel writing ``p`` and the moments), so the port orders
the copy against the training stream explicitly (``_device_snapshot``):
the CUDA leaves of each device are copied back to back into one new
uint8 buffer (a few ``torch.cat`` launches, one allocation) on a side
stream that first waits for the caller's current stream; an event
recorded after the copies is waited on by the current stream before
any later work (the next optimizer step) and by the copy stream of the
device->host transfer; the buffer stays referenced until that transfer
is done.  Host tensors and numpy leaves are copied on the host before
the call returns.

Sparse state (``register_sparse``) comes with slice 6 of the port, the
target-sharded restore (``load_sharded``) with slice 4.2.
"""

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.saver import (
    EVENT_QUEUE,
    FACTORY_QUEUE,
    LOCK_PREFIX,
    AsyncCheckpointSaver,
    CheckpointEvent,
    CheckpointEventType,
    SaverConfig,
    read_last_checkpoint,
)
from dlrover_tpu_torch.checkpoint.shm_handler import (
    CheckpointConfig,
    SharedMemoryHandler,
    SnapshotLeaf,
    _as_bytes,
    _walk,
    map_leaves,
    paged_enabled,
    state_dict_from_raw,
)
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedLock,
    SharedQueue,
    _socket_path,
)
from dlrover_tpu_torch.common.storage import get_checkpoint_storage
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_SHM_SAVE_SECONDS = _REG.histogram(
    "dlrover_checkpoint_shm_save_seconds",
    "Device->host + shm memcpy time of one flash save (incl. lock)",
)
_ASYNC_WRITE_SECONDS = _REG.histogram(
    "dlrover_checkpoint_async_write_seconds",
    "Background writer latency from dequeue to shm write done",
)
_SAVE_SKIPPED_TOTAL = _REG.counter(
    "dlrover_checkpoint_save_skipped_total",
    "Flash saves skipped because the saver/writer was busy",
)
_SAVE_ERRORS_TOTAL = _REG.counter(
    "dlrover_checkpoint_save_errors_total",
    "Failed async snapshot writes",
)
_RESTORE_SECONDS = _REG.histogram(
    "dlrover_checkpoint_restore_seconds",
    "Restore latency by tier (shm fast path vs storage)",
)
_RESTORE_STAGE_SECONDS = _REG.histogram(
    "dlrover_checkpoint_restore_stage_seconds",
    "Per-stage restore pipeline time (labels: tier, stage = "
    "read / assemble / h2d)",
)
_SAVE_STAGE_SECONDS = _REG.histogram(
    "dlrover_checkpoint_save_stage_seconds",
    "Per-stage save pipeline time (labels: mode = flat, "
    "stage = fetch / memcpy)",
)


class CheckpointEngine:
    """Base engine: one per training process.

    ``replicated=True`` (DDP-style full checkpoint): every rank writes
    shm for fast restart-restore, only global rank 0's shard is
    persisted (global_shard_num=1).  ``replicated=False``
    (FSDP-style): every process persists its own shard
    (global_shard_num=world_size).
    """

    def __init__(
        self,
        checkpoint_dir: str,
        replicated: bool = True,
        local_rank: Optional[int] = None,
        global_rank: Optional[int] = None,
        world_size: Optional[int] = None,
        deletion_keep_latest: int = 0,
        async_snapshot: bool = True,
    ):
        if paged_enabled():
            raise NotImplementedError(
                "the paged shm tier (DLROVER_SHM_PAGED) comes with the "
                "sparse state in slice 6 of the port"
            )
        self.checkpoint_dir = checkpoint_dir
        self.replicated = replicated
        # Async-snapshot mode: the training stall of a flash save is
        # the snapshot copy (on the card for CUDA leaves, ordered by
        # events, see _device_snapshot); the device->host copy, shm
        # write and persist enqueue happen on a background writer
        # thread.  A crash between ``save_to_storage`` returning and
        # the background shm write completing loses that snapshot (the
        # previous one remains) — same exposure as the reference's
        # async persist window.
        self._async_snapshot = async_snapshot
        self._writer_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._writer_thread: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        self._snapshot_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._snapshot_timing: List = []
        self._last_async_error: Optional[Exception] = None
        # phase breakdown of the last completed shm save (lock wait,
        # device->host fetch, memcpy) and of the last snapshot (host
        # stall, the card's time in the copy)
        self.last_save_phases: Dict[str, float] = {}
        self.last_snapshot_phases: Dict[str, float] = {}
        # stage breakdown of the last restore (tier + read/assemble/
        # h2d seconds) — same surfacing contract as the save phases
        self.last_restore_phases: Dict[str, Any] = {}
        self._local_rank = (
            local_rank if local_rank is not None
            else env_utils.get_local_rank()
        )
        self._rank = (
            global_rank if global_rank is not None else env_utils.get_rank()
        )
        self._world_size = (
            world_size if world_size is not None
            else env_utils.get_world_size()
        )
        self._shm_handler = SharedMemoryHandler(self._local_rank, host=False)
        self._shm_lock = SharedLock(
            f"{LOCK_PREFIX}_{self._local_rank}", create=False
        )
        # the LOCAL lead process drives its node's saver: each agent
        # hosts one saver and persists its node's shards, so every
        # node's local rank 0 must enqueue SAVE events
        self._event_queue = (
            SharedQueue(EVENT_QUEUE, create=False)
            if self._local_rank == 0 else None
        )
        self._storage = get_checkpoint_storage(path=checkpoint_dir)
        self._notified_agent = False
        self._deletion_keep_latest = deletion_keep_latest
        # ship the saver config now so the agent-side saver (and its
        # shm/meta/lock servers) exists before the first load()
        # (reference creates the saver at engine construction too,
        # engine.py:253)
        self._notify_agent_to_create_saver()
        # trainer-side restore pre-fault: page-table population is
        # per process, so the agent's prefetch warms the AGENT — a
        # respawned trainer still cold-faults every page of the shm
        # snapshot inside the restore's assemble stage.  Kick the
        # strided touches on a daemon thread NOW, overlapped with the
        # caller's model build; by the time load() runs, the mapping
        # is (mostly) warm.  Only for respawns — a first incarnation
        # has no snapshot to warm.
        self._prefault_thread = None
        if env_utils.get_restart_count() > 0:
            self._prefault_thread = threading.Thread(
                target=self._prefault_shm,
                daemon=True,
                name="restore-prefault",
            )
            self._prefault_thread.start()

    def _prefault_shm(self):
        try:
            nbytes = self._shm_handler.prefault()
            if nbytes:
                logger.info(
                    "pre-faulted %.1f MB of shm snapshot during "
                    "trainer setup", nbytes / 2**20,
                )
        except Exception:  # noqa: BLE001 - warmup must never break
            logger.exception("shm pre-fault failed")

    @property
    def global_shard_num(self) -> int:
        return 1 if self.replicated else self._world_size

    def register_sparse(self, adapter) -> None:
        raise NotImplementedError(
            "sparse (KvVariable) checkpoint state comes with slice 6 of "
            "the port"
        )

    def _notify_agent_to_create_saver(self):
        """Ship the saver config to the agent's factory queue once
        (reference: engine.py:253)."""
        if self._notified_agent or self._local_rank != 0:
            self._notified_agent = True
            return
        if AsyncCheckpointSaver.get_ckpt_saver() is not None:
            # saver already exists in this process (tests / local mode)
            self._notified_agent = True
            return
        if not os.path.exists(_socket_path(FACTORY_QUEUE)):
            # standalone mode (no agent): host the saver in this
            # process so the shm/meta/lock servers exist and persists
            # still happen asynchronously — they just no longer survive
            # a crash of *this* process (the agent-process deployment
            # does; reference behaviour is a warning + no persistence)
            logger.warning(
                "no agent checkpoint-saver factory found; hosting an "
                "in-process saver (snapshots will not survive a crash "
                "of this process)"
            )
            AsyncCheckpointSaver._instance = AsyncCheckpointSaver(
                SaverConfig(
                    checkpoint_dir=self.checkpoint_dir,
                    local_shard_num=1,
                    global_shard_num=self.global_shard_num,
                    node_rank=env_utils.get_node_rank(),
                    deletion_keep_latest=self._deletion_keep_latest,
                )
            )
            self._notified_agent = True
            return
        factory = SharedQueue(FACTORY_QUEUE, create=False)
        factory.put(
            SaverConfig(
                checkpoint_dir=self.checkpoint_dir,
                local_shard_num=env_utils.get_local_world_size(),
                global_shard_num=self.global_shard_num,
                node_rank=env_utils.get_node_rank(),
                deletion_keep_latest=self._deletion_keep_latest,
            )
        )
        self._notified_agent = True

    # -- save ---------------------------------------------------------------

    def save_to_memory(
        self, step: int, state_dict, path: str = "",
        block_lock: bool = False, ready: Optional[List] = None,
    ) -> bool:
        """Synchronous part of a flash save: device->host copy into
        shm under the shm lock.  Non-blocking lock by default: if the
        agent is still persisting the previous snapshot, skip this
        save rather than stall training (reference:
        save_state_dict_to_memory, engine.py:291).  The async writer
        thread passes ``block_lock=True`` — it is off the training
        path, so waiting for the agent is free and the save must not
        be silently dropped — and ``ready``, the events after which
        its snapshot's CUDA leaves are complete."""
        self._notify_agent_to_create_saver()
        # every rank locks its shard: the agent's breakpoint save reads
        # all local shards, so an unlocked write can be torn even for
        # ranks that never persist to storage; without an agent there
        # is no concurrent reader and no lock server to talk to
        locked = False
        lock_wait = 0.0
        if self._agent_lock_available():
            t0 = time.perf_counter()
            if not self._shm_lock.acquire(
                blocking=block_lock, timeout=600.0
            ):
                logger.info(
                    "step %s: saver busy persisting; skipping shm save",
                    step,
                )
                _SAVE_SKIPPED_TOTAL.inc(reason="saver_busy")
                return False
            lock_wait = time.perf_counter() - t0
            locked = True
        try:
            config = CheckpointConfig(
                step=step,
                path=path or self.checkpoint_dir,
                rank=self._rank,
                world_size=self._world_size,
                global_shard_num=self.global_shard_num,
            )
            start = time.perf_counter()
            self._shm_handler.save_state_dict(state_dict, config,
                                              ready=ready)
            phases = dict(self._shm_handler.last_save_phases)
            phases["lock_wait_s"] = round(lock_wait, 6)
            phases["total_s"] = round(
                time.perf_counter() - start + lock_wait, 6)
            self.last_save_phases = phases
            _SHM_SAVE_SECONDS.observe(phases["total_s"])
            for stage in ("fetch", "memcpy"):
                _SAVE_STAGE_SECONDS.observe(
                    float(phases[f"{stage}_s"]), mode="flat", stage=stage
                )
            emit_event(
                "checkpoint_shm_save",
                step=step,
                rank=self._rank,
                **phases,
            )
            logger.info(
                "rank %s shm save of step %s took %.3fs "
                "(lock %.2fs, d2h fetch %.2fs, memcpy %.2fs)",
                self._rank, step, phases["total_s"],
                lock_wait, phases["fetch_s"], phases["memcpy_s"],
            )
            return True
        finally:
            if locked:
                self._shm_lock.release()

    def _agent_lock_available(self) -> bool:
        """Whether an agent-side lock server exists for this shard
        (absent in standalone/no-agent mode, where save_to_memory has
        no concurrent reader to guard against)."""
        return os.path.exists(
            _socket_path(f"{LOCK_PREFIX}_{self._local_rank}")
        )

    # -- async snapshot path -------------------------------------------------

    def _snapshot_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._snapshot_streams:
            self._snapshot_streams[device] = torch.cuda.Stream(device)
        return self._snapshot_streams[device]

    @torch.no_grad()
    def _device_snapshot(self, state_dict):
        """A copy of the state dict that later in-place updates cannot
        reach, and the events after which its CUDA leaves are complete.

        The CUDA leaves of each device are copied back to back into one
        new uint8 buffer (a few ``torch.cat`` launches, one allocation)
        on a side stream that first waits for the current stream
        (everything queued so far has written them); the current stream
        then waits for the copy, so the next optimizer step cannot
        overwrite a leaf before it is copied.  The snapshot holds
        :class:`~.shm_handler.SnapshotLeaf` views of the buffer, which
        stays referenced until the writer thread has copied it to the
        host.  Host tensors and numpy leaves are copied here; other
        leaves (step counters, strings) pass through."""
        cuda: Dict[torch.device, list] = {}

        def host_copy(path, leaf):
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    cuda.setdefault(leaf.device, []).append(leaf)
                    return leaf
                return leaf.detach().clone()
            if isinstance(leaf, np.ndarray):
                return leaf.copy()
            return leaf

        snap = map_leaves(host_copy, state_dict)
        if not cuda:
            self.last_snapshot_phases = {}
            return snap, []
        copies: Dict[int, SnapshotLeaf] = {}
        events, timing, nbytes = [], [], 0
        for device, leaves in cuda.items():
            current = torch.cuda.current_stream(device)
            side = self._snapshot_stream(device)
            side.wait_stream(current)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                parts = [_as_bytes(t) for t in leaves]
                flat = torch.empty(sum(p.numel() for p in parts),
                                   dtype=torch.uint8, device=device)
                # the timing pair brackets the copies alone, not the
                # host's time to build the views above
                start.record(side)
                _cat_into(flat, parts)
                done.record(side)
            current.wait_event(done)
            events.append(done)
            timing.append((start, done))
            offset = 0
            for t, p in zip(leaves, parts):
                copies[id(t)] = SnapshotLeaf(flat, offset, t.shape, t.dtype)
                offset += p.numel()
            nbytes += offset
        snap = map_leaves(
            lambda path, leaf: copies.get(id(leaf), leaf), snap)
        self._snapshot_timing = timing
        self.last_snapshot_phases = {"bytes": nbytes}
        return snap, events

    def _ensure_writer(self):
        with self._writer_lock:
            if self._writer_thread is None or (
                not self._writer_thread.is_alive()
            ):
                self._writer_thread = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="ckpt-snapshot-writer",
                )
                self._writer_thread.start()

    def _writer_loop(self):
        while True:
            item = self._writer_queue.get()
            if item is None:
                return
            step, snap, path, enqueue, ready = item
            item = None
            try:
                with _ASYNC_WRITE_SECONDS.time():
                    ok = self.save_to_memory(
                        step, snap, path, block_lock=True, ready=ready
                    )
                if ready:
                    # the copies are done (the stager synchronised on
                    # them), so the timing events have completed
                    self.last_snapshot_phases["device_s"] = sum(
                        s.elapsed_time(e) for s, e in self._snapshot_timing
                    ) / 1e3
                if ok and enqueue and self._event_queue is not None:
                    self._event_queue.put(
                        CheckpointEvent(
                            event_type=CheckpointEventType.SAVE, step=step
                        )
                    )
            except Exception as e:  # noqa: BLE001
                self._last_async_error = e
                _SAVE_ERRORS_TOTAL.inc()
                logger.exception(
                    "async snapshot of step %s failed", step
                )
            finally:
                # drop the snapshot before waiting for the next one:
                # its buffer holds as much device memory as the state
                snap = ready = None
                self._writer_queue.task_done()

    def wait_async(self, timeout: float = 600.0) -> bool:
        """Block until in-flight async snapshots are written to shm
        (tests / shutdown); returns False on timeout.
        ``unfinished_tasks`` counts queued and in-progress items."""
        deadline = time.monotonic() + timeout
        while self._writer_queue.unfinished_tasks:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def save_to_storage(self, step: int, state_dict, path: str = "") -> bool:
        """Flash save: shm write + async persist by the agent
        (reference: save_to_storage in full_ckpt_engine.py).

        With ``async_snapshot`` (default) and tensors in the state, the
        training stall is the snapshot copy; the host fetch + shm write
        happen on the writer thread, which then enqueues the agent
        persist."""
        has_tensors = any(
            isinstance(leaf, torch.Tensor)
            for _, leaf in _walk(state_dict)
        )
        if self._async_snapshot and has_tensors:
            if self._writer_queue.unfinished_tasks:
                logger.info(
                    "step %s: previous snapshot still writing; "
                    "skipping save", step,
                )
                _SAVE_SKIPPED_TOTAL.inc(reason="writer_busy")
                return False
            t0 = time.perf_counter()
            snap, ready = self._device_snapshot(state_dict)
            self.last_snapshot_phases["stall_s"] = time.perf_counter() - t0
            self._ensure_writer()
            self._writer_queue.put((step, snap, path, True, ready))
            return True
        ok = self.save_to_memory(step, state_dict, path)
        if ok and self._event_queue is not None:
            self._event_queue.put(
                CheckpointEvent(
                    event_type=CheckpointEventType.SAVE, step=step
                )
            )
        return ok

    # -- load ---------------------------------------------------------------

    def _record_restore(
        self, tier: str, step: Optional[int], total_s: float,
        phases: Dict[str, Any], sp=None,
    ):
        """One restore's telemetry: phase dict on the engine, stage
        histograms, restore span attributes and the
        ``checkpoint_restore`` event."""
        phases = dict(phases)
        phases["total_s"] = round(total_s, 6)
        self.last_restore_phases = {"tier": tier, **phases}
        _RESTORE_SECONDS.observe(total_s, tier=tier)
        for stage in ("read", "assemble", "h2d"):
            # the host-tensor load paths have no h2d stage: their
            # phases report h2d_s=0 for humans, but 0.0 samples would
            # fabricate the percentiles this histogram exists for
            val = phases.get(f"{stage}_s")
            if val is not None and (stage != "h2d" or val > 0):
                _RESTORE_STAGE_SECONDS.observe(
                    val, tier=tier, stage=stage
                )
        if sp is not None:
            sp.set_attribute("tier", tier)
            for key, val in phases.items():
                sp.set_attribute(key, val)
        emit_event(
            "checkpoint_restore", step=step, tier=tier,
            rank=self._rank, **phases,
        )

    def load(self) -> Tuple[Optional[int], Any]:
        """Restore: shm snapshot if present (fast path after process
        restart), else storage via the tracker file.  Both tiers run
        the staged read/assemble pipeline and return private CPU
        tensors; the per-stage breakdown lands in
        ``last_restore_phases``, the ``ckpt.restore`` span and the
        ``checkpoint_restore`` event."""
        from dlrover_tpu_torch.checkpoint.restore import RestoreStats
        from dlrover_tpu_torch.telemetry.tracing import span as _span

        with _span("ckpt.restore") as sp:
            stats = RestoreStats()
            t0 = time.perf_counter()
            config, state = self.get_state_dict_from_memory(stats)
            if config is not None:
                self._record_restore(
                    "shm", config.step, time.perf_counter() - t0,
                    stats.to_phases(), sp,
                )
                logger.info(
                    "restored step %s from shared memory "
                    "(read %.3fs, assemble %.3fs, %d workers)",
                    config.step, stats.read_s, stats.assemble_s,
                    stats.workers,
                )
                return config.step, state
            stats = RestoreStats()
            t0 = time.perf_counter()
            step, state = self.load_from_storage(stats)
            if step is not None:
                self._record_restore(
                    "storage", step, time.perf_counter() - t0,
                    stats.to_phases(), sp,
                )
            else:
                sp.set_attribute("tier", "none")
            return step, state

    def get_state_dict_from_memory(self, stats=None):
        """shm-tier restore.  With ``stats=None`` (direct callers) the
        engine records the restore itself; inside :meth:`load` the
        caller passes its accumulator and records with the tier
        decision."""
        from dlrover_tpu_torch.checkpoint.restore import RestoreStats

        own = stats is None
        if own:
            stats = RestoreStats()
        t0 = time.perf_counter()
        try:
            config, state = self._shm_handler.load_state_dict(
                stats=stats
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("shm restore failed: %s", e)
            return None, {}
        if own and config is not None:
            self._record_restore(
                "shm", config.step, time.perf_counter() - t0,
                stats.to_phases(),
            )
        return config, state

    def load_from_storage(self, stats=None) -> Tuple[Optional[int], Any]:
        """Storage-tier restore: tracker -> this rank's shard, read
        as a lazy mmap view and copied out through the chunked parallel
        pipeline (page-in overlaps the copies)."""
        from dlrover_tpu_torch.checkpoint.restore import RestoreStats

        own = stats is None
        if own:
            stats = RestoreStats()
        t0 = time.perf_counter()
        want_rank = 0 if self.replicated else self._rank
        step, shards = read_last_checkpoint(
            self.checkpoint_dir, self._storage, stats=stats,
            only_rank=want_rank,
        )
        if step is None:
            return None, {}
        if want_rank not in shards:
            logger.error(
                "checkpoint step %s has no shard for rank %s "
                "(topology changed? shards=%s)",
                step, want_rank, sorted(shards),
            )
            return None, {}
        meta, raw = shards[want_rank]
        state = state_dict_from_raw(meta, raw, stats=stats)
        if own:
            self._record_restore(
                "storage", step, time.perf_counter() - t0,
                stats.to_phases(),
            )
        logger.info(
            "restored step %s from storage (read %.3fs, assemble "
            "%.3fs, %d workers)",
            step, stats.read_s, stats.assemble_s, stats.workers,
        )
        return step, state

    def load_sharded(self, target_state, orbax_dir: str = ""):
        raise NotImplementedError(
            "the target-sharded restore (load_sharded) comes with "
            "slice 4.2 of the port (scale-out)"
        )

    def close(self):
        self.wait_async(timeout=60.0)
        if self._writer_thread is not None and self._writer_thread.is_alive():
            self._writer_queue.put(None)
            self._writer_thread.join(timeout=5.0)
        # the prefault thread holds a numpy view over shm.buf while it
        # touches pages; closing the segment under it raises
        # BufferError — wait it out (page touches are memory-speed)
        if (
            self._prefault_thread is not None
            and self._prefault_thread.is_alive()
        ):
            self._prefault_thread.join(timeout=30.0)
        self._prefault_thread = None
        self._shm_handler.close()


# bytes a torch.cat of the snapshot copies at once: a few large launches,
# each output within 32-bit indexing
_CAT_BYTES = 2**30


def _cat_into(flat: torch.Tensor, parts: List[torch.Tensor]):
    """``flat[:] = torch.cat(parts)`` in groups of up to ``_CAT_BYTES``."""
    lo, group, size = 0, [], 0
    for p in parts + [None]:
        if group and (p is None or size + p.numel() > _CAT_BYTES):
            torch.cat(group, out=flat[lo:lo + size])
            lo, group, size = lo + size, [], 0
        if p is not None:
            group.append(p)
            size += p.numel()
