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

A sharded leaf (a DTensor whose placements are not all ``Replicate``:
FSDP2's parameters and AdamW's moments of them, tensor-parallel
weights) goes into the snapshot as this rank's local tensor only
(``to_local()``, never ``full_tensor()``), written under ``key@shardN``
with its global box; with ``replicated=False`` every rank persists its
own shard file.  :meth:`CheckpointEngine.load_sharded` restores onto a
target state's own tensors, resharded (reference ``engine.py:1017-1417``).

The adapter contract of ``register_sparse`` (reference ``:202-232``,
``:640-1000``): a registered adapter's export nests under the reserved
``__kv__`` key of every save, taken on the caller's thread before the
snapshot so it is consistent with the dense state; every restore pops
the subtree and hands it to the adapter: a same-world restore (shm, or
this rank's storage file) to ``import_state``, a restore across world
sizes (storage only: an shm snapshot of another world is skipped) to
``import_shards_streaming`` with every old rank's subtree.  Any object
with that surface registers: the KvVariable tables'
:class:`~dlrover_tpu_torch.checkpoint.sparse.SparseStateAdapter` and the
RL plane's :class:`~dlrover_tpu_torch.rl.elastic.PPOStateAdapter`.

Delta chains (reference ``:220-265``, ``:738-821``): with delta
checkpoints enabled on the adapter, a durable save exports only the
rows touched since the last one, and its subtree names the committed
steps a restore replays first (base, then deltas), read back from their
step dirs.  A cross-world restore streams every old rank's chain
through the adapter's windowed reshard over views of the rank files.
``load_sharded`` restores the adapter's state beside the target
(reference ``:1164-1207``): this rank's own subtree from the shm tier or
its own rank file, the streaming reshard across worlds.

The paged shm tier (``DLROVER_SHM_PAGED``, reference ``:421``): a
memory save of a dict state writes only the changed dense leaves and
the adapter's delta on the shm consumer slot (``export_for_shm``), and
re-bases when the segment cannot take a delta.
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
    SHARD_SEP,
    ShardLeaf,
    SharedMemoryHandler,
    SnapshotLeaf,
    _as_bytes,
    _flatten_state_dict,
    _walk,
    flat_from_raw,
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

# the reserved key an adapter's export nests under, and the key of its
# chain metadata (reference ``checkpoint/sparse.py:61-69``)
KV_STATE_KEY = "__kv__"
KV_META_KEY = "__meta__"
# what the engine calls on a registered adapter
ADAPTER_SURFACE = (
    "export_for_checkpoint", "import_state", "import_chain",
    "import_shards_streaming", "checkpoint_chain_poison",
    "delta_checkpoints_enabled", "delta_full_every",
)
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
        # a registered checkpoint adapter (register_sparse)
        self._sparse = None
        self._warned_keep_latest = False
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
        """Attach a checkpoint adapter: its export becomes checkpoint
        state beside the dense tree (nested under ``__kv__``, so the
        state dicts must be dicts), its import runs on every restore.
        Any object with the adapter surface (:data:`ADAPTER_SURFACE`)
        registers."""
        missing = [m for m in ADAPTER_SURFACE
                   if not callable(getattr(adapter, m, None))]
        if missing:
            raise TypeError(
                f"{type(adapter).__name__} is not a checkpoint adapter: "
                f"it lacks {missing}")
        if self.replicated and self._world_size > 1:
            # replicated persists only rank 0's shard
            # (global_shard_num=1): every other rank's state would
            # silently vanish on a storage-tier restore
            raise ValueError(
                "sparse state requires per-rank shards: construct the "
                "engine with replicated=False for world_size "
                f"{self._world_size} (replicated=True persists only "
                "rank 0, losing every other rank's rows)"
            )
        self._sparse = adapter

    def _merge_sparse(self, state_dict, step: int, durable: bool = False):
        """The adapter's export folded into a COPY of the state dict,
        on the caller's thread: the export is consistent with the
        dense snapshot taken right after it.  ``durable`` marks a save
        headed for a committed storage step."""
        if self._sparse is None:
            return state_dict
        if not isinstance(state_dict, dict):
            raise TypeError(
                "a sparse adapter requires a dict state_dict (its export "
                f"rides under {KV_STATE_KEY!r}); got "
                f"{type(state_dict).__name__}"
            )
        if KV_STATE_KEY in state_dict:
            return state_dict
        if durable and self._sparse.delta_checkpoints_enabled() and (
            # the newest delta's chain spans at most full_every
            # committed steps (base included), so keep_latest >=
            # full_every retains every link
            0 < self._deletion_keep_latest
            < self._sparse.delta_full_every()
        ) and not self._warned_keep_latest:
            self._warned_keep_latest = True
            logger.warning(
                "delta flash checkpoints need every chain link on "
                "storage, but deletion_keep_latest=%d < full_every="
                "%d — a pruned link breaks restore; raise "
                "keep_latest or lower full_every",
                self._deletion_keep_latest,
                self._sparse.delta_full_every(),
            )
        merged = dict(state_dict)
        merged[KV_STATE_KEY] = self._sparse.export_for_checkpoint(
            step=step, rank=self._rank, durable=durable)
        return merged

    def _consume_sparse(self, state, stats, tier: str, step):
        """Pop the ``__kv__`` subtree out of a restored same-world state
        dict and import it into the adapter; its stage timings land in
        ``stats.extra`` (the restore event carries them)."""
        if self._sparse is None or not isinstance(state, dict):
            return state
        kv_state = state.pop(KV_STATE_KEY, None)
        if kv_state is None:
            logger.warning(
                "sparse adapter registered but checkpoint step %s "
                "carries no kv state; the adapter's state is left "
                "untouched", step,
            )
            return state
        self._import_kv_same_world(kv_state, tier, step, stats)
        return state

    def _import_kv_same_world(self, kv_state, tier, step, stats):
        """Same-world import, delta-chain aware: a full/base subtree
        imports verbatim; a delta replays its chain — the base and the
        intermediate deltas read from the committed step dirs its link
        metadata names, then the subtree in hand.  A broken chain (a
        pruned or never-persisted link) raises: restoring part of the
        sparse state silently would be worse than failing the tier."""
        meta = kv_state.get(KV_META_KEY) if isinstance(kv_state, dict) \
            else None
        if isinstance(meta, dict) and meta.get("kind") == "delta":
            want_rank = 0 if self.replicated else self._rank
            links = self._kv_chain_links(meta, want_rank)
            if links is None:
                raise RuntimeError(
                    f"kv delta checkpoint of step {step} is "
                    "unusable: a chain link is missing from storage "
                    "(pruned by deletion_keep_latest, or its persist "
                    "never committed)"
                )
            info = self._sparse.import_chain(
                links + [kv_state], tier=tier, step=step,
                rank=self._rank,
            )
        else:
            info = self._sparse.import_state(
                kv_state, tier=tier, step=step, rank=self._rank)
        stats.extra.update(info)

    def _read_kv_state_at(self, step: int, rank: int):
        """One rank's nested kv subtree of a committed step, as views
        of the rank file's mmap (the streaming import pages in only the
        window it copies); None when the step dir or the subtree is
        absent."""
        from dlrover_tpu_torch.checkpoint.saver import read_checkpoint_at

        got_step, shards = read_checkpoint_at(
            self.checkpoint_dir, step, self._storage, only_rank=rank,
        )
        if got_step is None or rank not in shards:
            return None
        from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter

        meta, raw = shards[rank]
        flat, _metas = flat_from_raw(meta, raw, detach=False)
        kv_flat, _rest = SparseStateAdapter.split_flat(flat)
        if not kv_flat:
            return None
        # the views reference the mapping, which stays alive for as
        # long as the caller holds them
        return SparseStateAdapter.nest_flat(kv_flat)

    def _kv_chain_links(self, kv_meta, rank: int):
        """A delta link's replay prefix (base and intermediate deltas,
        oldest first) for one rank; None when a link is missing."""
        from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter

        links = []
        for s in SparseStateAdapter.chain_steps(kv_meta):
            st = self._read_kv_state_at(int(s), rank)
            if st is None:
                logger.error(
                    "kv delta chain broken: step %s has no kv shard "
                    "for rank %s on storage", s, rank,
                )
                return None
            links.append(st)
        return links

    def _kv_chains_for(self, nested_per_rank):
        """{rank: [links..., subtree]} for a cross-world streaming
        reshard, each rank's delta chain resolved; None when a chain is
        broken."""
        chains = {}
        for rank, kv_state in sorted(nested_per_rank.items()):
            meta = kv_state.get(KV_META_KEY)
            if isinstance(meta, dict) and meta.get("kind") == "delta":
                links = self._kv_chain_links(meta, rank)
                if links is None:
                    return None
                chains[rank] = links + [kv_state]
            else:
                chains[rank] = [kv_state]
        return chains

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
        durable: bool = False,
    ) -> bool:
        """Synchronous part of a flash save: device->host copy into
        shm under the shm lock.  Non-blocking lock by default: if the
        agent is still persisting the previous snapshot, skip this
        save rather than stall training (reference:
        save_state_dict_to_memory, engine.py:291).  The async writer
        thread passes ``block_lock=True`` — it is off the training
        path, so waiting for the agent is free and the save must not
        be silently dropped — and ``ready``, the events after which
        its snapshot's CUDA leaves are complete.  ``durable`` marks a
        save headed for a committed storage step (the adapter's
        storage delta chain)."""
        self._notify_agent_to_create_saver()
        # paged hot saves (DLROVER_SHM_PAGED): write only what
        # changed — dense leaves copy-skipped, sparse rows as delta
        # pages through the shm consumer slot.  Sparse DURABLE saves
        # stay flat: their delta chain belongs to the storage consumer
        # and replays from committed step dirs, not shm.
        use_paged = (
            paged_enabled()
            and not durable
            and isinstance(state_dict, dict)
            and KV_STATE_KEY not in state_dict
        )
        # an adapter's export joins here on the sync path; the async
        # path merged it before queueing (the key guard skips it)
        merged_here = (
            not use_paged
            and self._sparse is not None
            and isinstance(state_dict, dict)
            and KV_STATE_KEY not in state_dict
        )
        if not use_paged:
            state_dict = self._merge_sparse(state_dict, step, durable)
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
                if merged_here and durable:
                    # a delta export already DRAINED its baseline; the
                    # skipped save means those rows never became
                    # durable — the next export must re-base
                    self._sparse.checkpoint_chain_poison()
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
            if use_paged:
                self._save_paged(step, state_dict, config, ready)
            else:
                self._shm_handler.save_state_dict(state_dict, config,
                                                  ready=ready)
            phases = dict(self._shm_handler.last_save_phases)
            phases["lock_wait_s"] = round(lock_wait, 6)
            phases["total_s"] = round(
                time.perf_counter() - start + lock_wait, 6)
            self.last_save_phases = phases
            _SHM_SAVE_SECONDS.observe(phases["total_s"])
            mode = "paged" if phases.get("paged") else "flat"
            for stage in ("fetch", "compare", "memcpy", "kv", "publish"):
                sec = phases.get(f"{stage}_s")
                if sec is not None:
                    _SAVE_STAGE_SECONDS.observe(
                        float(sec), mode=mode, stage=stage
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

    def _save_paged(self, step: int, state_dict, config,
                    ready: Optional[List] = None) -> None:
        """One paged hot save under the shm lock (reference ``:421``):
        export the sparse delta on the shm consumer slot and hand it to
        the handler as a delta page; when the handler cannot take a
        delta (fresh or invalid epoch, arena overflow) poison the shm
        chain, re-export a full base and retry once.  Any failure after
        the delta drained its baseline also poisons: those rows must
        ride the next base, not vanish."""
        from dlrover_tpu_torch.checkpoint.shm_handler import (
            PagedNeedBase,
            shm_full_every,
        )

        kv_payload = None
        if self._sparse is not None:
            kv_payload = self._sparse.export_for_shm(
                step=step, rank=self._rank, full_every=shm_full_every())
        try:
            try:
                self._shm_handler.save_state_dict_paged(
                    state_dict, config, kv_payload=kv_payload,
                    ready=ready)
                return
            except PagedNeedBase as e:
                logger.info(
                    "paged save of step %s re-basing: %s", step, e)
                if self._sparse is not None:
                    self._sparse.shm_chain_poison()
                    kv_payload = self._sparse.export_for_shm(
                        step=step, rank=self._rank,
                        full_every=shm_full_every())
                self._shm_handler.save_state_dict_paged(
                    state_dict, config, kv_payload=kv_payload,
                    ready=ready)
        except Exception:
            if self._sparse is not None:
                self._sparse.shm_chain_poison()
            raise

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
        leaves (step counters, strings) pass through.  Of a DTensor only
        this rank's local tensor is copied, as a
        :class:`~.shm_handler.ShardLeaf` with its global box when the
        DTensor is sharded."""
        from dlrover_tpu_torch.checkpoint.sharded import (
            is_dtensor,
            is_sharded_leaf,
            local_shards,
        )

        cuda: Dict[torch.device, list] = {}

        def copy_tensor(t):
            if t.is_cuda:
                cuda.setdefault(t.device, []).append(t)
                return t
            return t.detach().clone()

        def host_copy(path, leaf):
            if is_sharded_leaf(leaf):
                (box, local), = local_shards(leaf)
                return ShardLeaf(copy_tensor(local), box, leaf.shape)
            if is_dtensor(leaf):
                return copy_tensor(leaf.to_local())
            if isinstance(leaf, torch.Tensor):
                return copy_tensor(leaf)
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
        def swap(path, leaf):
            if isinstance(leaf, ShardLeaf):
                return ShardLeaf(copies.get(id(leaf.data), leaf.data),
                                 leaf.index, leaf.global_shape)
            return copies.get(id(leaf), leaf)

        snap = map_leaves(swap, snap)
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
                if self._sparse is not None:
                    # the queued snapshot may hold a drained delta that
                    # never reached shm: re-base the next export
                    self._sparse.checkpoint_chain_poison()
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
            # the adapter's export is taken now, on the training thread,
            # consistent with the dense snapshot below: the writer must
            # not read a table the next step is already scattering into
            state_dict = self._merge_sparse(state_dict, step, durable=True)
            t0 = time.perf_counter()
            snap, ready = self._device_snapshot(state_dict)
            self.last_snapshot_phases["stall_s"] = time.perf_counter() - t0
            self._ensure_writer()
            self._writer_queue.put((step, snap, path, True, ready))
            return True
        ok = self.save_to_memory(step, state_dict, path, durable=True)
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
            if (
                config is not None
                and self._sparse is not None
                and int(getattr(config, "world_size", 0) or 0)
                != self._world_size
            ):
                # an shm snapshot of another world is per-node state:
                # an adapter's cross-world restore reads every old
                # rank's subtree from the committed storage tier
                logger.warning(
                    "shm snapshot is from world size %s but this world "
                    "is %s; skipping the shm tier (cross-world restores "
                    "read committed storage)",
                    config.world_size, self._world_size,
                )
                config, state = None, {}
            if config is not None:
                state = self._consume_sparse(
                    state, stats, tier="shm", step=config.step)
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
        if self._sparse is not None:
            own_shard = shards.get(want_rank)
            ckpt_world = (_checkpoint_world(own_shard[0])
                          if own_shard else None)
            if own_shard is None or ckpt_world != self._world_size:
                # only now pay the all-ranks read: a cross-world restore
                # of the adapter's state needs every old rank's subtree
                step, shards = read_last_checkpoint(
                    self.checkpoint_dir, self._storage, stats=stats)
                if step is None:
                    return None, {}
            return self._load_sparse_from_storage(
                step, shards, want_rank, stats, t0, own)
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

    def _load_sparse_from_storage(self, step, shards, want_rank, stats,
                                  t0, own):
        """Storage restore with an adapter registered: same world =
        this rank's file, its subtree imported (chain-replayed when it
        is a delta link); another world = the dense state of this
        rank's file (or the lowest rank's) and every old rank's subtree
        (its chain resolved) to ``import_shards_streaming``, as views
        of the rank files' mmaps, so the reshard holds one window of
        rows at a time, not the sum of the shards."""
        ckpt_world = (_checkpoint_world(shards[min(shards)][0])
                      or len(shards))
        if ckpt_world == self._world_size and want_rank not in shards:
            # the world did NOT change: a missing own shard is a broken
            # checkpoint, not a reshard
            logger.error(
                "checkpoint step %s has no shard for rank %s though the "
                "world size (%s) is unchanged; treating the checkpoint "
                "as unusable", step, want_rank, ckpt_world,
            )
            return None, {}
        if ckpt_world == self._world_size:
            meta, raw = shards[want_rank]
            state = state_dict_from_raw(meta, raw, stats=stats)
            state = self._consume_sparse(state, stats, tier="storage",
                                         step=step)
        else:
            logger.warning(
                "checkpoint step %s is from world %s, this world is %s: "
                "restoring the adapter's state from %d rank file(s)",
                step, ckpt_world, self._world_size, len(shards),
            )
            from dlrover_tpu_torch.checkpoint.sparse import (
                SparseStateAdapter,
            )

            dense_rank = want_rank if want_rank in shards else min(shards)
            kv_per_rank, state = {}, {}
            for rank, (meta, raw) in sorted(shards.items()):
                flat, metas = flat_from_raw(meta, raw, stats=stats,
                                            detach=False)
                kv_flat, rest = SparseStateAdapter.split_flat(flat)
                if kv_flat:
                    kv_per_rank[rank] = SparseStateAdapter.nest_flat(
                        kv_flat)
                if rank == dense_rank:
                    state = _detach_dense_flat(rest, metas, stats)
            if kv_per_rank:
                chains = self._kv_chains_for(kv_per_rank)
                if chains is None:
                    # a broken chain fails the restore loudly: "no
                    # checkpoint" would silently restart from scratch
                    raise RuntimeError(
                        f"kv delta chain of step {step} is unusable "
                        "for the cross-world reshard (a link is "
                        "missing from storage)"
                    )
                stats.extra.update(self._sparse.import_shards_streaming(
                    chains, world_size=self._world_size, rank=self._rank,
                    from_world=ckpt_world, tier="storage", step=step))
        if own:
            self._record_restore(
                "storage", step, time.perf_counter() - t0,
                stats.to_phases(),
            )
        logger.info(
            "restored step %s from storage (read %.3fs, assemble %.3fs, "
            "%d workers)", step, stats.read_s, stats.assemble_s,
            stats.workers,
        )
        return step, state

    def load_sharded(
        self, target_state, orbax_dir: str = "",
    ) -> Tuple[Optional[int], Any]:
        """Restore onto ``target_state``'s own tensors, resharded as
        needed (reference: ``load_sharded``, ``engine.py:1017``;
        capability of ``fsdp_engine.py``'s reshard on load).

        ``target_state`` is a tree of DTensors (each restored into its
        ``to_local()``), plain tensors (restored in place), numpy arrays
        and other leaves (returned as saved).  Tier order: (1) this
        rank's shm snapshot, skipped when it was taken at another world
        size (each survivor's segment may hold another step; a resized
        world restores from committed storage), (2) every rank file of
        the last committed storage step, (3) the orbax tier at
        ``orbax_dir``.  Under a process group the ranks take the shm
        tier only when every rank's snapshot holds the same step (a kill
        that lands mid-write leaves one rank's segment torn or older), so
        all restore one step.  Every target box is copied out of the
        overlapping saved boxes; a tier whose boxes do not cover the
        target is skipped.  Returns ``(step, tree)``, the tree in the
        target's structure holding the target's own tensors, or
        ``(None, {})`` when no tier holds a checkpoint; raises when a
        checkpoint exists but no tier covers the target."""
        from dlrover_tpu_torch.checkpoint.restore import RestoreStats
        from dlrover_tpu_torch.telemetry.tracing import span as _span

        failures: List[str] = []
        with _span("ckpt.restore") as sp:
            sp.set_attribute("sharded", True)
            stats = RestoreStats()
            t0 = time.perf_counter()
            config, flat, metas = self._shm_handler.load_flat(
                stats=stats, detach=False)
            if config is not None and int(
                getattr(config, "world_size", 0) or 0
            ) != self._world_size:
                logger.warning(
                    "shm snapshot is from world size %s but this world "
                    "is %s; skipping the shm tier (cross-world restores "
                    "reshard from committed storage)",
                    config.world_size, self._world_size,
                )
                config, flat = None, {}
            step = _agreed_shm_step(config.step if config is not None
                                    and flat else None)
            if config is not None and step is None:
                logger.warning(
                    "the ranks' shm snapshots hold different steps (a "
                    "kill landed mid-write); skipping the shm tier")
                config, flat = None, {}
            if config is not None and flat:
                # the adapter's subtree is this rank's own table state:
                # it imports beside the target, never into it
                kv_flat = (_split_kv_flat(flat)
                           if self._sparse is not None else {})
                state = self._assemble_to_target(
                    target_state, flat, metas, stats, failures)
                flat = None
                if state is not None:
                    if kv_flat:
                        from dlrover_tpu_torch.checkpoint.sparse import (
                            SparseStateAdapter,
                        )

                        self._import_kv_same_world(
                            SparseStateAdapter.nest_flat(kv_flat),
                            tier="shm", step=config.step, stats=stats)
                    kv_flat = None
                    self._record_restore(
                        "shm", config.step, time.perf_counter() - t0,
                        {**stats.to_phases(), "sharded": True}, sp,
                    )
                    logger.info(
                        "restored sharded step %s from shared memory "
                        "(read %.3fs, assemble %.3fs, h2d %.3fs)",
                        config.step, stats.read_s, stats.assemble_s,
                        stats.h2d_s,
                    )
                    return config.step, state
            stats = RestoreStats()
            t0 = time.perf_counter()
            step, shards = read_last_checkpoint(
                self.checkpoint_dir, self._storage, stats=stats)
            if step is not None and shards:
                flat_all: Dict[str, Any] = {}
                metas_all: Dict[str, Any] = {}
                kv_per_rank: Dict[int, Dict[str, Any]] = {}
                for rank, (meta, raw) in sorted(shards.items()):
                    f, m = flat_from_raw(meta, raw, stats=stats,
                                         detach=False)
                    if self._sparse is not None:
                        # kv keys carry no shard suffix, so across ranks
                        # they would collide in flat_all: each rank's
                        # rows are distinct table shards, not replicas
                        kv_f = _split_kv_flat(f)
                        if kv_f:
                            kv_per_rank[rank] = kv_f
                    for key, val in f.items():
                        # shard keys collide across ranks; namespace
                        # them (the ranks in order, so a replicated box
                        # keeps the lowest rank's copy)
                        nk = f"{key}~r{rank}" if SHARD_SEP in key else key
                        flat_all[nk] = val
                        if key in m:
                            metas_all[nk] = m[key]
                state = self._assemble_to_target(
                    target_state, flat_all, metas_all, stats, failures)
                flat_all = None
                if state is not None:
                    if kv_per_rank:
                        self._import_sharded_kv(
                            kv_per_rank, shards, step, stats)
                    kv_per_rank = shards = None
                    self._record_restore(
                        "storage", step, time.perf_counter() - t0,
                        {**stats.to_phases(), "sharded": True}, sp,
                    )
                    logger.info(
                        "restored sharded step %s from storage (read "
                        "%.3fs, assemble %.3fs, h2d %.3fs)", step,
                        stats.read_s, stats.assemble_s, stats.h2d_s,
                    )
                    return step, state
            if orbax_dir:
                from dlrover_tpu_torch.checkpoint.orbax_compat import (
                    GlobalCheckpointer,
                )

                t0 = time.perf_counter()
                ckptr = GlobalCheckpointer(orbax_dir)
                try:
                    step, state = ckptr.restore(target_state)
                finally:
                    ckptr.close()
                if step is not None:
                    # the orbax tier is opaque: total only
                    self._record_restore(
                        "orbax", step, time.perf_counter() - t0,
                        {"sharded": True}, sp,
                    )
                    return step, state
            sp.set_attribute("tier", "none")
            if failures:
                raise RuntimeError(
                    "no checkpoint tier covers the target state: "
                    + "; ".join(failures))
            return None, {}

    def _import_sharded_kv(self, kv_per_rank, shards, step, stats):
        """The adapter's import on ``load_sharded``'s storage tier
        (reference ``:1175``): this rank's own subtree (chain-replayed
        when it is a delta link) when the world is unchanged and its
        file exists, the streaming reshard otherwise — the subtrees are
        views of the rank files' mmaps, so only one window is ever
        private."""
        from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter

        nested = {
            rank: SparseStateAdapter.nest_flat(kv)
            for rank, kv in kv_per_rank.items()
        }
        ckpt_world = (_checkpoint_world(shards[min(shards)][0])
                      or len(shards))
        if ckpt_world == self._world_size and self._rank in nested:
            self._import_kv_same_world(
                nested[self._rank], tier="storage", step=step, stats=stats)
            return
        chains = self._kv_chains_for(nested)
        if chains is None:
            raise RuntimeError(
                f"kv delta chain of step {step} is unusable for the "
                "cross-world reshard (a link is missing from storage)"
            )
        stats.extra.update(self._sparse.import_shards_streaming(
            chains, world_size=self._world_size, rank=self._rank,
            from_world=ckpt_world, tier="storage", step=step))

    def _assemble_to_target(self, target_state, flat, metas, stats=None,
                            failures: Optional[List[str]] = None):
        """Restore every leaf of ``target_state`` from saved entries
        (views of the shm segment or of the storage mmaps); None when
        coverage is incomplete (the caller tries the next tier, the
        reason appended to ``failures``).

        Staged as the reference's (``engine.py:1209-1417``): the host
        assembly of leaf k+1 (copies of the overlapping boxes into a new
        CPU tensor, GIL released) runs on the restore pool while this
        thread commits leaf k into its target, in a bounded window of
        leaves, so page-in, memcpy and the copies to the card overlap.
        A target box that one saved box matches exactly (a same-world
        restore) is copied straight from the view into the target.  The
        card is synchronised before returning, so the views outlive
        every copy that reads them."""
        from dlrover_tpu_torch.checkpoint.restore import (
            RestoreStats,
            StagedRestore,
        )
        from dlrover_tpu_torch.checkpoint.sharded import (
            assemble_shard,
            assemble_target_pieces,
            commit_target_pieces,
            group_shard_entries,
        )
        from dlrover_tpu_torch.checkpoint.shm_handler import (
            dtype_name,
            torch_dtype,
        )

        if stats is None:
            stats = RestoreStats()
        grouped, plain = group_shard_entries(flat, metas)
        shard_meta: Dict[str, Any] = {}
        for k, m in metas.items():
            if SHARD_SEP in k and m.index is not None:
                shard_meta.setdefault(k.split(SHARD_SEP, 1)[0], m)
        target_flat = _flatten_state_dict(target_state)

        def host_job(key, target):
            """Host half of one leaf (pool thread, CPU copies only):
            ('pieces', [(device, piece)]) for a tensor target,
            ('value', v) for any other leaf, ('missing', why)."""
            if not isinstance(target, (torch.Tensor, np.ndarray)):
                if key in plain:
                    return "value", plain[key]
                return "missing", f"missing leaf '{key}' in checkpoint"
            if key in grouped:
                m = shard_meta[key]
                gshape, saved = tuple(m.global_shape), m.dtype
                entries = grouped[key]
            elif key in plain and isinstance(plain[key], torch.Tensor):
                val = plain[key]
                gshape, saved = tuple(val.shape), dtype_name(val.dtype)
                entries = [(tuple((0, d) for d in gshape), val)]
            else:
                return "missing", f"missing leaf '{key}' in checkpoint"
            if isinstance(target, np.ndarray):
                want = np.dtype(target.dtype).name
                shape = tuple(target.shape)
            else:
                want, shape = dtype_name(target.dtype), tuple(target.shape)
            if saved != want or gshape != shape:
                return "missing", (
                    f"leaf '{key}': checkpoint has {saved}{list(gshape)}, "
                    f"the target {want}{list(shape)}")
            if isinstance(target, np.ndarray):
                full = assemble_shard(tuple((0, d) for d in gshape),
                                      torch_dtype(saved), entries)
                if full is None:
                    return "missing", f"saved shards do not cover '{key}'"
                return "value", full.numpy().copy()
            pieces = assemble_target_pieces(
                gshape, torch_dtype(saved), target, entries)
            if pieces is None:
                return "missing", f"saved shards do not cover '{key}'"
            return "pieces", pieces

        out: Dict[str, Any] = {}
        failed: Optional[str] = None
        devices = set()
        with StagedRestore() as staged:
            # a bounded window: submitting every leaf at once would let
            # the pool hold a private copy of the whole state
            window = max(2, staged.workers + 2)
            leaf_iter = iter(target_flat.items())
            jobs: list = []
            depth = 0

            def refill():
                nonlocal depth
                while depth < window:
                    nxt = next(leaf_iter, None)
                    if nxt is None:
                        return
                    key, leaf = nxt
                    jobs.append((key, leaf, staged.submit(host_job, key,
                                                          leaf)))
                    depth += 1

            refill()
            i = 0
            while i < len(jobs):
                key, target, fut = jobs[i]
                jobs[i] = None
                i += 1
                t0 = time.perf_counter()
                try:
                    kind, payload = fut.result()
                except Exception as e:  # noqa: BLE001 - next tier
                    kind, payload = "missing", f"'{key}': {e}"
                del fut
                stats.assemble_s += time.perf_counter() - t0
                depth -= 1
                if failed is None:
                    refill()
                if failed is not None:
                    continue  # drain the futures in flight
                if kind == "missing":
                    failed = payload
                    continue
                if kind == "pieces":
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        out[key] = commit_target_pieces(target, payload)
                    if target.is_cuda:
                        devices.add(target.device)
                    stats.h2d_s += time.perf_counter() - t0
                    continue
                out[key] = payload
        if failed is not None:
            logger.warning("tier skipped: %s", failed)
            if failures is not None:
                failures.append(failed)
            return None
        t0 = time.perf_counter()
        for device in devices:
            torch.cuda.synchronize(device)
        stats.h2d_s += time.perf_counter() - t0
        return map_leaves(lambda path, leaf: out["/".join(path)],
                          target_state)

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


def _checkpoint_world(meta) -> Optional[int]:
    """The world size a rank file was written at (its config's
    stamp), or None when it carries none."""
    config = meta.get("config") if isinstance(meta, dict) else None
    world = getattr(config, "world_size", None)
    if world is None and isinstance(config, dict):
        world = config.get("world_size")
    return int(world) if world else None


def _split_kv_flat(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Pop the ``__kv__/`` entries out of a flat dict (in place); they
    come back keyed relative to the prefix."""
    from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter

    kv, rest = SparseStateAdapter.split_flat(flat)
    if kv:
        flat.clear()
        flat.update(rest)
    return kv


def _detach_dense_flat(flat, metas, stats):
    """The dense remainder of a flat dict of views (the kv entries
    split out) as private tensors, shard entries assembled, nested:
    the pieces of ``state_dict_from_raw`` without copying the kv
    subtree (reference ``engine.py:991``)."""
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        _assemble,
        _unflatten_to_nested,
    )

    t0 = time.perf_counter()
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in flat.items()}
    if stats is not None:
        stats.assemble_s += time.perf_counter() - t0
    return _unflatten_to_nested(_assemble(out, metas, stats))


def _agreed_shm_step(step: Optional[int]) -> Optional[int]:
    """``step`` when every rank of the default process group holds an
    shm snapshot of that same step (``None`` for none), else None; with
    no process group, ``step`` itself."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or (
            dist.get_world_size() == 1):
        return step
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = -1 if step is None else int(step)
    both = torch.tensor([mine, -mine], dtype=torch.int64, device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MIN)
    low, high = int(both[0]), -int(both[1])
    return step if low == high and low >= 0 else None


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
