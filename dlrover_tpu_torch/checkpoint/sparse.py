"""KvVariable state <-> flash checkpoint: the sparse adapter.

Copy of ``dlrover_tpu/checkpoint/sparse.py``.  Reference: TFPlus persists hash-table embedding state through its
checkpoint system (``tfplus/kv_variable/python/training/
checkpoint_manager.py:34`` — KvVariable export ops feeding TF
checkpoints).  DLRover's whole sparse-elasticity story assumes
embedding rows, frequency counters and optimizer slots survive
scaling; this module is the port's version of that contract.

A :class:`SparseStateAdapter` registers host-resident
:class:`~dlrover_tpu_torch.ops.kv_variable.KvVariable` tables (the
embedding table AND its optimizer's slot tables) with the
flash-checkpoint engine.  On every save the engine asks the adapter
for an :meth:`export_state` snapshot — plain numpy ``keys`` /
``values`` / ``freq`` blobs, nested under the reserved ``__kv__``
pytree key — which rides the shm segment next to the dense state and
is persisted to committed storage per rank by the unchanged agent
saver.  On restore the engine hands the blobs back and the adapter
``import_``\\ s them.

Cross-world semantics (the elastic-resize contract): the shm tier is
per-node state and is REFUSED across a world change (the dense rule);
cross-world restores read every old rank's kv shard from committed
storage and RESHARD the hash table — rows are re-partitioned by
:func:`owner_of_keys` (the same splitmix64 finalizer the C++ store
hashes with) onto the new world, and each rank imports exactly its
owned subset.  Jobs that want cross-world sparse restores must
partition training traffic with the same owner function (the
DeepFM/sparse chaos scripts do); same-world restores import each
rank's own shard verbatim, with no ownership assumption.

Telemetry: every export/import emits a ``kv_checkpoint`` event
(rows, bytes, spilled rows, tier, reshard accounting) and records
``dlrover_kv_checkpoint_seconds{stage}``.  With ``DLROVER_KV_DIGEST``
set, events additionally carry an order-independent per-table content
digest (sum mod 2**64 of per-row hashes over key+values+freq) — the
chaos invariants prove "every row, frequency count and optimizer
slot bit-identical through the cycle" from the event log alone, and
the digests are additive across disjoint shards, so exactly-once
resharding is checkable as sum-of-new-digests == sum-of-old-digests.

The blobs are numpy arrays on export and arrive back as whatever the
restore path read: numpy arrays, or CPU tensors (the port's shm and
storage readers hand out tensors, views of the segment or the mmap on
the streaming paths).  Every read goes through ``np.asarray`` /
``np.ascontiguousarray``, which view a CPU tensor's memory without a
copy, so both kinds import alike and a blob written by either package
restores in the other.
"""

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops.kv_variable import (
    DIRTY_CONSUMER_CHECKPOINT,
    DIRTY_CONSUMER_SERVING,
    DIRTY_CONSUMER_SHM,
)
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

# reserved top-level pytree key the adapter's blobs ride under; the
# engine strips it before handing the dense state back to the caller
KV_STATE_KEY = "__kv__"
KV_PREFIX = KV_STATE_KEY + "/"
# nested key holding non-table optimizer state (step counters)
SCALARS_KEY = "__scalars__"
# nested key carrying the delta-checkpoint link metadata (kind =
# base/delta, parent/base steps, the chain of steps to replay); the
# chain is a comma-joined string so it survives the pytree flatten as
# one scalar
KV_META_KEY = "__meta__"

# streaming-reshard window: the peak value-row memory any bulk sparse
# path may hold at once.  MB knob for production, ROWS override for
# tests/chaos (tiny tables need sub-MB windows to exercise chunking)
RESHARD_WINDOW_MB_ENV = "DLROVER_KV_RESHARD_WINDOW_MB"
RESHARD_WINDOW_ROWS_ENV = "DLROVER_KV_RESHARD_WINDOW_ROWS"
_DEFAULT_RESHARD_WINDOW_MB = 64.0


def reshard_window_rows(row_bytes: int) -> int:
    """Rows per streaming window for a table whose rows cost
    ``row_bytes`` (keys + values + freq)."""
    rows = os.environ.get(RESHARD_WINDOW_ROWS_ENV, "").strip()
    if rows:
        try:
            return max(1, int(rows))
        except ValueError:
            pass
    try:
        mb = float(
            os.environ.get(RESHARD_WINDOW_MB_ENV, "").strip()
            or _DEFAULT_RESHARD_WINDOW_MB
        )
    except ValueError:
        mb = _DEFAULT_RESHARD_WINDOW_MB
    return max(1, int(mb * 2**20 / max(1, row_bytes)))

_REG = get_registry()
_KV_CKPT_SECONDS = _REG.histogram(
    "dlrover_kv_checkpoint_seconds",
    "Sparse (KvVariable) checkpoint stage time "
    "(labels: stage = export / import / reshard)",
)


def _hash64(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64/murmur finalizer — bit-identical to
    ``Table::hash_key`` in ``native/kv_store.cc``, so the Python-side
    ownership partition and the C++ table agree on key placement."""
    x = np.ascontiguousarray(keys, dtype=np.int64).view(np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def owner_of_keys(keys: np.ndarray, world_size: int) -> np.ndarray:
    """Rank that owns each key in a ``world_size`` world.  THE
    partition rule of cross-world sparse restores: reshard assigns
    every row to ``hash64(key) % world_size``, and sparse train loops
    that want elastic resizes route each key's traffic the same way."""
    if world_size <= 1:
        return np.zeros(np.asarray(keys).size, dtype=np.int64)
    return (_hash64(keys) % np.uint64(world_size)).astype(np.int64)


_FNV_PRIME = np.uint64(0x100000001B3)


def rows_digest(
    keys: np.ndarray, values: np.ndarray, freq: np.ndarray
) -> int:
    """Order-independent content digest of a row set: per-row FNV-ish
    hash over key + value bytes + frequency, summed mod 2**64.

    Two properties the chaos invariants lean on: (a) row ORDER never
    matters (export order changes across an import), (b) digests of
    DISJOINT shards add — the union's digest is the wrapped sum of
    the shard digests, so exactly-once resharding is provable from
    per-rank events alone (a lost row changes the sum; a duplicated
    row adds its hash twice)."""
    n = int(np.asarray(keys).size)
    if n == 0:
        return 0
    h = _hash64(keys)
    vb = np.ascontiguousarray(values, dtype=np.float32).reshape(n, -1)
    raw = vb.view(np.uint8).reshape(n, -1)
    pad = (-raw.shape[1]) % 8
    if pad:
        raw = np.concatenate(
            [raw, np.zeros((n, pad), dtype=np.uint8)], axis=1
        )
    cols = raw.view(np.uint64)
    with np.errstate(over="ignore"):
        for j in range(cols.shape[1]):
            h = (h ^ cols[:, j]) * _FNV_PRIME
        h = (h ^ np.ascontiguousarray(freq, dtype=np.uint64)) * _FNV_PRIME
        total = np.sum(h, dtype=np.uint64)
    return int(total)


def keys_digest(keys: np.ndarray) -> int:
    """Order-independent digest of a bare key set (deletion
    tombstones carry no values): sum mod 2**64 of the per-key
    splitmix hashes.  Same additivity contract as
    :func:`rows_digest`."""
    if np.asarray(keys).size == 0:
        return 0
    with np.errstate(over="ignore"):
        return int(np.sum(_hash64(keys), dtype=np.uint64))


def merge_kv_states(
    base: Dict[str, Any], deltas: List[Dict[str, Any]],
) -> Dict[str, Any]:
    """Replay a base + delta chain in numpy-land WITHOUT tables: the
    paged shm tier stores kv pages as pickled export blobs and a
    restore (or the agent's flat materialization) must flatten the
    chain back to one full export bit-equal to what the live tables
    would produce.  Per delta: tombstones delete first, then touched
    rows last-write-win (the exact :meth:`SparseStateAdapter.
    apply_delta` ordering).  Optimizer scalars ride whole per link —
    the newest link's copy wins."""
    names = [k for k in base.keys() if k != SCALARS_KEY]
    merged: Dict[str, Any] = {}
    for name in names:
        sub = base[name]
        keys = np.ascontiguousarray(sub["keys"], dtype=np.int64)
        values = np.ascontiguousarray(sub["values"], dtype=np.float32)
        freq = np.ascontiguousarray(sub["freq"], dtype=np.uint64)
        for d in deltas:
            dsub = d.get(name)
            if not isinstance(dsub, dict):
                continue
            dead = np.ascontiguousarray(
                dsub.get("dead", ()), dtype=np.int64
            )
            if dead.size:
                live = ~np.isin(keys, dead)
                keys, values, freq = (
                    keys[live], values[live], freq[live]
                )
            dkeys = np.ascontiguousarray(dsub["keys"], dtype=np.int64)
            if dkeys.size:
                keep = ~np.isin(keys, dkeys)
                keys = np.concatenate([keys[keep], dkeys])
                values = np.concatenate([
                    values[keep],
                    np.ascontiguousarray(
                        dsub["values"], dtype=np.float32
                    ),
                ])
                freq = np.concatenate([
                    freq[keep],
                    np.ascontiguousarray(
                        dsub["freq"], dtype=np.uint64
                    ),
                ])
        merged[name] = {"keys": keys, "values": values, "freq": freq}
    scalars = base.get(SCALARS_KEY)
    for d in deltas:
        scalars = d.get(SCALARS_KEY, scalars)
    if scalars:
        merged[SCALARS_KEY] = scalars
    return merged


def _digest_enabled() -> bool:
    return os.environ.get(
        "DLROVER_KV_DIGEST", ""
    ).strip().lower() in ("1", "true", "yes", "on")


def _enc(name: str) -> str:
    """Table names may contain '/' (slot tables are named
    '<table>/m'); the pytree path separator is also '/'.  Encode to
    keep one nesting level per table so shard extraction and event
    digests stay keyed by whole table."""
    return name.replace("/", ".")


class SparseStateAdapter:
    """Registers KvVariable tables + sparse optimizers with the flash
    checkpoint engine (``engine.register_sparse(adapter)`` /
    ``Checkpointer.register_sparse``).

    ``digest=None`` reads ``DLROVER_KV_DIGEST`` (the chaos scenarios
    arm it); digests cost one vectorized pass over the exported rows.
    """

    def __init__(self, digest: Optional[bool] = None):
        self._tables: Dict[str, Any] = {}
        self._optimizers: List[Any] = []
        self._digest = digest
        # delta flash checkpoints (None = full exports, the default):
        # every `_delta_every`th durable export is a full base, the
        # rest export only the consumer-1 dirty rows; `_ckpt_chain`
        # is the step chain a restore replays, `_ckpt_poisoned`
        # forces the next export to re-base (fresh adapter, restore,
        # or a failed/skipped save whose drained delta never became
        # durable)
        self._delta_every: Optional[int] = None
        self._ckpt_chain: List[int] = []
        self._ckpt_poisoned = True
        # paged shm tier (consumer 2): its base+delta pages live in
        # the shm segment itself, so the chain here is only a length
        # counter for the full-base cadence; poisoned forces the next
        # shm export to re-base (fresh adapter, any restore, or a
        # paged save that failed after draining the baseline)
        self._shm_chain_len = 0
        self._shm_poisoned = True

    # -- registration -------------------------------------------------------

    def register_table(self, table) -> "SparseStateAdapter":
        name = _enc(table.name)
        if name in self._tables and self._tables[name] is not table:
            raise ValueError(
                f"a different table is already registered as {name!r}"
                " — table names must be unique per adapter"
            )
        self._tables[name] = table
        return self

    def register_optimizer(self, optimizer) -> "SparseStateAdapter":
        """Register a sparse optimizer: its parameter table, every
        slot table (GroupAdam m/v, Adagrad acc, FTRL z/n, ...) and
        its step-counter scalars all become checkpoint state."""
        self.register_table(optimizer.table)
        for slot in optimizer.slot_tables().values():
            self.register_table(slot)
        if optimizer not in self._optimizers:
            self._optimizers.append(optimizer)
        return self

    @property
    def tables(self) -> Dict[str, Any]:
        return dict(self._tables)

    def digest_enabled(self) -> bool:
        return self._digest if self._digest is not None else (
            _digest_enabled()
        )

    # -- export (save path) -------------------------------------------------

    def export_state(
        self, step: Optional[int] = None, rank: Optional[int] = None,
        extra_event: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Snapshot every registered table into plain numpy blobs
        (spilled rows included — ``KvVariable.export`` covers both
        tiers) plus optimizer scalars.  The returned dict nests under
        :data:`KV_STATE_KEY` in the engine's state dict and rides the
        shm segment like any other array leaves, so the save stall
        grows only by these memcpys (the table is host RAM already;
        there is no device fetch).

        Chaos hook ``kv.spill``: an injected ``io_error`` here plays
        a spill-tier disk dying DURING the export — the adapter
        breaks every registered table's cold tier (subsequent spill
        IO fails like a dead device) and proceeds: stranded cold rows
        drop out of the export, DRAM rows persist, and the production
        write-failure breaker trips on the next training step."""
        try:
            _chaos.fire("kv.spill", step=step)
        except OSError:
            logger.error(
                "kv.spill io_error injected: breaking the spill tier "
                "of %d table(s) mid-export", len(self._tables),
            )
            for table in self._tables.values():
                table._break_spill_tier()
        t0 = time.perf_counter()
        with_digest = self.digest_enabled()
        out: Dict[str, Any] = {}
        digests: Dict[str, Dict[str, Any]] = {}
        rows = nbytes = spilled = lost = 0
        spill_disabled = False
        for name, table in self._tables.items():
            logical = len(table)
            keys, values, freq = table.export()
            out[name] = {"keys": keys, "values": values, "freq": freq}
            rows += len(keys)
            lost += max(0, logical - len(keys))
            nbytes += keys.nbytes + values.nbytes + freq.nbytes
            st = table.spill_stats()
            spilled += st["disk_rows"]
            spill_disabled = spill_disabled or st["disabled"]
            if with_digest:
                digests[name] = {
                    "rows": int(len(keys)),
                    "sum": f"{rows_digest(keys, values, freq):016x}",
                }
        scalars = {
            _enc(opt.table.name): opt.state_scalars()
            for opt in self._optimizers
            if hasattr(opt, "state_scalars")
        }
        if scalars:
            out[SCALARS_KEY] = scalars
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="export")
        event = dict(
            stage="export", rows=int(rows), bytes=int(nbytes),
            spilled_rows=int(spilled), seconds=round(seconds, 4),
            tables=len(self._tables),
        )
        if step is not None:
            event["step"] = int(step)
        if rank is not None:
            event["rank"] = int(rank)
        if spill_disabled:
            event["spill_disabled"] = True
        if lost:
            # rows the logical table claims but the export could not
            # read (a dead spill tier) — the checkpoint is still
            # valid for everything it DOES contain
            event["lost_rows"] = int(lost)
        if digests:
            event["digests"] = digests
        if extra_event:
            event.update(extra_event)
        emit_event("kv_checkpoint", **event)
        return out

    # -- delta export (serving-plane incremental publication) ---------------

    def enable_dirty_tracking(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> "SparseStateAdapter":
        """Arm dirty/dead tracking for one consumer slot on every
        registered table (the serving publisher arms the serving
        slot at construction; :meth:`enable_delta_checkpoints` arms
        the checkpoint slot — tracking is opt-in so non-publishing
        jobs pay nothing, and the two planes baseline
        independently)."""
        for table in self._tables.values():
            table.enable_dirty_tracking(consumer)
        return self

    def dirty_rows(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> int:
        """Rows the consumer's next delta would carry, summed over
        tables."""
        return sum(
            t.dirty_count(consumer) for t in self._tables.values()
        )

    def export_delta(
        self, step: Optional[int] = None, rank: Optional[int] = None,
        clear: bool = True,
        consumer: int = DIRTY_CONSUMER_SERVING,
        extra_event: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Snapshot only the rows TOUCHED since the last cleared
        delta (plus deletion tombstones) — the export stall is
        O(rows touched this interval), never O(table), which is what
        lets a multi-GB continuously-trained table republish to
        serving replicas without full-table stalls (reference:
        tfplus ``checkpoint_manager.py:72`` delta checkpoints).

        ``clear`` (the publisher default) atomically drains exactly
        the exported keys, so a mutation racing the export lands in
        the NEXT delta instead of vanishing.  Flash checkpoints call
        :meth:`export_state` and never clear — the serving delta
        chain and the fault-tolerance snapshots baseline
        independently."""
        t0 = time.perf_counter()
        with_digest = self.digest_enabled()
        out: Dict[str, Any] = {}
        digests: Dict[str, Dict[str, Any]] = {}
        rows = nbytes = dead_rows = table_rows = 0
        for name, table in self._tables.items():
            # tombstones FIRST: the two exports are separate lock
            # holds, and an eviction landing between them must not
            # put a key in this delta's tombstones AFTER its row was
            # exported (apply would delete-then-reimport — a
            # resurrection).  Dead-first, the racing eviction's
            # tombstone simply waits for the next delta; dead-THEN-
            # re-touched keys legitimately appear in both lists and
            # the apply order (delete, then import) lands them alive
            # with the new value — same as the trainer.
            dead = table.export_dead(clear=clear, consumer=consumer)
            keys, values, freq = table.export_dirty(
                clear=clear, consumer=consumer
            )
            out[name] = {
                "keys": keys, "values": values, "freq": freq,
                "dead": dead,
            }
            rows += len(keys)
            dead_rows += len(dead)
            table_rows += len(table)
            nbytes += (
                keys.nbytes + values.nbytes + freq.nbytes + dead.nbytes
            )
            if with_digest:
                digests[name] = {
                    "rows": int(len(keys)),
                    "sum": f"{rows_digest(keys, values, freq):016x}",
                    "dead": int(len(dead)),
                    "dead_sum": f"{keys_digest(dead):016x}",
                }
        scalars = {
            _enc(opt.table.name): opt.state_scalars()
            for opt in self._optimizers
            if hasattr(opt, "state_scalars")
        }
        if scalars:
            out[SCALARS_KEY] = scalars
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="export_delta")
        event = dict(
            stage="export", rows=int(rows), bytes=int(nbytes),
            seconds=round(seconds, 4), tables=len(self._tables),
            delta=True, dead_rows=int(dead_rows),
            table_rows=int(table_rows),
        )
        if step is not None:
            event["step"] = int(step)
        if rank is not None:
            event["rank"] = int(rank)
        if digests:
            event["digests"] = digests
        if extra_event:
            event.update(extra_event)
        emit_event("kv_checkpoint", **event)
        return out

    def apply_delta(
        self, state: Dict, tier: str = "", step: Optional[int] = None,
        rank: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Apply one delta onto the registered tables IN PLACE:
        tombstoned keys are deleted, touched rows imported (insert or
        overwrite) — the replica-side half of the delta chain, and
        the replay primitive the compaction-edge tests drive.  Unlike
        :meth:`import_state` this never clears: unchanged rows stay
        put."""
        t0 = time.perf_counter()
        with_digest = self.digest_enabled()
        rows = nbytes = dead_rows = 0
        digests: Dict[str, Dict[str, Any]] = {}
        for name, table in self._tables.items():
            sub = state.get(name)
            if not isinstance(sub, dict) or "keys" not in sub:
                continue
            keys = np.ascontiguousarray(sub["keys"], dtype=np.int64)
            values = np.ascontiguousarray(
                sub["values"], dtype=np.float32
            )
            freq = np.ascontiguousarray(sub["freq"], dtype=np.uint64)
            dead = np.ascontiguousarray(
                sub.get("dead", ()), dtype=np.int64
            )
            # tombstones first — LOAD-BEARING: the exporter reads
            # dead before dirty, so a key that died and was
            # re-touched between the two exports appears in both
            # lists, and delete-then-import must land it alive with
            # the re-touched value (matching the trainer's state)
            if dead.size:
                table.delete(dead)
            if keys.size:
                table.import_(keys, values, freq)
            rows += int(keys.size)
            dead_rows += int(dead.size)
            nbytes += (
                keys.nbytes + values.nbytes + freq.nbytes + dead.nbytes
            )
            if with_digest:
                digests[name] = {
                    "rows": int(keys.size),
                    "sum": f"{rows_digest(keys, values, freq):016x}",
                    "dead": int(dead.size),
                    "dead_sum": f"{keys_digest(dead):016x}",
                }
        scalars = state.get(SCALARS_KEY)
        if scalars:
            for opt in self._optimizers:
                sc = scalars.get(_enc(opt.table.name))
                if sc and hasattr(opt, "load_state_scalars"):
                    opt.load_state_scalars(sc)
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="apply_delta")
        event = dict(
            stage="restore", rows=int(rows), bytes=int(nbytes),
            seconds=round(seconds, 4), tables=len(self._tables),
            resharded=False, delta=True, dead_rows=int(dead_rows),
        )
        if tier:
            event["tier"] = tier
        if step is not None:
            event["step"] = int(step)
        if rank is not None:
            event["rank"] = int(rank)
        if digests:
            event["digests"] = digests
        emit_event("kv_checkpoint", **event)
        return {"kv_s": round(seconds, 4), "kv_rows": int(rows)}

    # -- delta-aware flash checkpoints (hot save path) ----------------------

    def enable_delta_checkpoints(
        self, full_every: int = 8
    ) -> "SparseStateAdapter":
        """Make durable flash saves INCREMENTAL: every
        ``full_every``th export is a full base, the rest carry only
        the rows touched since the previous durable export — the
        save stall becomes O(rows touched), the serving plane's delta
        applied to the fault-tolerance plane.  The baseline lives in
        the CHECKPOINT consumer slot, so the serving publisher's
        deltas and these never clear each other.

        Restores replay the chain (base + deltas, read from the
        committed storage step dirs named in the link metadata), so
        every link must stay on storage: run with
        ``deletion_keep_latest=0`` or ``>= full_every``.  Memory-only
        (shm) saves always export full state — the shm segment holds
        exactly one snapshot and must stand alone."""
        self._delta_every = max(1, int(full_every))
        self._ckpt_poisoned = True
        self.enable_dirty_tracking(DIRTY_CONSUMER_CHECKPOINT)
        return self

    def delta_checkpoints_enabled(self) -> bool:
        return self._delta_every is not None

    def delta_full_every(self) -> int:
        """Base cadence of the delta-checkpoint chain (0 when delta
        checkpoints are off) — the longest chain a restore replays,
        and the minimum ``deletion_keep_latest`` that keeps every
        link on storage."""
        return int(self._delta_every or 0)

    def checkpoint_chain_poison(self) -> None:
        """Force the next durable export to re-base.  Called when an
        export's save was skipped or failed AFTER the delta drained
        its baseline — those rows would otherwise silently drop out
        of the chain (same discipline as the serving publisher's
        poisoned chain)."""
        self._ckpt_poisoned = True

    def export_for_checkpoint(
        self, step: Optional[int] = None, rank: Optional[int] = None,
        durable: bool = True,
    ) -> Dict[str, Any]:
        """The engine's save-path entry: a full export unless delta
        checkpoints are enabled AND this save is durable (persisted
        to a storage step dir a restore can chain through).  Link
        metadata rides under :data:`KV_META_KEY`."""
        if self._delta_every is None or not durable:
            return self.export_state(step=step, rank=rank)
        step_i = int(step) if step is not None else 0
        # a table registered after the last base has no tracked
        # history — re-base so its rows enter the chain at all
        untracked = any(
            not t.dirty_tracking_enabled(DIRTY_CONSUMER_CHECKPOINT)
            for t in self._tables.values()
        )
        self.enable_dirty_tracking(DIRTY_CONSUMER_CHECKPOINT)
        if (
            untracked
            or self._ckpt_poisoned
            or not self._ckpt_chain
            or len(self._ckpt_chain) >= self._delta_every
        ):
            # baseline BEFORE the export (the publisher's ordering):
            # a mutation racing the two steps lands in the base AND
            # the next delta — a benign overwrite, never a silent gap
            for table in self._tables.values():
                table.clear_dirty(DIRTY_CONSUMER_CHECKPOINT)
            out = self.export_state(
                step=step, rank=rank,
                extra_event={"kind": "base",
                             "consumer": DIRTY_CONSUMER_CHECKPOINT},
            )
            out[KV_META_KEY] = {"kind": "base", "step": step_i}
            self._ckpt_chain = [step_i]
            self._ckpt_poisoned = False
            return out
        out = self.export_delta(
            step=step, rank=rank, clear=True,
            consumer=DIRTY_CONSUMER_CHECKPOINT,
            extra_event={
                "kind": "delta",
                "consumer": DIRTY_CONSUMER_CHECKPOINT,
                "base_step": int(self._ckpt_chain[0]),
                "parent_step": int(self._ckpt_chain[-1]),
                "chain_len": len(self._ckpt_chain) + 1,
            },
        )
        out[KV_META_KEY] = {
            "kind": "delta",
            "step": step_i,
            "parent": int(self._ckpt_chain[-1]),
            "base": int(self._ckpt_chain[0]),
            # comma-joined so the pytree flatten keeps it one scalar
            "chain": ",".join(str(s) for s in self._ckpt_chain),
        }
        self._ckpt_chain.append(step_i)
        return out

    # -- paged shm tier (consumer 2) ---------------------------------------

    def shm_chain_poison(self) -> None:
        """Force the next paged shm export to re-base — same
        discipline as :meth:`checkpoint_chain_poison`, for the shm
        consumer slot: a paged save that failed or was skipped AFTER
        the delta drained its baseline would otherwise silently drop
        those rows from the segment."""
        self._shm_poisoned = True

    def export_for_shm(
        self, step: Optional[int] = None, rank: Optional[int] = None,
        full_every: int = 0,
    ) -> Tuple[str, Dict[str, Any]]:
        """The paged shm tier's export entry: ``("base", state)`` on
        the first save / after any poison / every ``full_every``-th
        save, else ``("delta", state)`` holding only the consumer-2
        dirty rows.  Unlike the storage chain there is no
        :data:`KV_META_KEY` link metadata — the shm page directory
        itself records the chain."""
        untracked = any(
            not t.dirty_tracking_enabled(DIRTY_CONSUMER_SHM)
            for t in self._tables.values()
        )
        self.enable_dirty_tracking(DIRTY_CONSUMER_SHM)
        cadence = int(full_every or 0)
        if (
            untracked
            or self._shm_poisoned
            or self._shm_chain_len <= 0
            or (cadence > 0 and self._shm_chain_len >= cadence)
        ):
            # baseline BEFORE the export (the publisher's ordering):
            # a racing mutation lands in the base AND the next delta
            for table in self._tables.values():
                table.clear_dirty(DIRTY_CONSUMER_SHM)
            out = self.export_state(
                step=step, rank=rank,
                extra_event={"kind": "base",
                             "consumer": DIRTY_CONSUMER_SHM},
            )
            self._shm_chain_len = 1
            self._shm_poisoned = False
            return "base", out
        out = self.export_delta(
            step=step, rank=rank, clear=True,
            consumer=DIRTY_CONSUMER_SHM,
            extra_event={
                "kind": "delta",
                "consumer": DIRTY_CONSUMER_SHM,
                "chain_len": self._shm_chain_len + 1,
            },
        )
        self._shm_chain_len += 1
        return "delta", out

    @staticmethod
    def chain_steps(meta: Dict[str, Any]) -> List[int]:
        """The storage steps a delta link's restore must replay
        BEFORE the link itself (base first)."""
        raw = str(meta.get("chain", "") or "")
        return [int(s) for s in raw.split(",") if s.strip()]

    def import_chain(
        self, links: List[Dict], tier: str = "",
        step: Optional[int] = None, rank: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Chain replay: ``links[0]`` (a base / full export) replaces
        the tables, every later link applies as a delta (tombstones
        then rows).  Digest-equal to a full export at every link —
        the property test pins it."""
        if not links:
            return {"kv_s": 0.0, "kv_rows": 0}
        t0 = time.perf_counter()
        info = self.import_state(
            links[0], tier=tier, step=step, rank=rank
        )
        rows = int(info.get("kv_rows", 0))
        for link in links[1:]:
            d = self.apply_delta(
                link, tier=tier, step=step, rank=rank
            )
            rows += int(d.get("kv_rows", 0))
        return {
            "kv_s": round(time.perf_counter() - t0, 4),
            "kv_rows": rows,
            "kv_chain": len(links),
        }

    # -- import (restore path) ----------------------------------------------

    def _import_tables(
        self, per_table: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
        scalars: Optional[Dict] = None,
    ) -> Tuple[int, int, Dict[str, Dict[str, Any]]]:
        """Replace every registered table's contents; returns
        (rows, bytes, digests)."""
        # any restore invalidates the delta-checkpoint baseline: the
        # import re-marks every row dirty anyway, and a delta chained
        # onto pre-restore history would be wrong — next export bases
        self._ckpt_poisoned = True
        self._shm_poisoned = True
        with_digest = self.digest_enabled()
        rows = nbytes = 0
        digests: Dict[str, Dict[str, Any]] = {}
        for name, table in self._tables.items():
            blob = per_table.get(name)
            if blob is None:
                logger.warning(
                    "checkpoint has no kv state for table %r; leaving "
                    "it untouched", name,
                )
                continue
            keys, values, freq = blob
            table.clear()
            table.import_(keys, values, freq)
            rows += len(keys)
            nbytes += keys.nbytes + values.nbytes + freq.nbytes
            if with_digest:
                digests[name] = {
                    "rows": int(len(keys)),
                    "sum": f"{rows_digest(keys, values, freq):016x}",
                }
        if scalars:
            for opt in self._optimizers:
                sc = scalars.get(_enc(opt.table.name))
                if sc and hasattr(opt, "load_state_scalars"):
                    opt.load_state_scalars(sc)
        return rows, nbytes, digests

    @staticmethod
    def _blobs_from(state: Dict) -> Tuple[Dict, Optional[Dict]]:
        """Nested kv state dict -> ({table: (keys, values, freq)},
        scalars)."""
        per_table = {}
        for name, sub in state.items():
            if name == SCALARS_KEY or not isinstance(sub, dict):
                continue
            if "keys" not in sub:
                continue
            per_table[name] = (
                np.ascontiguousarray(sub["keys"], dtype=np.int64),
                np.ascontiguousarray(sub["values"], dtype=np.float32),
                np.ascontiguousarray(sub["freq"], dtype=np.uint64),
            )
        return per_table, state.get(SCALARS_KEY)

    def import_state(
        self, state: Dict, tier: str = "", step: Optional[int] = None,
        rank: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Same-world restore: import one rank's own kv shard
        verbatim (no ownership assumption).  Returns the info dict
        the engine folds into the restore phase breakdown."""
        t0 = time.perf_counter()
        per_table, scalars = self._blobs_from(state)
        rows, nbytes, digests = self._import_tables(per_table, scalars)
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="import")
        event = dict(
            stage="restore", rows=int(rows), bytes=int(nbytes),
            seconds=round(seconds, 4), tables=len(per_table),
            resharded=False,
        )
        if tier:
            event["tier"] = tier
        if step is not None:
            event["step"] = int(step)
        if rank is not None:
            event["rank"] = int(rank)
        if digests:
            event["digests"] = digests
        emit_event("kv_checkpoint", **event)
        return {"kv_s": round(seconds, 4), "kv_rows": int(rows)}

    def import_shards(
        self,
        shards: Dict[int, Dict],
        world_size: int,
        rank: int,
        from_world: Optional[int] = None,
        tier: str = "storage",
        step: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Cross-world restore: RESHARD the hash table from every old
        rank's kv state.  Rows are concatenated across shards
        (deduped by key, later rank wins — a well-partitioned job
        never collides), re-partitioned by :func:`owner_of_keys` onto
        the new ``world_size``, and exactly this rank's owned subset
        replaces the table contents.  Optimizer scalars come from the
        lowest old rank.  ``shards`` maps old global rank -> nested
        kv state dict."""
        t0 = time.perf_counter()
        if from_world is None:
            from_world = len(shards)
        per_rank = {
            r: self._blobs_from(state) for r, state in sorted(
                shards.items()
            )
        }
        owned: Dict[str, Tuple] = {}
        total_rows = 0
        for name in self._tables:
            ks, vs, fs = [], [], []
            for r, (per_table, _) in per_rank.items():
                blob = per_table.get(name)
                if blob is not None:
                    ks.append(blob[0])
                    vs.append(blob[1])
                    fs.append(blob[2])
            if not ks:
                continue
            keys = np.concatenate(ks)
            dim = self._tables[name].dim
            values = np.concatenate(
                [v.reshape(-1, dim) for v in vs]
            )
            freq = np.concatenate(fs)
            # dedupe by key, keeping the LAST occurrence (highest old
            # rank) — mirrors import_'s overwrite semantics
            _, last_idx = np.unique(keys[::-1], return_index=True)
            keep = np.sort(len(keys) - 1 - last_idx)
            keys, values, freq = keys[keep], values[keep], freq[keep]
            total_rows += len(keys)
            mine = owner_of_keys(keys, world_size) == rank
            owned[name] = (keys[mine], values[mine], freq[mine])
        for name, table in self._tables.items():
            if name not in owned:
                # a registered table with no rows in ANY old shard
                # must still be CLEARED: a reshard-in-place that left
                # it untouched would keep the previous world's rows —
                # phantom duplicates of rows the key-hash partition
                # assigned to other ranks
                owned[name] = (
                    np.empty(0, np.int64),
                    np.empty((0, table.dim), np.float32),
                    np.empty(0, np.uint64),
                )
        scalars = None
        for _r, (_pt, sc) in per_rank.items():
            if sc:
                scalars = sc
                break
        rows, nbytes, digests = self._import_tables(owned, scalars)
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="reshard")
        event = dict(
            stage="restore", rows=int(rows), bytes=int(nbytes),
            seconds=round(seconds, 4), tables=len(owned),
            resharded=True, from_world=int(from_world),
            world_size=int(world_size), total_rows=int(total_rows),
            tier=tier,
        )
        if step is not None:
            event["step"] = int(step)
        event["rank"] = int(rank)
        if digests:
            event["digests"] = digests
        emit_event("kv_checkpoint", **event)
        logger.info(
            "resharded kv restore: %d/%d row(s) owned by rank %d of "
            "world %d (from world %s, %d table(s), %.3fs)",
            rows, total_rows, rank, world_size, from_world,
            len(owned), seconds,
        )
        return {
            "kv_s": round(seconds, 4),
            "kv_rows": int(rows),
            "kv_resharded": True,
        }

    # -- streaming reshard (bounded-memory cross-world restore) -------------

    def import_shards_streaming(
        self,
        shards: Dict[int, Any],
        world_size: int,
        rank: int,
        from_world: Optional[int] = None,
        tier: str = "storage",
        step: Optional[int] = None,
        window_rows: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Cross-world reshard that never holds more than a bounded
        window of value rows in RAM: per old rank, per table, the
        source arrays (typically live mmap/shm VIEWS — only the
        window pages in) are walked in ``window_rows`` slices, each
        window vectorized through :func:`owner_of_keys`, and exactly
        this rank's owned subset imported.  Window k+1's
        partition/copy runs on the staged-restore pool while window
        k's native import holds the table lock (ctypes releases the
        GIL), so partition and import overlap.

        ``shards`` maps old rank -> nested kv state OR a LIST of
        states (a delta-checkpoint chain, base first: later links
        overwrite/tombstone earlier ones exactly as replay would).
        Ranks apply in ascending order, so duplicate keys keep the
        one-shot path's last-rank-wins overwrite semantics.

        With digests armed, the per-window import digests are summed
        additively and checked against a chunked re-export of the
        final tables — a chunk imported twice (or a row lost between
        windows) breaks the equality, so exactly-once holds at ANY
        chunking.  (Chain inputs skip the strict check: a delta
        legitimately overwrites its base's rows.)"""
        from dlrover_tpu_torch.checkpoint.restore import StagedRestore

        t0 = time.perf_counter()
        if from_world is None:
            from_world = len(shards)
        with_digest = self.digest_enabled()
        chains: Dict[int, List[Dict]] = {
            r: (list(state) if isinstance(state, (list, tuple))
                else [state])
            for r, state in sorted(shards.items())
        }
        chained = any(len(links) > 1 for links in chains.values())
        # replace-semantics: clear every registered table up front (a
        # leftover row from the previous world would be a phantom
        # duplicate of a row the partition assigned elsewhere), then
        # pre-size for the expected owned share — geometric slab
        # growth mid-stream would otherwise realloc+memcpy the whole
        # destination repeatedly, exactly the transient the bounded
        # window exists to avoid
        for name, table in self._tables.items():
            table.clear()
            est = 0
            for links in chains.values():
                sub = links[0].get(name)
                if isinstance(sub, dict) and sub.get(
                    "keys"
                ) is not None:
                    est += int(np.asarray(sub["keys"]).shape[0])
            if est:
                table.reserve(est // max(1, world_size) + 64)
        self._ckpt_poisoned = True
        self._shm_poisoned = True

        rows = nbytes = total_rows = chunks = 0
        import_sums: Dict[str, int] = {}
        win_used: Optional[int] = None

        def _tasks():
            """(table, kind, key_slice, value_slice, freq_slice)
            windows, ranks ascending, links in chain order, dead
            before rows within a link (the apply_delta ordering)."""
            nonlocal win_used
            for old_rank, links in chains.items():
                for link in links:
                    for name, table in self._tables.items():
                        sub = link.get(name)
                        if not isinstance(sub, dict):
                            continue
                        win = window_rows or reshard_window_rows(
                            table.dim * 4 + 16
                        )
                        win_used = win
                        dead = sub.get("dead")
                        if dead is not None and len(dead):
                            for lo in range(0, len(dead), win):
                                yield (
                                    name, "dead",
                                    dead[lo:lo + win], None, None,
                                )
                        keys = sub.get("keys")
                        if keys is None:
                            continue
                        n = int(np.asarray(keys).shape[0])
                        for lo in range(0, n, win):
                            hi = min(n, lo + win)
                            yield (
                                name, "rows", keys[lo:hi],
                                sub["values"], (sub["freq"], lo, hi),
                            )

        def _prepare(task):
            """Window copy + ownership partition (pool thread, numpy
            only).  Only the window's KEY column (8 B/row) and the
            OWNED value/freq rows ever materialize private — the
            value rows are fancy-indexed straight off the (possibly
            mmap) source view, so the per-window transient is
            ~window/world_size of value bytes, not a full window
            copy."""
            name, kind, keys_v, values_v, freq_ref = task
            keys = np.ascontiguousarray(keys_v, dtype=np.int64)
            mine = owner_of_keys(keys, world_size) == rank
            if kind == "dead":
                return name, kind, keys[mine], None, None, len(keys)
            freq_v, lo, hi = freq_ref
            dim = self._tables[name].dim
            idx = lo + np.flatnonzero(mine)
            values = np.ascontiguousarray(
                np.asarray(values_v).reshape(-1, dim)[idx],
                dtype=np.float32,
            )
            freq = np.ascontiguousarray(
                np.asarray(freq_v)[idx], dtype=np.uint64
            )
            return name, kind, keys[mine], values, freq, len(keys)

        with StagedRestore() as staged:
            for prepared in staged.map_pipelined(
                _prepare, _tasks(), depth=2
            ):
                name, kind, keys, values, freq, n_in = prepared
                chunks += 1
                # chaos hook: a kill here is a worker dying
                # MID-STREAMING-RESHARD — committed storage is
                # untouched (this path only mutates in-process
                # tables), so the replacement replays the identical
                # reshard from the same shards
                _chaos.fire("kv.reshard_chunk", step=chunks)
                table = self._tables[name]
                if kind == "dead":
                    if keys.size:
                        table.delete(keys)
                    continue
                total_rows += n_in
                if keys.size:
                    table.import_(keys, values, freq)
                    rows += int(keys.size)
                    nbytes += (
                        keys.nbytes + values.nbytes + freq.nbytes
                    )
                    if with_digest and not chained:
                        import_sums[name] = (
                            import_sums.get(name, 0)
                            + rows_digest(keys, values, freq)
                        ) % (1 << 64)
                emit_event(
                    "kv_reshard_chunk",
                    table=name, chunk=chunks, rows=int(n_in),
                    owned=int(keys.size), rank=int(rank),
                    step=int(step) if step is not None else None,
                )

        digests: Dict[str, Dict[str, Any]] = {}
        if with_digest:
            win = win_used or 65536
            for name, table in self._tables.items():
                final = 0
                n_rows = 0
                for k, v, f in table.export_chunks(win):
                    final = (
                        final + rows_digest(k, v, f)
                    ) % (1 << 64)
                    n_rows += len(k)
                digests[name] = {
                    "rows": int(n_rows), "sum": f"{final:016x}",
                }
                if not chained and name in import_sums and (
                    final != import_sums[name]
                ):
                    raise RuntimeError(
                        f"streaming reshard of table {name!r} is not "
                        f"exactly-once: additive import digest "
                        f"{import_sums[name]:016x} != final table "
                        f"digest {final:016x} (a chunk was imported "
                        f"twice or a row was lost between windows)"
                    )
        # optimizer scalars from the lowest old rank's LAST link
        scalars = None
        for _r, links in chains.items():
            sc = links[-1].get(SCALARS_KEY)
            if sc:
                scalars = sc
                break
        if scalars:
            for opt in self._optimizers:
                sc = scalars.get(_enc(opt.table.name))
                if sc and hasattr(opt, "load_state_scalars"):
                    opt.load_state_scalars(sc)
        seconds = time.perf_counter() - t0
        _KV_CKPT_SECONDS.observe(seconds, stage="reshard")
        event = dict(
            stage="restore", rows=int(rows), bytes=int(nbytes),
            seconds=round(seconds, 4), tables=len(self._tables),
            resharded=True, from_world=int(from_world),
            world_size=int(world_size), total_rows=int(total_rows),
            tier=tier, streamed=True, chunks=int(chunks),
        )
        if win_used is not None:
            event["window_rows"] = int(win_used)
        if step is not None:
            event["step"] = int(step)
        event["rank"] = int(rank)
        if digests:
            event["digests"] = digests
        emit_event("kv_checkpoint", **event)
        logger.info(
            "streaming kv reshard: %d/%d row(s) owned by rank %d of "
            "world %d (from world %s, %d chunk(s) of %s row(s), "
            "%.3fs, %.1f MB/s)",
            rows, total_rows, rank, world_size, from_world, chunks,
            win_used, seconds,
            (nbytes / 2**20 / seconds) if seconds > 0 else 0.0,
        )
        return {
            "kv_s": round(seconds, 4),
            "kv_rows": int(rows),
            "kv_resharded": True,
            "kv_chunks": int(chunks),
        }

    # -- flat-key helpers (engine's load_sharded path) ----------------------

    @staticmethod
    def split_flat(flat: Dict[str, Any]) -> Tuple[Dict, Dict]:
        """Partition a flat {path: leaf} dict into (kv entries keyed
        RELATIVE to the ``__kv__/`` prefix, the rest)."""
        kv: Dict[str, Any] = {}
        rest: Dict[str, Any] = {}
        for key, val in flat.items():
            if key.startswith(KV_PREFIX):
                kv[key[len(KV_PREFIX):]] = val
            elif key == KV_STATE_KEY:
                # the whole subtree survived as one pickled scalar
                # (nothing array-valued): unwrap it
                if isinstance(val, dict):
                    for k2, v2 in val.items():
                        kv[k2] = v2
            else:
                rest[key] = val
        return kv, rest

    @staticmethod
    def nest_flat(flat: Dict[str, Any]) -> Dict[str, Any]:
        """{"emb/keys": arr, "__scalars__/emb/step": 3} -> nested."""
        root: Dict[str, Any] = {}
        for key, value in flat.items():
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return root
