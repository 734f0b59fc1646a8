"""KvVariable: dynamic-capacity sparse embedding table (ctypes over
the C++ store) and the sparse group optimizers.

Copy of ``dlrover_tpu/ops/kv_variable.py``.  Reference API surface:
TFPlus ``KvVariable`` ops
(``tfplus/tfplus/kv_variable/ops/kv_variable_ops.cc`` — gather/
gather-or-insert/gather-or-zeros, scatter add/sub/mul, import/export,
frequency) and the sparse group optimizers
(``tfplus/tfplus/training/{group_adam,adagrad,group_ftrl}.py``).

Design: the table lives in host memory (the C++ store of
:mod:`dlrover_tpu_torch.native`, the JAX package's source copied byte
for byte, so equal seeds and keys give equal rows in both packages);
the trainer gathers a dense [n, dim] batch on the host and copies it to
the card (:meth:`KvVariable.device_gather`: a pinned buffer, then an
asynchronous host-to-device copy), gradients come back to the host and
the C++ group optimizer updates only the touched keys.  The JAX
package's ``jax_gather`` puts the gather inside a jitted program
through ``io_callback``; eager PyTorch has no program to put it in, so
the port's counterpart is the plain gather and copy.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np

from dlrover_tpu_torch.native import build_library
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_SPILL_FAILURES_GAUGE = _REG.gauge(
    "dlrover_kv_spill_write_failures",
    "Cumulative failed spill-tier writes (disk full / IO error)",
)
_SPILL_DISABLED_GAUGE = _REG.gauge(
    "dlrover_kv_spill_disabled",
    "1 when repeated spill-write failures tripped the cold tier off",
)
_SPILL_DISK_ROWS_GAUGE = _REG.gauge(
    "dlrover_kv_spill_disk_rows", "Rows resident in the cold tier"
)

_lib = None

# Dirty-baseline consumer slots: the serving publisher, the delta
# flash checkpointer and the paged shm tier drain deltas on
# independent cadences — each owns its own dirty/dead baseline on the
# C++ table so no plane can clear rows out of another's next delta.
DIRTY_CONSUMER_SERVING = 0
DIRTY_CONSUMER_CHECKPOINT = 1
DIRTY_CONSUMER_SHM = 2


def _load():
    global _lib
    if _lib is None:
        path = build_library("kv_store")
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.kv_create.restype = ctypes.c_void_p
        lib.kv_create.argtypes = [
            ctypes.c_int, ctypes.c_long, ctypes.c_ulong,
        ]
        lib.kv_destroy.argtypes = [ctypes.c_void_p]
        lib.kv_size.restype = ctypes.c_long
        lib.kv_size.argtypes = [ctypes.c_void_p]
        lib.kv_dim.restype = ctypes.c_int
        lib.kv_dim.argtypes = [ctypes.c_void_p]
        lib.kv_gather.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_long, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.kv_insert.argtypes = [
            ctypes.c_void_p, i64p, f32p, ctypes.c_long,
        ]
        lib.kv_scatter.argtypes = [
            ctypes.c_void_p, i64p, f32p, ctypes.c_long, ctypes.c_int,
        ]
        lib.kv_export.restype = ctypes.c_long
        lib.kv_export.argtypes = [
            ctypes.c_void_p, i64p, f32p, u64p, ctypes.c_long,
        ]
        lib.kv_export_freq.restype = ctypes.c_long
        lib.kv_export_freq.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_long,
        ]
        lib.kv_import.argtypes = [
            ctypes.c_void_p, i64p, f32p, u64p, ctypes.c_long,
        ]
        lib.kv_frequency.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_long, u64p,
        ]
        lib.kv_evict_below.restype = ctypes.c_long
        lib.kv_evict_below.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.kv_spill_enable.restype = ctypes.c_int
        lib.kv_spill_enable.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.kv_spill_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ]
        lib.kv_apply_group_adam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64p, f32p, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_long,
        ]
        lib.kv_apply_group_adagrad.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64p, f32p,
            ctypes.c_long, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,
        ]
        lib.kv_apply_group_ftrl.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64p, f32p, ctypes.c_long, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.kv_clear.argtypes = [ctypes.c_void_p]
        lib.kv_reserve.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.kv_spill_break.argtypes = [ctypes.c_void_p]
        lib.kv_dirty_enable_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.kv_dirty_enabled_c.restype = ctypes.c_int
        lib.kv_dirty_enabled_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.kv_dirty_count_c.restype = ctypes.c_long
        lib.kv_dirty_count_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.kv_dead_count_c.restype = ctypes.c_long
        lib.kv_dead_count_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.kv_export_dirty_c.restype = ctypes.c_long
        lib.kv_export_dirty_c.argtypes = [
            ctypes.c_void_p, i64p, f32p, u64p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.kv_export_dead_c.restype = ctypes.c_long
        lib.kv_export_dead_c.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.kv_clear_dirty_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.kv_export_cursor_new.restype = ctypes.c_void_p
        lib.kv_export_cursor_new.argtypes = [ctypes.c_void_p]
        lib.kv_export_cursor_remaining.restype = ctypes.c_long
        lib.kv_export_cursor_remaining.argtypes = [ctypes.c_void_p]
        lib.kv_export_cursor_free.argtypes = [ctypes.c_void_p]
        lib.kv_export_chunk.restype = ctypes.c_long
        lib.kv_export_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64p, f32p, u64p,
            ctypes.c_long,
        ]
        lib.kv_delete.restype = ctypes.c_long
        lib.kv_delete.argtypes = [ctypes.c_void_p, i64p, ctypes.c_long]
        lib.kv_apply_sparse_sgd.argtypes = [
            ctypes.c_void_p, i64p, f32p, ctypes.c_long, ctypes.c_float,
        ]
        lib.kv_apply_sparse_adam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64p, f32p, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_long,
        ]
        lib.kv_apply_rectified_adam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64p, f32p, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_long,
        ]
        _lib = lib
    return _lib


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class KvVariable:
    """Host-side sparse embedding table."""

    def __init__(self, dim: int, initial_capacity: int = 1024,
                 seed: int = 0, name: str = "kv"):
        self._lib = _load()
        self.dim = dim
        self.name = name
        self._handle = ctypes.c_void_p(
            self._lib.kv_create(dim, initial_capacity, seed)
        )

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.kv_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __len__(self) -> int:
        return int(self._lib.kv_size(self._handle))

    def gather(
        self, keys: np.ndarray, insert_missing: bool = True,
        random_init: bool = True, count_freq: bool = True,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Rows of ``keys`` (missing ones inserted unless told not to).
        ``out``, when given, is the ``[len(keys), dim]`` C-contiguous
        float32 array the rows are written into (a pinned buffer's view,
        :meth:`device_gather`)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        if out is None:
            out = np.empty((keys.size, self.dim), dtype=np.float32)
        elif (out.dtype != np.float32 or out.shape != (keys.size, self.dim)
              or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(
                f"gather out must be a writeable C-contiguous float32 "
                f"[{keys.size}, {self.dim}] array, got {out.dtype}"
                f"{list(out.shape)}")
        self._lib.kv_gather(
            self._handle, _i64(keys), keys.size, _f32(out),
            int(insert_missing), int(random_init), int(count_freq),
        )
        return out

    def gather_or_zeros(self, keys: np.ndarray) -> np.ndarray:
        return self.gather(keys, insert_missing=False,
                           random_init=False, count_freq=False)

    def insert(self, keys: np.ndarray, values: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        values = np.ascontiguousarray(values, dtype=np.float32)
        self._lib.kv_insert(
            self._handle, _i64(keys), _f32(values), keys.size
        )

    def scatter_add(self, keys, values):
        self._scatter(keys, values, 0)

    def scatter_sub(self, keys, values):
        self._scatter(keys, values, 1)

    def scatter_mul(self, keys, values):
        self._scatter(keys, values, 2)

    def _scatter(self, keys, values, op: int):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        values = np.ascontiguousarray(values, dtype=np.float32)
        self._lib.kv_scatter(
            self._handle, _i64(keys), _f32(values), keys.size, op
        )

    def enable_spill(self, path: str, max_dram_rows: int) -> None:
        """Turn on the hybrid two-tier storage (reference: tfplus
        hybrid_embedding/table_manager.h): DRAM keeps at most
        ``max_dram_rows`` hot rows; frequency-cold rows spill to the
        record file at ``path`` and are transparently promoted back
        on gather miss.  Gather/scatter/optimizer semantics are
        unchanged — only residence moves."""
        rc = self._lib.kv_spill_enable(
            self._handle, path.encode(), max_dram_rows
        )
        if rc == -2:
            raise ValueError(
                "spill already enabled with a different path; "
                "re-calling with the SAME path adjusts the DRAM "
                "budget, replacing the tier would orphan the "
                "disk-resident rows"
            )
        if rc != 0:
            raise OSError(f"cannot open spill file {path!r}")

    def spill_stats(self) -> dict:
        out = (ctypes.c_long * 6)()
        self._lib.kv_spill_stats(self._handle, out)
        stats = {
            "disk_rows": int(out[0]),
            "spills": int(out[1]),
            "promotions": int(out[2]),
            "dram_rows": int(out[3]),
            "write_failures": int(out[4]),
            "disabled": bool(out[5]),
        }
        # write-through to the telemetry registry so the master
        # endpoint / agent textfile surface the failure breaker
        # without a separate polling path
        _SPILL_FAILURES_GAUGE.set(
            stats["write_failures"], table=self.name
        )
        _SPILL_DISABLED_GAUGE.set(
            1.0 if stats["disabled"] else 0.0, table=self.name
        )
        _SPILL_DISK_ROWS_GAUGE.set(stats["disk_rows"], table=self.name)
        return stats

    def frequency(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        out = np.zeros(keys.size, dtype=np.uint64)
        self._lib.kv_frequency(
            self._handle, _i64(keys), keys.size, _u64(out)
        )
        return out

    def evict_below(self, min_freq: int) -> int:
        return int(
            self._lib.kv_evict_below(self._handle, min_freq)
        )

    def evict_to_capacity(self, max_rows: int) -> int:
        """Frequency-ordered overflow policy: evict coldest rows until
        ~``max_rows`` remain (reference: the kv-variable
        frequency/overflow policies, tfplus
        kv_variable_ops.cc:37 / kernels/kv_variable.h:89).

        Ties at the threshold are kept WHOLE: evicting a frequency
        class is all-or-nothing, so the cutoff backs off until at
        least one row survives — the table may stay over budget when
        a tie class straddles it, but learned state is never wiped
        (an all-equal-frequency table, e.g. epoch one, evicts
        nothing).  Only the frequency column is exported for the
        threshold computation."""
        if len(self) <= max_rows:
            return 0
        freq = self.export_freq()
        # size the threshold math from the exported snapshot, not the
        # pre-export row count — a concurrent jitted gather can grow
        # or shrink the table between the two calls
        n = len(freq)
        if n <= max_rows:
            return 0
        order = np.sort(freq)
        cutoff = int(order[n - max_rows - 1]) + 1
        # rows surviving this cutoff; back off while it would wipe
        # the table (tie class at the top)
        keep = 0
        while cutoff > 0:
            keep = n - int(np.searchsorted(order, cutoff, "left"))
            if keep > 0:
                break
            cutoff -= 1
        if cutoff <= 0 or keep == n:
            return 0  # nothing evictable without losing a whole class
        return self.evict_below(cutoff)

    def export_freq(self) -> np.ndarray:
        """Frequency column only — no key/value materialization (an
        eviction decision on a big table must not allocate the whole
        embedding matrix)."""
        n = len(self)
        freq = np.empty(n, dtype=np.uint64)
        got = self._lib.kv_export_freq(self._handle, _u64(freq), n)
        return freq[:got]

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = len(self)
        keys = np.empty(n, dtype=np.int64)
        values = np.empty((n, self.dim), dtype=np.float32)
        freq = np.empty(n, dtype=np.uint64)
        got = self._lib.kv_export(
            self._handle, _i64(keys), _f32(values), _u64(freq), n
        )
        return keys[:got], values[:got], freq[:got]

    # -- chunked bulk transfer (O(window) value memory) ---------------------

    def export_chunks(self, max_rows: int):
        """Generator of ``(keys, values, freq)`` windows covering the
        whole logical table (both tiers) without ever materializing
        more than ``max_rows`` value rows at once — the bulk-export
        primitive of streaming reshard and chunked checkpoint paths.

        The native cursor snapshots only the KEY column at the first
        call (8 B/row — the same O(rows) footprint class as
        :meth:`export_freq`) and stays valid across spill residence
        moves between chunks; spilled rows are read in place, keys
        evicted after the snapshot are skipped.  Each yielded window
        is a fresh private array set — callers may hold or mutate it
        freely."""
        max_rows = max(1, int(max_rows))
        cursor = ctypes.c_void_p(
            self._lib.kv_export_cursor_new(self._handle)
        )
        try:
            while True:
                keys = np.empty(max_rows, dtype=np.int64)
                values = np.empty(
                    (max_rows, self.dim), dtype=np.float32
                )
                freq = np.empty(max_rows, dtype=np.uint64)
                got = int(self._lib.kv_export_chunk(
                    self._handle, cursor, _i64(keys), _f32(values),
                    _u64(freq), max_rows,
                ))
                if got <= 0:
                    break
                out = (keys[:got], values[:got], freq[:got])
                # drop the generator's own refs BEFORE yielding: a
                # caller that releases the window promptly then pays
                # for ONE live window during the next chunk's
                # allocation, not two (the streamed writers' RSS
                # bound leans on this)
                keys = values = freq = None
                yield out
                out = None
                if got < max_rows and not int(
                    self._lib.kv_export_cursor_remaining(cursor)
                ):
                    break
        finally:
            self._lib.kv_export_cursor_free(cursor)

    def import_chunked(
        self, keys, values, freq=None, max_rows: int = 65536,
    ) -> int:
        """Windowed :meth:`import_`: slices of at most ``max_rows``
        rows go through the native import one window at a time, so a
        caller streaming from mmap-backed views never forces the
        whole blob contiguous in RAM at once (each window is the only
        private copy).  The spill pass runs per window with the usual
        10% hysteresis, so DRAM stays bounded DURING the import, not
        just after it.  Returns rows imported."""
        keys = np.asarray(keys)
        n = int(keys.shape[0])
        max_rows = max(1, int(max_rows))
        for lo in range(0, n, max_rows):
            hi = min(n, lo + max_rows)
            self.import_(
                keys[lo:hi],
                np.asarray(values)[lo:hi],
                None if freq is None else np.asarray(freq)[lo:hi],
            )
        return n

    def reserve(self, n: int) -> None:
        """Pre-size the hash table and slab for ~``n`` more rows so a
        chunked import pays no mid-stream rehash storms."""
        self._lib.kv_reserve(self._handle, int(n))

    # -- dirty-row delta surface (per-consumer incremental export) ----------

    def enable_dirty_tracking(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> None:
        """Arm dirty/dead tracking for one consumer slot (the serving
        publisher arms :data:`DIRTY_CONSUMER_SERVING`, the delta
        flash checkpointer :data:`DIRTY_CONSUMER_CHECKPOINT` — the
        two planes baseline independently).  OPT-IN: untracked jobs
        pay nothing on the optimizer hot path and accumulate no set
        overhead.  Mutations before arming are not tracked — baseline
        with a full snapshot (the first publish/export is always a
        base)."""
        self._lib.kv_dirty_enable_c(self._handle, int(consumer))

    def dirty_tracking_enabled(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> bool:
        return bool(
            self._lib.kv_dirty_enabled_c(self._handle, int(consumer))
        )

    def dirty_count(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> int:
        """Rows touched (value or frequency) since this consumer's
        last cleared delta export — the next delta's size, and the
        bound on its export stall (O(rows touched), never
        O(table))."""
        return int(
            self._lib.kv_dirty_count_c(self._handle, int(consumer))
        )

    def dead_count(
        self, consumer: int = DIRTY_CONSUMER_SERVING
    ) -> int:
        """Deletion tombstones (evicted keys) accumulated since this
        consumer's last cleared delta export."""
        return int(
            self._lib.kv_dead_count_c(self._handle, int(consumer))
        )

    def export_dirty(
        self, clear: bool = False,
        consumer: int = DIRTY_CONSUMER_SERVING,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Export only the rows touched since this consumer's last
        cleared delta (spill-tier rows read in place, no promotion).
        With ``clear``, exactly the exported keys leave the dirty set
        atomically with the export — a concurrent mutation stays
        dirty for the NEXT delta instead of silently vanishing."""
        chunks = []
        while True:
            n = self.dirty_count(consumer)
            if n == 0:
                break
            keys = np.empty(n, dtype=np.int64)
            values = np.empty((n, self.dim), dtype=np.float32)
            freq = np.empty(n, dtype=np.uint64)
            got = self._lib.kv_export_dirty_c(
                self._handle, _i64(keys), _f32(values), _u64(freq),
                n, int(clear), int(consumer),
            )
            chunks.append((keys[:got], values[:got], freq[:got]))
            # without clear, one pass covers the snapshot; with
            # clear, loop until the set drains (mutations racing the
            # export can top it back up — they belong to this delta
            # only if we catch them, the next one otherwise)
            if not clear or self.dirty_count(consumer) == 0:
                break
        if not chunks:
            return (
                np.empty(0, np.int64),
                np.empty((0, self.dim), np.float32),
                np.empty(0, np.uint64),
            )
        if len(chunks) == 1:
            return chunks[0]
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
            np.concatenate([c[2] for c in chunks]),
        )

    def export_dead(
        self, clear: bool = False,
        consumer: int = DIRTY_CONSUMER_SERVING,
    ) -> np.ndarray:
        """The delta's deletion tombstones."""
        n = self.dead_count(consumer)
        keys = np.empty(n, dtype=np.int64)
        got = self._lib.kv_export_dead_c(
            self._handle, _i64(keys), n, int(clear), int(consumer)
        )
        return keys[:got]

    def clear_dirty(self, consumer: int = DIRTY_CONSUMER_SERVING):
        """Reset this consumer's delta sets (a full-snapshot export
        baselines its next delta).  Other consumers' baselines are
        untouched — the two planes never clear each other."""
        self._lib.kv_clear_dirty_c(self._handle, int(consumer))

    def delete(self, keys) -> int:
        """Remove specific keys from either tier (delta tombstone
        apply on a serving replica); returns how many existed."""
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        if keys.size == 0:
            return 0
        return int(
            self._lib.kv_delete(self._handle, _i64(keys), keys.size)
        )

    def import_(self, keys, values, freq=None):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        values = np.ascontiguousarray(values, dtype=np.float32)
        freq_arr = (
            np.ascontiguousarray(freq, dtype=np.uint64)
            if freq is not None
            else np.zeros(keys.size, dtype=np.uint64)
        )
        self._lib.kv_import(
            self._handle, _i64(keys), _f32(values), _u64(freq_arr),
            keys.size,
        )

    def clear(self):
        """Drop every row on both tiers.  Checkpoint import REPLACES
        table state (a resharded restore must hold exactly the owned
        subset — leftover rows from a previous world would be phantom
        duplicates of rows the key-hash partition assigned to another
        rank)."""
        self._lib.kv_clear(self._handle)

    def _break_spill_tier(self):
        """Fault-injection hook (chaos ``io_error`` on the spill
        tier): make the cold tier's backing device fail like a dead
        disk — subsequent spill writes error out (tripping the
        production write-failure breaker), stranded cold records read
        back short and are skipped by export.  DRAM rows are
        untouched."""
        self._lib.kv_spill_break(self._handle)

    # -- device bridge -----------------------------------------------------

    def device_gather(self, keys, device, insert_missing: bool = True):
        """The gather of ``keys`` as a ``[*keys.shape, dim]`` float32
        tensor on ``device``: on a CUDA device the rows are gathered
        straight into a pinned buffer, which is copied with
        ``non_blocking=True`` (the copy is queued on the current stream,
        which orders every later use of the result after it).  With
        ``insert_missing=False`` the gather is side-effect free
        (:meth:`gather_or_zeros`)."""
        import torch

        keys = np.asarray(keys)
        device = torch.device(device)
        host = torch.empty((keys.size, self.dim), dtype=torch.float32,
                           pin_memory=device.type == "cuda")
        if insert_missing:
            self.gather(keys, out=host.numpy())
        else:
            self.gather(keys, insert_missing=False, random_init=False,
                        count_freq=False, out=host.numpy())
        return host.reshape(*keys.shape, self.dim).to(
            device, non_blocking=True)


class GroupAdamOptimizer:
    """Sparse Adam over a KvVariable (reference:
    ``GroupAdamOptimizer``, tfplus/training/group_adam.py:28) —
    moment tables share the key space; only touched keys update."""

    def __init__(self, table: KvVariable, learning_rate: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self._lib = _load()
        self.table = table
        self.m = KvVariable(table.dim, name=f"{table.name}/m")
        self.v = KvVariable(table.dim, name=f"{table.name}/v")
        self.lr = learning_rate
        self.beta1, self.beta2 = beta1, beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.step = 0

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        self.step += 1
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_group_adam(
            self.table._handle, self.m._handle, self.v._handle,
            _i64(keys), _f32(grads), keys.size,
            self.lr, self.beta1, self.beta2, self.eps,
            self.weight_decay, self.step,
        )

    def enable_spill(self, directory: str, max_dram_rows: int) -> None:
        """Spill the moment tables alongside the (separately
        configured or not) parameter table — training past DRAM
        needs ALL per-key state bounded, not just the embeddings."""
        _enable_slot_spill(self, directory, max_dram_rows)

    def slot_tables(self):
        """Optimizer-state tables keyed by slot name — the sparse
        checkpoint adapter registers them next to the parameter table
        so a restore brings the moments back bit-exact."""
        return {"m": self.m, "v": self.v}

    def state_scalars(self):
        """Non-table optimizer state (the bias-correction step
        counter) — without it a restored Adam replays with the wrong
        correction and the loss trajectory forks from the control."""
        return {"step": int(self.step)}

    def load_state_scalars(self, scalars):
        self.step = int(scalars.get("step", self.step))


def _enable_slot_spill(optimizer, directory: str, max_dram_rows: int):
    """Shared slot-table spill wiring: every slot spills to its own
    record file named after the parameter table and the slot."""
    import os as _os

    base = optimizer.table.name.replace("/", "_")
    for slot, table in optimizer.slot_tables().items():
        table.enable_spill(
            _os.path.join(directory, f"{base}_{slot}.spill"),
            max_dram_rows,
        )


class GroupAdagradOptimizer:
    """Sparse Adagrad (reference: tfplus/training/adagrad.py)."""

    def __init__(self, table: KvVariable, learning_rate: float = 0.1,
                 initial_accumulator: float = 0.1, eps: float = 1e-10):
        self._lib = _load()
        self.table = table
        self.acc = KvVariable(table.dim, name=f"{table.name}/acc")
        self.lr = learning_rate
        self.init_acc = initial_accumulator
        self.eps = eps

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_group_adagrad(
            self.table._handle, self.acc._handle, _i64(keys),
            _f32(grads), keys.size, self.lr, self.init_acc, self.eps,
        )

    def enable_spill(self, directory: str, max_dram_rows: int) -> None:
        _enable_slot_spill(self, directory, max_dram_rows)

    def slot_tables(self):
        return {"acc": self.acc}


class GroupFtrlOptimizer:
    """Sparse FTRL (reference: tfplus/training/group_ftrl.py)."""

    def __init__(self, table: KvVariable, learning_rate: float = 0.1,
                 l1: float = 0.0, l2: float = 0.0):
        self._lib = _load()
        self.table = table
        self.z = KvVariable(table.dim, name=f"{table.name}/z")
        self.n = KvVariable(table.dim, name=f"{table.name}/n")
        self.lr = learning_rate
        self.l1, self.l2 = l1, l2

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_group_ftrl(
            self.table._handle, self.z._handle, self.n._handle,
            _i64(keys), _f32(grads), keys.size, self.lr, self.l1,
            self.l2, -0.5,
        )

    def enable_spill(self, directory: str, max_dram_rows: int) -> None:
        _enable_slot_spill(self, directory, max_dram_rows)

    def slot_tables(self):
        return {"z": self.z, "n": self.n}


class SparseSGDOptimizer:
    """Plain sparse SGD (reference: tfplus
    training/gradient_descent.py) — no slot tables; the cheapest
    sparse trainer for frequency-skewed tails."""

    def __init__(self, table: KvVariable, learning_rate: float = 0.1):
        self._lib = _load()
        self.table = table
        self.lr = learning_rate

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_sparse_sgd(
            self.table._handle, _i64(keys), _f32(grads), keys.size,
            self.lr,
        )

    def slot_tables(self):
        return {}


class SparseAdamOptimizer:
    """Plain sparse Adam (reference: tfplus training/adam.py):
    standard Adam whose bias correction rides the learning rate
    (``lr_t = lr * sqrt(1-b2^t)/(1-b1^t)``), vs the group flavour's
    per-dimension moment correction + decoupled weight decay."""

    def __init__(self, table: KvVariable, learning_rate: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self._lib = _load()
        self.table = table
        self.m = KvVariable(table.dim, name=f"{table.name}/m")
        self.v = KvVariable(table.dim, name=f"{table.name}/v")
        self.lr = learning_rate
        self.beta1, self.beta2 = beta1, beta2
        self.eps = eps
        self.step = 0

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        self.step += 1
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_sparse_adam(
            self.table._handle, self.m._handle, self.v._handle,
            _i64(keys), _f32(grads), keys.size,
            self.lr, self.beta1, self.beta2, self.eps, self.step,
        )

    def enable_spill(self, directory: str, max_dram_rows: int) -> None:
        _enable_slot_spill(self, directory, max_dram_rows)

    def slot_tables(self):
        return {"m": self.m, "v": self.v}

    def state_scalars(self):
        return {"step": int(self.step)}

    def load_state_scalars(self, scalars):
        self.step = int(scalars.get("step", self.step))


class RectifiedAdamOptimizer:
    """Sparse RAdam (reference: tfplus training/rectified_adam.py /
    Liu et al. 2019): the adaptive term engages only once the
    variance rectification ``r_t`` is defined (``rho_t > 4``); early
    steps fall back to bias-corrected momentum SGD — warm-up without
    a schedule, exactly the regime a freshly inserted embedding row
    lives in."""

    def __init__(self, table: KvVariable, learning_rate: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self._lib = _load()
        self.table = table
        self.m = KvVariable(table.dim, name=f"{table.name}/m")
        self.v = KvVariable(table.dim, name=f"{table.name}/v")
        self.lr = learning_rate
        self.beta1, self.beta2 = beta1, beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.step = 0

    def apply_gradients(self, keys: np.ndarray, grads: np.ndarray):
        self.step += 1
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        self._lib.kv_apply_rectified_adam(
            self.table._handle, self.m._handle, self.v._handle,
            _i64(keys), _f32(grads), keys.size,
            self.lr, self.beta1, self.beta2, self.eps,
            self.weight_decay, self.step,
        )

    def enable_spill(self, directory: str, max_dram_rows: int) -> None:
        _enable_slot_spill(self, directory, max_dram_rows)

    def slot_tables(self):
        return {"m": self.m, "v": self.v}

    def state_scalars(self):
        return {"step": int(self.step)}

    def load_state_scalars(self, scalars):
        self.step = int(scalars.get("step", self.step))
