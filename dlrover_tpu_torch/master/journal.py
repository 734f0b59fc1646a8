"""Crash-consistent master state journal.

Copy of ``dlrover_tpu/master/journal.py`` (the port imports nothing of
the JAX package).

Role of the reference's master persistence (``dlrover/python/master/
servicer.py`` + ``master_kv_store.py``, which survive master restarts
by writing job/task state to a KV store): the master is the one
process with no supervisor-level recovery story, so every control-
plane mutation — node table transitions, rendezvous round
completions, dataset shard dispatch/ack, KV writes, terminal exit
decisions — is journaled to an append-only, checksummed record log
the respawned master replays.

On-disk layout (``DLROVER_MASTER_JOURNAL_DIR``)::

    snapshot.json      last full-state snapshot (atomic tmp+rename)
    snapshot.json.bak  previous snapshot (fallback if the last one
                       is unreadable)
    journal.log        MAGIC header + incremental records since the
                       snapshot

Record framing: ``>II`` (payload length, CRC32 of payload) followed by
the UTF-8 JSON payload ``{"s": seq, "k": kind, "d": data}``.  Appends
are flushed and ``fsync``'d before the mutation is acknowledged, so a
SIGKILL never loses an acked record.  Replay reads records until the
first length/CRC mismatch or EOF — a torn tail (the crash interrupted
the final write) truncates to the last whole record instead of
raising, which makes recovery *prefix-consistent*: either a record is
fully visible or it (and everything after it) is gone; a decision
that was never durably written can never be resurrected.

``DLROVER_JOURNAL_FSYNC_WINDOW_S`` > 0 applies the mirror's
group-commit trick to the LOCAL hot path: appends flush to the page
cache and a background flusher fsyncs the batch once per window —
per-append durability cost drops from an fsync to a write (the win
shows in ``dlrover_master_journal_fsync_seconds``).  A master SIGKILL
still loses nothing (the page cache outlives the process); only a
host power cut can eat the last window, and the :data:`DURABLE_KINDS`
terminal decisions (``job_exit`` / ``decision`` / ``resize``) keep
per-append fsync regardless, so an acted-on decision is never
resurrectable-by-omission.  Default 0: every append fsyncs, exactly
the pre-window semantics.

Sequence numbers make snapshot+log replay idempotent: the snapshot
stores the seq it folded in, and replay skips log records at or below
it, so a crash between "snapshot renamed" and "log truncated" cannot
double-apply entries.

**Mirror (host-portable control plane).**  The local journal makes the
master crash-safe; it does not make it *host-portable* — a replacement
master on a different machine cannot read a dead host's local disk.
``DLROVER_MASTER_JOURNAL_MIRROR_DIR`` points the journal at a second
directory on the checkpoint storage tier (the one filesystem every
deployment already shares): appends are batched to it by a daemon
thread with **async group commit** — one write+fsync per batch every
``DLROVER_JOURNAL_MIRROR_INTERVAL_S`` (default 0.25 s) — so the hot
path's per-append fsync never waits on the (possibly remote) mirror.
The mirror therefore lags the local log by at most one group-commit
window; its tail may be torn mid-frame, and replay's prefix
consistency handles both — a mirror restore is simply a restore of a
slightly older, equally-consistent journal.  A master spawned with a
FRESH local journal dir and the mirror dir configured seeds the local
dir from the mirror before replaying — that is the respawn-on-a-
different-host path (the last single-host dependency in the recovery
story).
"""

import json
import os
import shutil
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing as trace
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

JOURNAL_DIR_ENV = "DLROVER_MASTER_JOURNAL_DIR"
JOURNAL_MIRROR_DIR_ENV = "DLROVER_MASTER_JOURNAL_MIRROR_DIR"
JOURNAL_MIRROR_INTERVAL_ENV = "DLROVER_JOURNAL_MIRROR_INTERVAL_S"
JOURNAL_FSYNC_WINDOW_ENV = "DLROVER_JOURNAL_FSYNC_WINDOW_S"

# kinds that keep per-append fsync even under a group-commit window:
# terminal decisions whose durability-before-action the recovery
# semantics depend on (a replayed master honors a journaled job_exit
# instead of resurrecting the job; a resize is journaled BEFORE the
# drain it triggers) — losing the last window of node heartbeats to a
# power cut is harmless, losing an acted-on decision is not
DURABLE_KINDS = frozenset({"job_exit", "decision", "resize"})

MAGIC = b"DLRVJRN1\n"
_REC = struct.Struct(">II")  # payload length, CRC32(payload)
_LOG_NAME = "journal.log"
_SNAP_NAME = "snapshot.json"

_REG = get_registry()
_ENTRIES_TOTAL = _REG.counter(
    "dlrover_master_journal_entries_total",
    "Journal records appended, by kind",
)
_FSYNC_SECONDS = _REG.histogram(
    "dlrover_master_journal_fsync_seconds",
    "Durability cost of one journal append (flush + fsync)",
)
_SNAPSHOTS_TOTAL = _REG.counter(
    "dlrover_master_journal_snapshots_total",
    "Full-state snapshots written (log rotations)",
)
_MIRROR_FLUSH_SECONDS = _REG.histogram(
    "dlrover_master_journal_mirror_flush_seconds",
    "One async group commit of pending records to the journal mirror",
)
_MIRROR_LAG_SECONDS = _REG.gauge(
    "dlrover_master_journal_mirror_lag_seconds",
    "Age of the oldest record the mirror had not yet flushed at the "
    "last group commit (bounded by the group-commit window)",
)
# fleet fan-in split: the journal's single io lock is the master's
# hot-append serialization point — under hundreds of agents, time
# spent WAITING for the lock (queueing) is distinct from time spent
# writing/fsyncing (io), and the scoreboard reads both
_LOCK_WAIT_SECONDS = _REG.histogram(
    "dlrover_master_journal_lock_wait_seconds",
    "Time an append spent waiting for the journal io lock (the "
    "queueing half of dlrover_master_journal_fsync_seconds)",
)
_PENDING_FSYNC = _REG.gauge(
    "dlrover_master_journal_pending_fsync",
    "Appends written to the page cache but not yet fsync'd under "
    "DLROVER_JOURNAL_FSYNC_WINDOW_S (0 when the window is off)",
)
_MIRROR_QUEUE_DEPTH = _REG.gauge(
    "dlrover_master_journal_mirror_queue",
    "Records enqueued for the mirror's next group commit",
)


@dataclass
class JournalReplay:
    """What a respawned master gets back from the journal."""

    snapshot: Optional[Dict[str, Any]] = None
    snapshot_seq: int = 0
    entries: List[Tuple[int, str, Dict[str, Any]]] = field(
        default_factory=list
    )
    last_seq: int = 0
    truncated: bool = False  # a torn/corrupt tail was discarded
    good_offset: int = 0  # byte offset of the last whole record

    @property
    def has_state(self) -> bool:
        return self.snapshot is not None or bool(self.entries)


def _snapshot_doc(seq: int, state: Dict[str, Any]) -> bytes:
    body = json.dumps({"seq": seq, "state": state}, default=str)
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return json.dumps({"crc": crc, "doc": body}).encode("utf-8")


def _read_snapshot(path: str) -> Optional[Tuple[int, Dict[str, Any]]]:
    try:
        with open(path, "rb") as f:
            wrapper = json.loads(f.read().decode("utf-8"))
        body = wrapper["doc"]
        crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
        if crc != int(wrapper["crc"]):
            logger.warning("journal snapshot %s failed CRC", path)
            return None
        doc = json.loads(body)
        return int(doc["seq"]), doc["state"]
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _iter_frames(blob: bytes):
    """Yield ``(seq, record_dict, raw_frame_bytes)`` for each whole,
    CRC-valid record in a log blob; stops at the first torn/corrupt
    frame.  The single framing walk shared by replay and rotation —
    both must agree on where the valid prefix ends.  Raw frame bytes
    let rotation re-write surviving records without re-encoding."""
    if not blob.startswith(MAGIC):
        return
    off = len(MAGIC)
    while off + _REC.size <= len(blob):
        length, crc = _REC.unpack_from(blob, off)
        start = off + _REC.size
        end = start + length
        if length > 64 * 1024 * 1024 or end > len(blob):
            return
        payload = blob[start:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return
        try:
            rec = json.loads(payload.decode("utf-8"))
            seq = int(rec["s"])
        except (ValueError, KeyError, TypeError):
            return
        yield seq, rec, blob[off:end]
        off = end


def replay_dir(journal_dir: str) -> JournalReplay:
    """Read snapshot + log back into a :class:`JournalReplay`.

    Never raises past recovery: an unreadable snapshot falls back to
    the previous one (``.bak``); a torn or corrupted log tail ends the
    entry list at the last whole record (prefix consistency)."""
    out = JournalReplay()
    with trace.span("journal.replay", dir=journal_dir):
        snap_path = os.path.join(journal_dir, _SNAP_NAME)
        snap = _read_snapshot(snap_path)
        if snap is None:
            snap = _read_snapshot(snap_path + ".bak")
        if snap is not None:
            out.snapshot_seq, out.snapshot = snap
            out.last_seq = out.snapshot_seq
        log_path = os.path.join(journal_dir, _LOG_NAME)
        try:
            with open(log_path, "rb") as f:
                blob = f.read()
        except OSError:
            return out
        if not blob.startswith(MAGIC):
            if blob:
                out.truncated = True
            return out
        out.good_offset = len(MAGIC)
        for seq, rec, frame in _iter_frames(blob):
            out.good_offset += len(frame)
            if seq <= out.snapshot_seq or seq <= out.last_seq:
                # already folded into the snapshot (crash between
                # snapshot rename and log rotation), or a stale
                # duplicate — skip, never double-apply
                continue
            out.entries.append(
                (seq, str(rec.get("k", "")), rec.get("d") or {})
            )
            out.last_seq = seq
        if out.good_offset != len(blob):
            out.truncated = True
        emit_event(
            "journal_replay",
            dir=journal_dir,
            entries=len(out.entries),
            snapshot_seq=out.snapshot_seq,
            last_seq=out.last_seq,
            truncated=out.truncated,
        )
    return out


def seed_journal_from_mirror(journal_dir: str, mirror_dir: str) -> bool:
    """Copy the mirror's snapshot + log into an EMPTY local journal
    dir — the different-host respawn path: the dead master's local
    disk is gone, the storage-tier mirror is all that survives.  A
    local dir that already has state wins (same-host respawn: the
    local log is fresher than the lagging mirror); returns whether the
    seed happened."""
    local = replay_dir(journal_dir)
    if local.has_state:
        return False
    mirrored = replay_dir(mirror_dir)
    if not mirrored.has_state:
        return False
    os.makedirs(journal_dir, exist_ok=True)
    for name in (_SNAP_NAME, _SNAP_NAME + ".bak", _LOG_NAME):
        src = os.path.join(mirror_dir, name)
        if not os.path.exists(src):
            continue
        tmp = os.path.join(journal_dir, name + ".seed")
        shutil.copyfile(src, tmp)
        os.replace(tmp, os.path.join(journal_dir, name))
    logger.warning(
        "journal dir %s seeded from mirror %s (snapshot seq %s, "
        "%s entries%s)",
        journal_dir, mirror_dir, mirrored.snapshot_seq,
        len(mirrored.entries),
        ", torn tail discarded" if mirrored.truncated else "",
    )
    return True


class _JournalMirror:
    """Async group-commit replica of the journal in a second directory
    (the checkpoint storage tier).  The hot append path only enqueues
    the already-framed record bytes; a daemon thread batches pending
    frames into ONE write+fsync per group-commit window, so mirror
    latency never rides the RPC handlers the way the local fsync
    (deliberately) does.  Rotation tasks rewrite the mirror atomically
    the same way the local log rotates."""

    def __init__(
        self,
        mirror_dir: str,
        interval_s: float = 0.25,
        local_dir: Optional[str] = None,
    ):
        self.dir = mirror_dir
        self.interval_s = max(0.01, interval_s)
        # the local journal this mirror replicates: the repair source
        # when a flush fails (see _resync_from_local)
        self._local_dir = local_dir
        os.makedirs(mirror_dir, exist_ok=True)
        self._log_path = os.path.join(mirror_dir, _LOG_NAME)
        self._snap_path = os.path.join(mirror_dir, _SNAP_NAME)
        # truncate any torn mirror tail NOW: appending after garbage
        # would bury every later record past the point replay stops
        existing = replay_dir(mirror_dir)
        mode = "ab"
        if not os.path.exists(self._log_path) or (
            existing.good_offset < len(MAGIC)
        ):
            mode = "wb"
        self._fh = open(self._log_path, mode)
        if mode == "wb" or self._fh.tell() == 0:
            self._fh.write(MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        elif existing.good_offset < self._fh.tell():
            self._fh.truncate(existing.good_offset)
            self._fh.seek(0, os.SEEK_END)
        # ordered task queue: ("append", frame, ts) | ("snapshot",
        # doc_bytes, tail_bytes, ts); order preserved so a rotation
        # never swallows an append that followed it
        self._tasks: List[tuple] = []
        self._cv = threading.Condition()
        self._stopped = False
        self._wake = False
        self._inflight = False
        self._resync = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="journal-mirror"
        )
        self._thread.start()

    # -- producer side (called under the journal's io lock) -------------

    def enqueue_append(self, frame: bytes):
        with self._cv:
            self._tasks.append(("append", frame, time.monotonic()))
            _MIRROR_QUEUE_DEPTH.set(len(self._tasks))
            # no notify: appends ride the next interval tick — THAT is
            # the group commit; only rotation/flush wake the thread

    def enqueue_snapshot(self, doc: bytes, tail: bytes):
        with self._cv:
            self._tasks.append(
                ("snapshot", doc, tail, time.monotonic())
            )
            self._wake = True
            self._cv.notify()

    def request_resync(self):
        """Schedule a full rebuild of the mirror from the local
        journal files — the repair path after a failed flush, and the
        first-arming path when the local dir already has state the
        mirror never saw."""
        with self._cv:
            self._resync = True

    # -- consumer ---------------------------------------------------------

    def _drain(self) -> List[tuple]:
        with self._cv:
            tasks, self._tasks = self._tasks, []
            _MIRROR_QUEUE_DEPTH.set(0)
        return tasks

    def _loop(self):
        while True:
            with self._cv:
                # pace to the group-commit window even under a steady
                # append stream — ONE write+fsync per interval, not
                # one per fsync latency; rotation/flush/close bypass
                # the wait via _wake
                if not self._stopped and not self._wake:
                    self._cv.wait(timeout=self.interval_s)
                self._wake = False
                if (
                    self._stopped
                    and not self._tasks
                    and not self._resync
                ):
                    return
            self._flush_once()

    def _flush_once(self):
        with self._cv:
            self._inflight = True
        try:
            self._flush_batch()
        finally:
            with self._cv:
                self._inflight = False
                self._cv.notify_all()

    def _flush_batch(self):
        if self._resync:
            # drain FIRST: every frame enqueued before this point is
            # already in the local files the resync copies (the local
            # append precedes the enqueue under the journal's io
            # lock), so discarding here cannot open a gap — at worst
            # a frame lands twice, which replay's seq filter skips
            self._drain()
            if not self._resync_from_local():
                if self._stopped:
                    # shutdown with the mirror tier dead: give up —
                    # the mirror stays stale but consistent, and the
                    # next incarnation's arming resyncs it
                    with self._cv:
                        self._resync = False
                return
            with self._cv:
                self._resync = False
        tasks = self._drain()
        if not tasks:
            return
        t0 = time.monotonic()
        oldest = min(t[-1] for t in tasks)
        appended = 0
        try:
            batch = b""
            for task in tasks:
                if task[0] == "append":
                    batch += task[1]
                    appended += 1
                    continue
                # rotation: flush whatever preceded it, then rewrite
                if batch:
                    self._fh.write(batch)
                    batch = b""
                self._rotate(task[1], task[2])
            if batch:
                self._fh.write(batch)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            # a browned-out mirror must not kill the thread: the local
            # journal is still durable.  A partial write (or a rotate
            # that died with the handle closed — hence ValueError)
            # would leave a seq GAP if we just kept appending, and a
            # gapped mirror is NOT a consistent prefix — so schedule a
            # full resync from the local files instead; until it
            # succeeds the mirror is stale but never inconsistent
            logger.exception(
                "journal mirror flush failed; mirror will resync "
                "from the local journal"
            )
            with self._cv:
                self._resync = True
            return
        lag = time.monotonic() - oldest
        _MIRROR_FLUSH_SECONDS.observe(time.monotonic() - t0)
        _MIRROR_LAG_SECONDS.set(lag)
        emit_event(
            "journal_mirror_flush",
            records=appended,
            lag_s=round(lag, 4),
            dir=self.dir,
        )

    def _resync_from_local(self) -> bool:
        """Rebuild the mirror as a byte copy of the local journal
        (snapshot + ``.bak`` + the log's whole-frame prefix).  The log
        copy is truncated at the last whole frame: a torn tail read
        mid-append belongs to a record whose mirror enqueue happened
        after the caller's drain, so it arrives again through the
        queue — nothing is buried behind garbage."""
        if not self._local_dir:
            return False
        try:
            for name in (_SNAP_NAME, _SNAP_NAME + ".bak"):
                src = os.path.join(self._local_dir, name)
                if not os.path.exists(src):
                    continue
                tmp = os.path.join(self.dir, name + ".tmp")
                shutil.copyfile(src, tmp)
                os.replace(tmp, os.path.join(self.dir, name))
            try:
                with open(
                    os.path.join(self._local_dir, _LOG_NAME), "rb"
                ) as f:
                    blob = f.read()
            except OSError:
                blob = b""
            if not blob.startswith(MAGIC):
                blob = MAGIC
            good = len(MAGIC)
            for _seq, _rec, frame in _iter_frames(blob):
                good += len(frame)
            tmp_log = self._log_path + ".tmp"
            with open(tmp_log, "wb") as f:
                f.write(blob[:good])
                f.flush()
                os.fsync(f.fileno())
            try:
                self._fh.close()
            except (OSError, ValueError):
                pass
            os.replace(tmp_log, self._log_path)
            self._fh = open(self._log_path, "ab")
        except OSError:
            logger.exception("journal mirror resync failed")
            return False
        logger.warning(
            "journal mirror %s resynced from local journal %s",
            self.dir, self._local_dir,
        )
        return True

    def _rotate(self, doc: bytes, tail: bytes):
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(doc)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(self._snap_path):
            try:
                os.replace(self._snap_path, self._snap_path + ".bak")
            except OSError:
                pass
        os.replace(tmp, self._snap_path)
        tmp_log = self._log_path + ".tmp"
        with open(tmp_log, "wb") as f:
            f.write(MAGIC + tail)
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp_log, self._log_path)
        self._fh = open(self._log_path, "ab")

    def flush(self, timeout: float = 5.0):
        """Synchronous drain (shutdown path): everything enqueued so
        far is fsync'd on the mirror when this returns (or the timeout
        hit).  Waits out the in-flight batch too — the drain moves
        tasks off the queue before the write, so an empty queue alone
        does not mean the bytes landed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._tasks and not self._inflight:
                    return
                self._wake = True
                self._cv.notify()
            time.sleep(0.01)

    def close(self):
        self.flush()
        with self._cv:
            self._stopped = True
            self._wake = True
            self._cv.notify()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # a wedged storage fsync: closing the handle under the
            # writer would turn a stall into a ValueError — leave it
            # to the daemon reaper
            return
        try:
            self._fh.close()
        except (OSError, ValueError):
            pass


class StateJournal:
    """Writer half: fsync'd appends + snapshot/log rotation.

    Opening an existing directory first replays it (the result is kept
    on ``self.recovered`` for the caller's restore path) and truncates
    any torn tail so subsequent appends extend a clean prefix.

    ``mirror_dir`` (or ``DLROVER_MASTER_JOURNAL_MIRROR_DIR``) arms the
    async group-commit mirror; an empty local dir is seeded from the
    mirror first — the different-host respawn path."""

    def __init__(
        self,
        journal_dir: str,
        fsync: bool = True,
        snapshot_every: int = 512,
        mirror_dir: Optional[str] = None,
        mirror_interval_s: Optional[float] = None,
        fsync_window_s: Optional[float] = None,
    ):
        self.dir = journal_dir
        self._fsync = fsync
        if fsync_window_s is None:
            try:
                fsync_window_s = float(
                    os.getenv(JOURNAL_FSYNC_WINDOW_ENV, "0") or 0.0
                )
            except ValueError:
                fsync_window_s = 0.0
        # group-commit window for LOCAL appends (the mirror trick
        # applied at home): 0 = every append fsyncs before returning
        # (the default — full per-append durability); >0 = appends
        # flush to the page cache and a background flusher fsyncs the
        # batch once per window.  Records are never lost to a PROCESS
        # crash either way (the page cache survives the master); the
        # window is only exposed to a host power cut, and the
        # DURABLE_KINDS terminal decisions keep per-append fsync
        # regardless.  Replay's torn-tail truncation already covers a
        # partially-persisted batch.
        self._fsync_window_s = max(0.0, float(fsync_window_s))
        self._fsync_pending = False
        self._pending_count = 0
        self._last_fsync = time.monotonic()
        self._fsync_stop = threading.Event()
        self._fsync_thread: Optional[threading.Thread] = None
        self.snapshot_every = max(1, snapshot_every)
        os.makedirs(journal_dir, exist_ok=True)
        if mirror_dir is None:
            mirror_dir = os.getenv(JOURNAL_MIRROR_DIR_ENV, "")
        self.mirror: Optional[_JournalMirror] = None
        self.seeded_from_mirror = False
        if mirror_dir:
            self.seeded_from_mirror = seed_journal_from_mirror(
                journal_dir, mirror_dir
            )
            if mirror_interval_s is None:
                try:
                    mirror_interval_s = float(os.getenv(
                        JOURNAL_MIRROR_INTERVAL_ENV, "0.25"
                    ))
                except ValueError:
                    mirror_interval_s = 0.25
            self.mirror = _JournalMirror(
                mirror_dir,
                interval_s=mirror_interval_s,
                local_dir=journal_dir,
            )
        self._log_path = os.path.join(journal_dir, _LOG_NAME)
        self._snap_path = os.path.join(journal_dir, _SNAP_NAME)
        self.recovered = replay_dir(journal_dir)
        self._seq = self.recovered.last_seq
        self.entries_since_snapshot = len(self.recovered.entries)
        # one lock around every append/rotation: the journal is fed
        # from many threads at once (RPC handler threads through the
        # servicer/task/job managers, the heartbeat monitor, the
        # run-loop's snapshot cadence) — an unsynchronized write would
        # interleave frame bytes and CRC-poison the log
        self._io_lock = threading.Lock()
        # bumped whenever rotation replaces the log's inode under
        # the same path; the group-commit flusher keys its separate
        # fsync fd off it (see _fsync_loop)
        self._log_generation = 0
        fresh = not os.path.exists(self._log_path)
        self._fh = open(self._log_path, "ab")
        if fresh or self._fh.tell() == 0:
            self._fh.write(MAGIC)
            self._flush()
        elif self.recovered.good_offset < len(MAGIC):
            # torn/absent header (crash mid-header-write): nothing in
            # this file is recoverable, and truncating to 9 garbage
            # bytes would leave a log every future replay silently
            # rejects — start a clean one
            self._fh.close()
            self._fh = open(self._log_path, "wb")
            self._fh.write(MAGIC)
            self._flush()
        elif self.recovered.good_offset < self._fh.tell():
            # discard the torn tail so the next append extends the
            # recovered prefix instead of burying a record in garbage
            # no replay would ever reach
            self._fh.truncate(self.recovered.good_offset)
            self._fh.seek(0, os.SEEK_END)
            self._flush()
        if (
            self.mirror is not None
            and not self.seeded_from_mirror
            and self.recovered.has_state
        ):
            # the local dir has history the mirror may never have
            # seen (first arming over an existing journal, or a
            # previous incarnation's flush failure): rebuild the
            # mirror as a full copy before new appends extend it, or
            # a different-host restore would replay a gapped log
            self.mirror.request_resync()

    def _flush(self):
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    @property
    def last_seq(self) -> int:
        return self._seq

    def append(self, kind: str, data: Dict[str, Any]) -> int:
        """Durably record one mutation; returns its seq.  The record
        is on disk (fsync'd) when this returns.  Thread-safe: callers
        are RPC handler threads, monitor threads and the run loop."""
        t0 = time.monotonic()
        with self._io_lock:
            _LOCK_WAIT_SECONDS.observe(time.monotonic() - t0)
            self._seq += 1
            seq = self._seq
            payload = json.dumps(
                {"s": seq, "k": kind, "d": data}, default=str
            ).encode("utf-8")
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            frame = _REC.pack(len(payload), crc) + payload
            self._fh.write(frame)
            if (
                self._fsync_window_s <= 0
                or kind in DURABLE_KINDS
                or not self._fsync
            ):
                # durable path: flush+fsync before the mutation is
                # acknowledged (also drains any batched appends —
                # one fsync covers the whole fd)
                self._flush()
                self._fsync_pending = False
                self._pending_count = 0
                _PENDING_FSYNC.set(0)
                self._last_fsync = time.monotonic()
            else:
                # group-commit path: page cache now, fsync within
                # the window on the flusher thread
                self._fh.flush()
                self._fsync_pending = True
                self._pending_count = (
                    getattr(self, "_pending_count", 0) + 1
                )
                _PENDING_FSYNC.set(self._pending_count)
                self._ensure_fsync_flusher()
            self.entries_since_snapshot += 1
            if self.mirror is not None:
                # enqueue only — the mirror thread group-commits; the
                # hot path never waits on the storage tier
                self.mirror.enqueue_append(frame)
        _FSYNC_SECONDS.observe(time.monotonic() - t0)
        _ENTRIES_TOTAL.inc(kind=kind)
        return seq

    def append_many(
        self, records: List[Tuple[str, Dict[str, Any]]]
    ) -> List[int]:
        """Durably record a BATCH of mutations under ONE io-lock
        claim and ONE durability decision; returns their seqs in
        order.

        The fleet scoreboard's first breach past 200 agents was the
        session-resync ack reconcile: a 64-ack resync did up to 64
        sequential :meth:`append` calls, each paying the lock
        queue + flush (+fsync without a group-commit window) while
        every other journaling verb waited.  Batching claims the
        lock once and fsyncs once for the whole batch — same
        durability point (all records are on disk before the caller
        acknowledges), 1/N the serialization cost.  An empty batch
        is a no-op."""
        if not records:
            return []
        t0 = time.monotonic()
        seqs: List[int] = []
        with self._io_lock:
            _LOCK_WAIT_SECONDS.observe(time.monotonic() - t0)
            durable = (
                self._fsync_window_s <= 0
                or not self._fsync
                or any(kind in DURABLE_KINDS for kind, _ in records)
            )
            for kind, data in records:
                self._seq += 1
                seqs.append(self._seq)
                payload = json.dumps(
                    {"s": self._seq, "k": kind, "d": data},
                    default=str,
                ).encode("utf-8")
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                frame = _REC.pack(len(payload), crc) + payload
                self._fh.write(frame)
                if self.mirror is not None:
                    self.mirror.enqueue_append(frame)
            if durable:
                # one flush+fsync covers every frame in the batch
                self._flush()
                self._fsync_pending = False
                self._pending_count = 0
                _PENDING_FSYNC.set(0)
                self._last_fsync = time.monotonic()
            else:
                self._fh.flush()
                self._fsync_pending = True
                self._pending_count = (
                    getattr(self, "_pending_count", 0) + len(records)
                )
                _PENDING_FSYNC.set(self._pending_count)
                self._ensure_fsync_flusher()
            self.entries_since_snapshot += len(records)
        _FSYNC_SECONDS.observe(time.monotonic() - t0)
        for kind, _ in records:
            _ENTRIES_TOTAL.inc(kind=kind)
        return seqs

    def _ensure_fsync_flusher(self):
        """Start the local group-commit flusher lazily (first batched
        append); callers hold ``_io_lock``."""
        if (
            self._fsync_thread is not None
            and self._fsync_thread.is_alive()
        ):
            return
        self._fsync_thread = threading.Thread(
            target=self._fsync_loop,
            daemon=True,
            name="journal-fsync",
        )
        self._fsync_thread.start()

    def _fsync_loop(self):
        # Two convoy killers, both measured by the fleet scoreboard
        # at hundreds of agents (seconds-long append p99 without
        # them):
        # 1. the fsync runs OUTSIDE the io lock — holding it through
        #    a slow storage flush parks every appender behind the
        #    flusher;
        # 2. the flush primitive is fdatasync through the flusher's
        #    OWN read-only fd — an append-only log's durability needs
        #    exactly data + size, which fdatasync covers (the classic
        #    WAL sync method), while a full fsync on gVisor-style
        #    filesystems takes a metadata path that stalls seconds
        #    under CPU saturation AND serializes in-kernel with
        #    write()s on the same inode, conveying every appender.
        #    Measured at 200 synthetic agents: worst verb p99 2-5 s
        #    with fsync, 5 ms with fdatasync.
        # Claiming the batch under the lock keeps the contract:
        # records appended while the fsync is in flight re-arm
        # _fsync_pending and ride the next window; a rotation racing
        # the fsync replaced the inode AFTER fsync'ing the surviving
        # tail itself, so fsync'ing the stale inode loses nothing.
        sync_fd = -1
        sync_gen = -1
        try:
            while not self._fsync_stop.wait(self._fsync_window_s):
                with self._io_lock:
                    if not self._fsync_pending:
                        continue
                    try:
                        self._fh.flush()
                    except (OSError, ValueError):
                        continue  # rotation raced; retry next tick
                    self._fsync_pending = False
                    self._pending_count = 0
                    _PENDING_FSYNC.set(0)
                    gen = self._log_generation
                try:
                    if sync_gen != gen or sync_fd < 0:
                        # rotation replaced the inode under the same
                        # path: reopen so the fsync covers the LIVE
                        # log, not the replaced one
                        if sync_fd >= 0:
                            os.close(sync_fd)
                        sync_fd = os.open(
                            self._log_path, os.O_RDONLY
                        )
                        sync_gen = gen
                    getattr(os, "fdatasync", os.fsync)(sync_fd)
                    self._last_fsync = time.monotonic()
                except (OSError, ValueError):
                    if sync_fd >= 0:
                        try:
                            os.close(sync_fd)
                        except OSError:
                            pass
                    sync_fd = -1
                    sync_gen = -1
                    # the claimed batch is NOT durable: re-arm so
                    # the next tick retries even with no new append
                    # (a transient sync failure must not leave the
                    # records page-cache-only past the window bound)
                    with self._io_lock:
                        self._fsync_pending = True
        finally:
            if sync_fd >= 0:
                try:
                    os.close(sync_fd)
                except OSError:
                    pass

    def snapshot(self, state: Dict[str, Any],
                 seq: Optional[int] = None):
        """Atomically persist a full-state snapshot and rotate the
        log.  Crash-safe at every boundary: tmp rename is atomic, the
        previous snapshot survives as ``.bak``, and seq filtering
        makes a not-yet-rotated log harmless.

        ``seq`` is the journal position observed BEFORE the caller
        captured ``state``.  Appends that raced the capture (their
        records carry a later seq) are PRESERVED through the rotation
        and re-applied at replay on top of the snapshot — replay of
        those kinds is idempotent, so a mid-capture mutation is at
        worst double-applied, never lost.  (Exception: a ``kv_add``
        racing the capture can double-count; KV barriers are
        transient rendezvous aids, so the blast radius is nil.)"""
        with self._io_lock:
            snap_seq = self._seq if seq is None else int(seq)
            doc = _snapshot_doc(snap_seq, state)
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(doc)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(self._snap_path):
                try:
                    os.replace(
                        self._snap_path, self._snap_path + ".bak"
                    )
                except OSError:
                    pass
            os.replace(tmp, self._snap_path)
            self._fsync_dir()
            # rotate: records at or below the snapshot's seq are
            # redundant; anything later (an append that raced the
            # state capture) must survive into the fresh log.  The
            # rotation itself is crash-atomic: the new log is built
            # in a tmp file, fsync'd, then renamed over the old one —
            # a crash mid-rotation leaves the full old log, whose
            # pre-snapshot records replay harmlessly (seq filter)
            tail = b""
            tail_count = 0
            if snap_seq < self._seq:
                self._fh.flush()
                try:
                    with open(self._log_path, "rb") as f:
                        blob = f.read()
                    for rec_seq, _rec, frame in _iter_frames(blob):
                        if rec_seq > snap_seq:
                            tail += frame
                            tail_count += 1
                except OSError:  # pragma: no cover - keep the old log
                    return
            tmp_log = self._log_path + ".tmp"
            with open(tmp_log, "wb") as f:
                f.write(MAGIC + tail)
                f.flush()
                os.fsync(f.fileno())
            self._fh.close()
            os.replace(tmp_log, self._log_path)
            self._fsync_dir()
            self._fh = open(self._log_path, "ab")
            self._log_generation += 1
            self.entries_since_snapshot = tail_count
            # the rotation rewrote+fsync'd every surviving record:
            # any batched appends are durable in the new log
            self._fsync_pending = False
            self._last_fsync = time.monotonic()
            if self.mirror is not None:
                # the rotation rides the ordered mirror queue, so any
                # append enqueued before it lands first and anything
                # after it extends the rotated mirror log
                self.mirror.enqueue_snapshot(doc, tail)
        _SNAPSHOTS_TOTAL.inc()

    def _fsync_dir(self):
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - fs without dir fsync
            pass

    def close(self):
        if self.mirror is not None:
            # drain pending group commits so a graceful stop leaves
            # the mirror byte-equal to the local log
            self.mirror.close()
        self._fsync_stop.set()
        if self._fsync_thread is not None:
            self._fsync_thread.join(timeout=5.0)
        with self._io_lock:
            try:
                if self._fsync_pending:
                    # graceful stop: the batched tail becomes durable
                    self._flush()
                    self._fsync_pending = False
                self._fh.close()
            except OSError:
                pass
