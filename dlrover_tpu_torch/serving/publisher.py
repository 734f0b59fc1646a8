"""Trainer-side snapshot publisher: generations on committed storage.

Copy of ``dlrover_tpu/serving/publisher.py`` (the port imports nothing of the JAX
package).

On-disk layout (``serving_dir``, typically a subdirectory of the
checkpoint storage tier — the one filesystem trainer and replicas
already share)::

    gen_00000007/
        blobs.npz       per-table keys / values / freq / dead arrays
        manifest.json   generation, kind, parent/base links, per-table
                        row counts + content digests, publisher
                        commit timestamp
        DONE            commit marker: every file above is complete
    SERVING_TRACKER     latest committed generation (atomic replace)

Commit protocol (the flash checkpoint's done-file discipline applied
to serving): blobs and manifest are written first (each atomically),
the ``DONE`` marker second, the tracker advance last.  A replica
trusts only the tracker, and only generations whose ``DONE`` exists
and whose recomputed digests match the manifest — so a trainer killed
at ANY point mid-publish leaves either nothing visible or a partial
directory no replica will ever serve.  A replacement trainer scans
for the highest committed generation and publishes a fresh *base* at
the next number: re-publication is exactly-once per generation by
construction (a generation, once committed, is immutable; partial
directories at the chosen number are discarded before reuse).

Base vs delta: the first publish of a publisher's life is a base
(full snapshot — it also baselines the dirty sets); afterwards each
publish exports only the dirty rows.  Every ``compact_every`` deltas
(or when the delta would exceed ``compact_ratio`` of the table) the
publisher folds the chain into a fresh base and prunes generations
older than it — the chain a cold replica must replay stays bounded.
"""

import io
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.checkpoint.sparse import (
    SCALARS_KEY,
    keys_digest,
    reshard_window_rows,
    rows_digest,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.storage import (
    PosixDiskStorage,
    get_checkpoint_storage,
)
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

SERVING_TRACKER = "SERVING_TRACKER"
DONE_MARKER = "DONE"
MANIFEST = "manifest.json"
BLOBS = "blobs.npz"

_REG = get_registry()
_PUBLISH_SECONDS = _REG.histogram(
    "dlrover_serving_publish_seconds",
    "One serving publication end-to-end (export + write + commit), "
    "by kind (base / delta)",
)
_PUBLISH_TOTAL = _REG.counter(
    "dlrover_serving_publish_total",
    "Committed serving generations, by kind",
)
_DELTA_RATIO = _REG.gauge(
    "dlrover_serving_delta_ratio",
    "Rows in the last delta publish / logical table rows",
)


def gen_dirname(generation: int) -> str:
    return f"gen_{generation:08d}"


def committed_generation(serving_dir: str, storage=None) -> int:
    """The tracker's committed generation (0 = nothing committed)."""
    storage = storage or get_checkpoint_storage(path=serving_dir)
    raw = storage.read(
        os.path.join(serving_dir, SERVING_TRACKER), mode="r"
    )
    try:
        return int(str(raw).strip())
    except (TypeError, ValueError):
        return 0


def read_manifest(
    serving_dir: str, generation: int, storage=None
) -> Optional[Dict[str, Any]]:
    """Manifest of one generation, or None when absent/unreadable."""
    storage = storage or get_checkpoint_storage(path=serving_dir)
    raw = storage.read(
        os.path.join(serving_dir, gen_dirname(generation), MANIFEST),
        mode="r",
    )
    if raw is None:
        return None
    try:
        return json.loads(str(raw))
    except ValueError:
        return None


def generation_committed(
    serving_dir: str, generation: int, storage=None
) -> bool:
    storage = storage or get_checkpoint_storage(path=serving_dir)
    return storage.exists(
        os.path.join(serving_dir, gen_dirname(generation), DONE_MARKER)
    )


class EmbeddingPublisher:
    """Publishes a :class:`SparseStateAdapter`'s tables as committed
    serving generations.

    The adapter is typically a SERVING-dedicated one registering only
    the embedding (parameter) tables — replicas have no use for
    optimizer moments; dirty tracking lives on the table, so the
    flash-checkpoint adapter and a serving adapter can share tables
    freely (full exports never clear the delta baseline).
    """

    def __init__(
        self,
        adapter,
        serving_dir: str,
        storage=None,
        compact_every: int = 8,
        compact_ratio: float = 0.5,
        keep_generations: int = 0,
        digest: Optional[bool] = None,
    ):
        self.adapter = adapter
        self.serving_dir = serving_dir
        self.storage = storage or get_checkpoint_storage(
            path=serving_dir
        )
        self.compact_every = max(1, int(compact_every))
        self.compact_ratio = float(compact_ratio)
        # extra committed generations kept below the newest base (the
        # base itself and everything after always survive); 0 = prune
        # all superseded history
        self.keep_generations = int(keep_generations)
        if digest is not None:
            # pin the adapter's digest switch: manifests carry
            # digests, so the publisher needs them regardless of env
            self.adapter._digest = digest
        self.storage.safe_makedirs(serving_dir)
        # arm dirty tracking NOW (it is opt-in on the table so
        # non-publishing jobs pay nothing); mutations before this
        # moment are covered by the first publish being a base
        self.adapter.enable_dirty_tracking()
        self._generation = self._scan_committed()
        # a fresh publisher ALWAYS opens with a base: it cannot know
        # which rows changed since the last committed generation
        # (a predecessor may have died between export and commit)
        self._published_since_base = -1

    # -- discovery ----------------------------------------------------------

    def _scan_committed(self) -> int:
        """Highest committed generation visible on storage: the
        tracker, or — when a predecessor died between DONE and the
        tracker advance — the highest DONE'd directory (never serve
        below something a replica may already see)."""
        gen = committed_generation(self.serving_dir, self.storage)
        try:
            names = self.storage.listdir(self.serving_dir)
        except OSError:
            names = []
        for name in names:
            if not name.startswith("gen_"):
                continue
            try:
                g = int(name[4:])
            except ValueError:
                continue
            if g > gen and generation_committed(
                self.serving_dir, g, self.storage
            ):
                gen = g
        return gen

    @property
    def generation(self) -> int:
        """Last generation THIS publisher committed (or found
        committed at startup)."""
        return self._generation

    # -- publication --------------------------------------------------------

    def publish(self, step: Optional[int] = None) -> int:
        """Export + commit one generation; returns its number.

        Kind selection: base on the publisher's first publish, after
        ``compact_every`` deltas, or when the dirty set has grown
        past ``compact_ratio`` of the table (a delta that rewrites
        most rows costs base money without base benefits); delta
        otherwise.

        Failure semantics: a delta export drains the dirty set
        BEFORE the generation is durable, so any publish failure
        (storage error, and — by the same poisoned-chain marker — a
        process death whose replacement re-scans) forces the NEXT
        publish to be a base: the drained rows reach replicas in the
        full snapshot instead of silently dropping out of the delta
        chain until the next compaction."""
        t0 = time.perf_counter()
        try:
            return self._publish(step, t0)
        except BaseException:
            self._published_since_base = -1
            raise

    def _publish(self, step: Optional[int], t0: float) -> int:
        gen = self._generation + 1
        # a table registered on the adapter after the last publish
        # has no tracked history — none of its rows are in any delta
        # — so the chain must re-base for it to reach replicas at
        # all (checked BEFORE the re-arm below turns tracking on)
        untracked = any(
            not t.dirty_tracking_enabled()
            for t in self.adapter.tables.values()
        )
        kind = "delta"
        if untracked or self._published_since_base < 0 or (
            self._published_since_base + 1
        ) >= self.compact_every:
            kind = "base"
        else:
            total = sum(len(t) for t in self.adapter.tables.values())
            if total and self.adapter.dirty_rows() >= (
                self.compact_ratio * total
            ):
                kind = "base"

        # idempotent re-arm: a table registered on the adapter AFTER
        # construction would otherwise silently never track (empty,
        # digest-clean deltas while replicas serve it stale)
        self.adapter.enable_dirty_tracking()
        # a BASE on local disk streams straight from the tables into
        # the blob zip (write-side twin of the replica's _NpyStream):
        # peak extra memory is one export window, not a full table
        # copy + its npz serialization.  Other backends keep the
        # in-memory path (their write() wants whole buffers).
        streamed = kind == "base" and isinstance(
            self.storage, PosixDiskStorage
        )
        state: Dict[str, Any] = {}
        if kind == "base":
            # baseline BEFORE the export: a mutation racing the two
            # steps then lands in BOTH the base (table state) and the
            # next delta (its fresh dirty mark) — a benign overwrite.
            # Clearing after the export loses the race the other way:
            # the mutation is in neither, and replicas serve it stale
            # until the next compaction with every digest green.
            for table in self.adapter.tables.values():
                table.clear_dirty()
            if not streamed:
                state = self.adapter.export_state(step=step)
        else:
            state = self.adapter.export_delta(step=step, clear=True)

        gen_dir = os.path.join(self.serving_dir, gen_dirname(gen))
        # a partial directory at this number (predecessor died
        # mid-publish) is uncommitted garbage: discard before reuse
        if self.storage.exists(gen_dir) and not generation_committed(
            self.serving_dir, gen, self.storage
        ):
            self.storage.safe_rmtree(gen_dir)

        tables_meta: Dict[str, Any] = {}
        rows = dead_rows = 0
        scalars = {}
        if streamed:
            rows, nbytes, tables_meta = self._write_base_streamed(
                gen_dir
            )
            scalars = self._optimizer_scalars()
        else:
            arrays: Dict[str, np.ndarray] = {}
            for name, sub in state.items():
                if not isinstance(sub, dict) or "keys" not in sub:
                    if name == SCALARS_KEY:
                        scalars = sub
                    continue
                keys = np.ascontiguousarray(
                    sub["keys"], dtype=np.int64
                )
                values = np.ascontiguousarray(
                    sub["values"], dtype=np.float32
                )
                freq = np.ascontiguousarray(
                    sub["freq"], dtype=np.uint64
                )
                dead = np.ascontiguousarray(
                    sub.get("dead", ()), dtype=np.int64
                )
                arrays[f"{name}::keys"] = keys
                arrays[f"{name}::values"] = values
                arrays[f"{name}::freq"] = freq
                arrays[f"{name}::dead"] = dead
                table = self.adapter.tables.get(name)
                tables_meta[name] = {
                    "dim": int(
                        table.dim if table is not None
                        else (
                            values.shape[1] if values.ndim == 2
                            else 0
                        )
                    ),
                    "rows": int(keys.size),
                    "dead": int(dead.size),
                    "digest": (
                        f"{rows_digest(keys, values, freq):016x}"
                    ),
                    "dead_digest": f"{keys_digest(dead):016x}",
                }
                rows += int(keys.size)
                dead_rows += int(dead.size)

            buf = io.BytesIO()
            np.savez(buf, **arrays)
            blob_bytes = buf.getvalue()
            self.storage.write(
                blob_bytes, os.path.join(gen_dir, BLOBS)
            )
            nbytes = len(blob_bytes)
        table_rows = sum(
            len(t) for t in self.adapter.tables.values()
        )
        manifest = {
            "generation": gen,
            "kind": kind,
            "parent": self._generation,
            "step": int(step) if step is not None else None,
            "commit_ts": time.time(),
            "tables": tables_meta,
            "scalars": scalars,
            "nbytes": int(nbytes),
            "table_rows": int(table_rows),
        }
        self.storage.write(
            json.dumps(manifest), os.path.join(gen_dir, MANIFEST)
        )
        # chaos hook: a kill here plays the trainer dying mid-publish
        # — blobs + manifest exist but no DONE, so no replica will
        # ever serve this generation and the replacement's base
        # publish at gen+1 is exactly-once
        _chaos.fire("serving.publish", step=gen)
        self.storage.write(
            str(gen), os.path.join(gen_dir, DONE_MARKER)
        )
        self.storage.write(
            str(gen), os.path.join(self.serving_dir, SERVING_TRACKER)
        )
        self._generation = gen
        self._published_since_base = (
            0 if kind == "base" else self._published_since_base + 1
        )
        seconds = time.perf_counter() - t0
        _PUBLISH_SECONDS.observe(seconds, kind=kind)
        _PUBLISH_TOTAL.inc(kind=kind)
        delta_ratio = (
            round(rows / table_rows, 4) if table_rows else 0.0
        )
        if kind == "delta":
            _DELTA_RATIO.set(delta_ratio)
        emit_event(
            "serving_publish",
            generation=gen,
            kind=kind,
            step=int(step) if step is not None else -1,
            rows=int(rows),
            dead_rows=int(dead_rows),
            bytes=int(nbytes),
            seconds=round(seconds, 4),
            delta_ratio=delta_ratio,
            tables={
                n: {"rows": m["rows"], "sum": m["digest"]}
                for n, m in tables_meta.items()
            },
        )
        logger.info(
            "published serving generation %d (%s%s): %d row(s), %d "
            "tombstone(s), %.1f KB in %.3fs",
            gen, kind, ", streamed" if streamed else "", rows,
            dead_rows, nbytes / 1024, seconds,
        )
        if kind == "base":
            self._prune_before_base(gen)
        return gen

    def _optimizer_scalars(self) -> Dict[str, Any]:
        """The manifest's optimizer-scalar section, computed without
        a full :meth:`export_state` (the streamed base path never
        materializes one)."""
        from dlrover_tpu_torch.checkpoint.sparse import _enc

        return {
            _enc(opt.table.name): opt.state_scalars()
            for opt in getattr(self.adapter, "_optimizers", ())
            if hasattr(opt, "state_scalars")
        }

    def _write_base_streamed(self, gen_dir: str):
        """Write-side twin of the replica's ``_NpyStream``: assemble
        the base blob zip member-by-member, the values column
        streamed straight off :meth:`KvVariable.export_chunks`
        windows and the key/freq sidecars spooled to disk during the
        SAME pass (row alignment survives concurrent mutation), then
        replayed window-by-window into their members.  Peak extra
        memory is a couple of export windows — never the full value
        matrix copy (plus its npz serialization) the in-memory path
        costs, and not even the 16 B/row sidecar accumulation.  The
        manifest digest accumulates per window (``rows_digest`` sums
        mod 2**64 over disjoint row sets), so replicas verify the
        streamed blob exactly like a materialized one.  Same commit
        discipline as ``storage.write``: temp file + atomic rename.
        Returns ``(rows, nbytes, tables_meta)``."""
        import tempfile
        import zipfile

        from numpy.lib import format as npformat

        def write_member(zf, member, dtype, shape, blocks):
            got = 0
            with zf.open(member, "w", force_zip64=True) as fh:
                npformat.write_array_header_1_0(fh, {
                    "descr": npformat.dtype_to_descr(
                        np.dtype(dtype)
                    ),
                    "fortran_order": False,
                    "shape": tuple(int(d) for d in shape),
                })
                for block in blocks:
                    block = np.ascontiguousarray(block, dtype=dtype)
                    # flat byte view, not tobytes(): no window-sized
                    # copy on the hot path
                    fh.write(memoryview(block).cast("B"))
                    got += int(block.shape[0]) if block.ndim else 0
                    # release before pulling the next window, or the
                    # loop var pins TWO windows across the generator
                    # resume
                    block = None
            return got

        # parity with storage.write: the chaos io_error/stall rules
        # that target blob writes must see the streamed path too
        dest = os.path.join(gen_dir, BLOBS)
        _chaos.fire("storage.write", path=dest)
        self.storage.safe_makedirs(gen_dir)
        fd, tmp = tempfile.mkstemp(dir=gen_dir, suffix=".blobs.tmp")
        os.close(fd)
        tables_meta: Dict[str, Any] = {}
        rows = 0
        no_dead = np.empty(0, dtype=np.int64)
        try:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
                for name, table in self.adapter.tables.items():
                    n = len(table)
                    dim = int(table.dim)
                    window = reshard_window_rows(dim * 4 + 16)
                    digest = 0
                    # the key/freq sidecars must come off the SAME
                    # export pass as the values (a second pass could
                    # interleave with mutation and misalign rows), so
                    # spool them to disk during the value stream and
                    # replay them window-by-window into their zip
                    # members — peak extra RSS stays one window, not
                    # 16 B/row (+ the concatenate copy) of sidecars
                    kspool = tempfile.TemporaryFile(dir=gen_dir)
                    fspool = tempfile.TemporaryFile(dir=gen_dir)
                    sidecar_rows = 0

                    def value_blocks(table=table, window=window,
                                     kspool=kspool, fspool=fspool):
                        nonlocal digest, sidecar_rows
                        for k, v, f in table.export_chunks(window):
                            k = np.ascontiguousarray(
                                k, dtype=np.int64
                            )
                            f = np.ascontiguousarray(
                                f, dtype=np.uint64
                            )
                            kspool.write(memoryview(k).cast("B"))
                            fspool.write(memoryview(f).cast("B"))
                            sidecar_rows += int(k.size)
                            digest = (
                                digest + rows_digest(k, v, f)
                            ) % 2**64
                            yield v
                            k = v = f = None

                    def spool_blocks(spool, dtype, window=window):
                        spool.seek(0)
                        while True:
                            buf = spool.read(max(window, 1) * 8)
                            if not buf:
                                return
                            yield np.frombuffer(buf, dtype=dtype)

                    try:
                        got = write_member(
                            zf, f"{name}::values.npy", np.float32,
                            (n, dim), value_blocks(),
                        )
                        if got != n or sidecar_rows != n:
                            # the values header already promised n
                            # rows; a mismatched stream would commit
                            # a blob the replica reads torn — refuse
                            # the publish
                            raise RuntimeError(
                                f"streamed base export of table "
                                f"{name!r} saw {got} row(s), the "
                                f"logical table claims {n} — "
                                f"mutation mid-publish?"
                            )
                        write_member(
                            zf, f"{name}::keys.npy", np.int64, (n,),
                            spool_blocks(kspool, np.int64),
                        )
                        write_member(
                            zf, f"{name}::freq.npy", np.uint64,
                            (n,), spool_blocks(fspool, np.uint64),
                        )
                    finally:
                        kspool.close()
                        fspool.close()
                    write_member(
                        zf, f"{name}::dead.npy", np.int64, (0,), [],
                    )
                    tables_meta[name] = {
                        "dim": dim,
                        "rows": n,
                        "dead": 0,
                        "digest": f"{digest:016x}",
                        "dead_digest": f"{keys_digest(no_dead):016x}",
                    }
                    rows += n
            os.replace(tmp, dest)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return rows, os.path.getsize(dest), tables_meta

    def _prune_before_base(self, base_gen: int):
        """Drop committed generations a cold replica no longer needs:
        everything below the newest base (minus ``keep_generations``
        of grace) is superseded — replicas behind it re-base."""
        cutoff = base_gen - self.keep_generations
        try:
            names = self.storage.listdir(self.serving_dir)
        except OSError:
            return
        for name in names:
            if not name.startswith("gen_"):
                continue
            try:
                g = int(name[4:])
            except ValueError:
                continue
            if g < cutoff:
                self.storage.safe_rmtree(
                    os.path.join(self.serving_dir, name)
                )
