"""Read-only serving replica: committed-chain ingest + host-gather
lookups.

Copy of ``dlrover_tpu/serving/replica.py`` (the port imports nothing of the JAX
package).

Correctness contract (what the chaos invariants prove from the event
log alone):

- **Only committed generations are ever served.**  The replica trusts
  the tracker, requires every generation's ``DONE`` marker, and
  recomputes the per-table content digests over the blobs it ACTUALLY
  applied — a mismatch against the manifest aborts the ingest with
  the tables untouched (the previous generation keeps serving).

- **Generation transitions are atomic w.r.t. lookups.**  Both the
  lookup path and the apply path take the swap lock; the apply holds
  it for O(delta rows) — never O(table) on a delta — which is what
  bounds lookup p99 under concurrent ingest.

- **A replica killed mid-ingest recovers by re-ingesting.**  Tables
  live in process memory, so a fresh replica replays the newest base
  plus the delta chain up to the tracker; nothing on storage is ever
  mutated by a replica.

Freshness: each committed manifest carries the publisher's commit
timestamp; ``freshness_s`` on the ``serving_ingest`` /
``serving_freshness`` events (and the
``dlrover_serving_freshness_seconds`` gauge) is the replica-side age
of that commit when the generation became servable — the
train-commit -> servable latency the ROADMAP item 4 asks for.
"""

import os
import io
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.checkpoint.sparse import (
    keys_digest,
    reshard_window_rows,
    rows_digest,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.storage import get_checkpoint_storage
from dlrover_tpu_torch.ops.kv_variable import KvVariable
from dlrover_tpu_torch.serving.publisher import (
    BLOBS,
    committed_generation,
    gen_dirname,
    generation_committed,
    read_manifest,
)
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_INGEST_SECONDS = _REG.histogram(
    "dlrover_serving_ingest_seconds",
    "One generation applied on the replica (read + verify + apply), "
    "by kind",
)
_FRESHNESS_SECONDS = _REG.gauge(
    "dlrover_serving_freshness_seconds",
    "Age of the served generation's train commit when it became "
    "servable (train-commit -> servable latency)",
)
_LOOKUP_SECONDS = _REG.histogram(
    "dlrover_serving_lookup_seconds",
    "One lookup batch through the native host-gather path",
)
_SERVED_GENERATION = _REG.gauge(
    "dlrover_serving_generation",
    "Generation the replica currently serves",
)


class TornGenerationError(RuntimeError):
    """A generation's blobs do not match its manifest digests."""


class _NpyStream:
    """Row-windowed reader of one ``.npy`` member inside an open
    npz zip: parses the header, then serves ``read_rows(n)`` slices
    straight off the (decompressing) member stream — the whole array
    is never materialized.  Raises :class:`TornGenerationError` on
    any malformed header/stream (the shapes torn replication
    takes)."""

    def __init__(self, zf: zipfile.ZipFile, name: str):
        from numpy.lib import format as npformat

        try:
            self._fh = zf.open(name + ".npy")
            version = npformat.read_magic(self._fh)
            # numpy's public readers: the reference calls the private
            # ``_read_array_header``, which numpy 2.3 removed (every
            # blob here is a plain array, header version 1.0 or 2.0)
            read_header = {
                (1, 0): npformat.read_array_header_1_0,
                (2, 0): npformat.read_array_header_2_0,
            }.get(version)
            if read_header is None:
                raise ValueError(f"npy format version {version}")
            shape, fortran, dtype = read_header(self._fh)
        except Exception as e:  # noqa: BLE001 - torn/malformed member
            raise TornGenerationError(
                f"blob member {name!r} unreadable ({e})"
            )
        if fortran:
            raise TornGenerationError(
                f"blob member {name!r} is fortran-ordered"
            )
        self.shape = tuple(int(d) for d in shape)
        self.rows = self.shape[0] if self.shape else 0
        self.dtype = dtype
        self._row_elems = (
            int(np.prod(self.shape[1:], dtype=np.int64))
            if len(self.shape) > 1 else 1
        )
        self._row_bytes = self._row_elems * dtype.itemsize

    def read_rows(self, n: int) -> np.ndarray:
        want = n * self._row_bytes
        buf = self._fh.read(want)
        if len(buf) != want:
            raise TornGenerationError(
                "blob member truncated mid-stream"
            )
        arr = np.frombuffer(buf, dtype=self.dtype)
        if len(self.shape) > 1:
            arr = arr.reshape((n,) + self.shape[1:])
        return arr

    def close(self):
        try:
            self._fh.close()
        except Exception:  # noqa: BLE001
            pass


class ServingReplica:
    """In-process replica over a serving directory.

    Tables are created lazily from the first ingested base's manifest
    (names and dims come from the publisher), so a replica needs no
    model code — only the serving directory.
    """

    def __init__(
        self,
        serving_dir: str,
        storage=None,
        verify_digests: bool = True,
    ):
        self.serving_dir = serving_dir
        self.storage = storage or get_checkpoint_storage(
            path=serving_dir
        )
        self.verify_digests = verify_digests
        self.tables: Dict[str, KvVariable] = {}
        self.generation = 0
        self.generation_step: Optional[int] = None
        self.respawned = (
            os.environ.get("DLROVER_SERVING_RESPAWNED", "") != ""
        )
        # serving-fleet drain protocol: called with the base
        # generation about to be applied, BEFORE any staging work; a
        # False return defers the whole catch-up pass (the router
        # denied the drain — another member is re-basing), and the
        # next poll retries.  Standalone replicas leave it None.
        self.pre_base_hook = None
        self._swap_lock = threading.Lock()
        # serializes whole catch-up passes: two threads polling at
        # once (e.g. the replica process's poller plus a warm-up
        # caller) would plan the same chain, double-apply it and —
        # with a slow base apply finishing last — REGRESS the served
        # generation behind one already announced
        self._ingest_lock = threading.Lock()

    # -- ingest -------------------------------------------------------------

    def _load_generation(self, gen: int, manifest=None):
        """Read + digest-verify one committed generation; returns
        (manifest, {table: blob dict}).  Raises on a torn read —
        the caller leaves the tables at the previous generation.
        ``manifest`` skips the re-read when the caller already holds
        it (the ingest loop reads it to branch on kind)."""
        if manifest is None:
            manifest = read_manifest(
                self.serving_dir, gen, self.storage
            )
        if manifest is None:
            raise TornGenerationError(
                f"generation {gen}: manifest missing/unreadable"
            )
        raw = self.storage.read(
            os.path.join(
                self.serving_dir, gen_dirname(gen), BLOBS
            )
        )
        if raw is None:
            raise TornGenerationError(
                f"generation {gen}: blobs missing"
            )
        try:
            npz = np.load(io.BytesIO(bytes(raw)), allow_pickle=False)
        except Exception as e:  # noqa: BLE001 - any parse failure
            # zipfile CRC errors, truncated archives, bad headers —
            # all the shapes torn replication takes
            raise TornGenerationError(
                f"generation {gen}: blobs unreadable ({e})"
            )
        per_table: Dict[str, Dict[str, np.ndarray]] = {}
        for name, meta in manifest.get("tables", {}).items():
            try:
                blob = {
                    "keys": npz[f"{name}::keys"],
                    "values": npz[f"{name}::values"],
                    "freq": npz[f"{name}::freq"],
                    "dead": npz[f"{name}::dead"],
                }
            except Exception as e:  # noqa: BLE001 - torn entries
                raise TornGenerationError(
                    f"generation {gen}: table {name!r} blob "
                    f"incomplete ({e})"
                )
            if self.verify_digests:
                got = f"{rows_digest(blob['keys'], blob['values'], blob['freq']):016x}"  # noqa: E501
                got_dead = f"{keys_digest(blob['dead']):016x}"
                if got != meta.get("digest") or got_dead != meta.get(
                    "dead_digest"
                ):
                    raise TornGenerationError(
                        f"generation {gen}: table {name!r} digest "
                        f"mismatch (manifest {meta.get('digest')} "
                        f"dead {meta.get('dead_digest')}, read {got} "
                        f"dead {got_dead})"
                    )
            per_table[name] = blob
        return manifest, per_table

    def _apply_generation(self, manifest, per_table) -> Dict[str, Any]:
        """Apply one verified generation under the swap lock: base =
        replace, delta = tombstones + touched rows.  Returns the
        per-table digest dict of what was applied (== the manifest's
        by construction — re-stated on the ingest event so the
        invariant needs no filesystem access)."""
        gen = int(manifest["generation"])
        kind = manifest.get("kind", "base")
        digests: Dict[str, Dict[str, Any]] = {}
        with self._swap_lock:
            # chaos hook: a kill here is the replica dying MID-INGEST
            # — the process dies with the lock held and the tables
            # half-applied, and the respawned replica re-ingests from
            # the newest committed base; no lookup ever observed the
            # half-applied state (the lock) and no event claimed the
            # generation (emitted after the apply completes)
            _chaos.fire("serving.ingest", step=gen)
            for name, meta in manifest.get("tables", {}).items():
                blob = per_table[name]
                table = self.tables.get(name)
                if table is None:
                    dim = int(meta.get("dim") or (
                        blob["values"].shape[1]
                        if blob["values"].ndim == 2 else 0
                    ))
                    table = KvVariable(dim, name=name)
                    self.tables[name] = table
                if kind == "base":
                    table.clear()
                else:
                    if blob["dead"].size:
                        table.delete(blob["dead"])
                if blob["keys"].size:
                    table.import_(
                        blob["keys"], blob["values"], blob["freq"]
                    )
                digests[name] = {
                    "rows": int(blob["keys"].size),
                    "sum": meta.get("digest"),
                    "dead": int(blob["dead"].size),
                    "dead_sum": meta.get("dead_digest"),
                }
            self.generation = gen
            self.generation_step = manifest.get("step")
        return digests

    def _open_blobs(self, gen: int):
        """File-like over a generation's blobs.npz: a plain file
        handle on posix (no bytes materialized), a BytesIO over the
        raw bytes for remote backends (still avoids the decoded
        second copy)."""
        path = os.path.join(
            self.serving_dir, gen_dirname(gen), BLOBS
        )
        if os.path.exists(path):
            return open(path, "rb")
        raw = self.storage.read(path)
        if raw is None:
            raise TornGenerationError(
                f"generation {gen}: blobs missing"
            )
        return io.BytesIO(bytes(raw))

    def _ingest_base_windowed(
        self, gen: int, manifest, window_rows: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Base ingest with bounded memory: each table streams off
        the npz in row windows into a fresh STAGING table (nothing
        the lookup path can see), with the additive per-window digest
        checked against the manifest; the swap lock is then held only
        for the O(1) table swap — a multi-GB base neither spikes
        replica RSS by its decoded size nor stalls lookups for its
        apply.  Any mismatch/truncation raises with the served
        tables untouched (the staging tables are simply dropped)."""
        staging: Dict[str, KvVariable] = {}
        digests: Dict[str, Dict[str, Any]] = {}
        fh = self._open_blobs(gen)
        try:
            try:
                zf = zipfile.ZipFile(fh)
            except Exception as e:  # noqa: BLE001 - torn archive
                raise TornGenerationError(
                    f"generation {gen}: blobs unreadable ({e})"
                )
            with zf:
                for name, meta in manifest.get("tables", {}).items():
                    dim = int(meta.get("dim") or 0)
                    table = KvVariable(dim, name=name)
                    table.reserve(int(meta.get("rows", 0)))
                    win = window_rows or reshard_window_rows(
                        dim * 4 + 16
                    )
                    ks = _NpyStream(zf, f"{name}::keys")
                    vs = _NpyStream(zf, f"{name}::values")
                    fs = _NpyStream(zf, f"{name}::freq")
                    if not (ks.rows == vs.rows == fs.rows):
                        raise TornGenerationError(
                            f"generation {gen}: table {name!r} "
                            "member row counts disagree"
                        )
                    dig = 0
                    done = 0
                    try:
                        while done < ks.rows:
                            n = min(win, ks.rows - done)
                            kwin = ks.read_rows(n)
                            vwin = vs.read_rows(n)
                            fwin = fs.read_rows(n)
                            table.import_(kwin, vwin, fwin)
                            if self.verify_digests:
                                dig = (
                                    dig + rows_digest(
                                        kwin, vwin, fwin
                                    )
                                ) % (1 << 64)
                            done += n
                    finally:
                        ks.close()
                        vs.close()
                        fs.close()
                    dead_s = _NpyStream(zf, f"{name}::dead")
                    try:
                        dead = dead_s.read_rows(dead_s.rows)
                    finally:
                        dead_s.close()
                    if self.verify_digests:
                        got = f"{dig:016x}"
                        got_dead = f"{keys_digest(dead):016x}"
                        if got != meta.get("digest") or (
                            got_dead != meta.get("dead_digest")
                        ):
                            raise TornGenerationError(
                                f"generation {gen}: table {name!r} "
                                f"digest mismatch (manifest "
                                f"{meta.get('digest')} dead "
                                f"{meta.get('dead_digest')}, read "
                                f"{got} dead {got_dead})"
                            )
                    staging[name] = table
                    digests[name] = {
                        "rows": int(done),
                        "sum": meta.get("digest"),
                        "dead": int(dead.size),
                        "dead_sum": meta.get("dead_digest"),
                    }
        finally:
            fh.close()
        with self._swap_lock:
            # same chaos semantics as the delta apply: a kill here is
            # the replica dying mid-ingest, tables swap-or-nothing
            _chaos.fire("serving.ingest", step=gen)
            for name, table in staging.items():
                self.tables[name] = table
            self.generation = gen
            self.generation_step = manifest.get("step")
        return digests

    def ingest_pending(self) -> List[int]:
        """Catch up to the tracker: ingest every committed generation
        above the currently served one (re-basing when behind the
        newest base, or on a fresh/respawned replica).  Returns the
        generations applied this call.  Thread-safe: concurrent
        callers serialize on the ingest lock (lookups only contend
        for the inner swap lock, held O(delta) per generation)."""
        with self._ingest_lock:
            return self._ingest_pending_locked()

    def _ingest_pending_locked(self) -> List[int]:
        target = committed_generation(self.serving_dir, self.storage)
        if target <= self.generation:
            return []
        chain = self._plan_chain(self.generation, target)
        applied: List[int] = []
        last_freshness = 0.0
        for gen in chain:
            t0 = time.perf_counter()
            try:
                manifest = read_manifest(
                    self.serving_dir, gen, self.storage
                )
                if manifest is None:
                    raise TornGenerationError(
                        f"generation {gen}: manifest "
                        "missing/unreadable"
                    )
                if manifest.get("kind", "base") == "base":
                    if (
                        self.pre_base_hook is not None
                        and self.generation > 0
                        and not self.pre_base_hook(gen)
                    ):
                        # drain denied: keep serving the current
                        # generation, retry the re-base next poll
                        break
                    # bases stream windowed into staging tables —
                    # the swap lock is held O(1), replica RSS never
                    # spikes by the decoded base size
                    digests = self._ingest_base_windowed(
                        gen, manifest
                    )
                else:
                    manifest, per_table = self._load_generation(
                        gen, manifest
                    )
                    digests = self._apply_generation(
                        manifest, per_table
                    )
            except TornGenerationError as e:
                # stop at the first unreadable link: the previous
                # generation keeps serving; the next poll retries
                logger.warning("serving ingest stopped: %s", e)
                break
            seconds = time.perf_counter() - t0
            kind = manifest.get("kind", "base")
            freshness = max(
                0.0, time.time() - float(manifest.get(
                    "commit_ts", time.time()
                ))
            )
            _INGEST_SECONDS.observe(seconds, kind=kind)
            _FRESHNESS_SECONDS.set(freshness)
            last_freshness = freshness
            _SERVED_GENERATION.set(gen)
            rows = sum(d["rows"] for d in digests.values())
            dead = sum(d["dead"] for d in digests.values())
            emit_event(
                "serving_ingest",
                generation=gen,
                kind=kind,
                rows=int(rows),
                dead_rows=int(dead),
                bytes=int(manifest.get("nbytes", 0)),
                seconds=round(seconds, 4),
                freshness_s=round(freshness, 4),
                step=manifest.get("step"),
                respawned=self.respawned,
                tables={
                    n: {"rows": d["rows"], "sum": d["sum"]}
                    for n, d in digests.items()
                },
            )
            applied.append(gen)
        if applied:
            # freshness from the manifest ALREADY IN HAND for the
            # last applied generation — re-reading it from storage
            # here could race a compaction prune and fabricate a
            # falsely-perfect 0.0 sample.  Lag is re-read: publishes
            # that landed during this catch-up are exactly what it
            # measures.
            emit_event(
                "serving_freshness",
                generation=self.generation,
                freshness_s=round(last_freshness, 4),
                step=self.generation_step,
                lag_generations=max(0, int(
                    committed_generation(
                        self.serving_dir, self.storage
                    ) - self.generation
                )),
                respawned=self.respawned,
            )
        return applied

    def _plan_chain(self, current: int, target: int) -> List[int]:
        """Generations to apply, in order.  Walk back from the target
        to the newest base at-or-below it; if that base is above the
        served generation (fresh replica, pruned history, or a
        compaction overtook us) the chain re-bases there, otherwise
        it is the pure delta chain current+1..target."""
        base = None
        gen = target
        while gen >= 1:
            if not generation_committed(
                self.serving_dir, gen, self.storage
            ):
                gen -= 1
                continue
            m = read_manifest(self.serving_dir, gen, self.storage)
            if m is None:
                gen -= 1
                continue
            if m.get("kind") == "base":
                base = gen
                break
            gen -= 1
        if base is None:
            # no visible base: nothing safely servable from scratch
            if current == 0:
                return []
            start = current + 1
        elif current < base:
            start = base
        else:
            start = current + 1
        chain: List[int] = []
        for g in range(start, target + 1):
            if not generation_committed(
                self.serving_dir, g, self.storage
            ):
                # a hole in the chain (pruned or torn): applying
                # anything past it would skip a delta — truncate and
                # let the next poll re-plan (a later base heals it)
                break
            chain.append(g)
        return chain

    # -- serving ------------------------------------------------------------

    def lookup(
        self, keys: np.ndarray, table: Optional[str] = None
    ) -> np.ndarray:
        """One lookup batch through the native host-gather path
        (read-only: no insert, no frequency churn).  Atomic with
        generation swaps via the swap lock."""
        t0 = time.perf_counter()
        with self._swap_lock:
            if not self.tables:
                raise RuntimeError(
                    "replica has not ingested a base generation yet"
                )
            name = table or next(iter(self.tables))
            out = self.tables[name].gather_or_zeros(keys)
        _LOOKUP_SECONDS.observe(time.perf_counter() - t0)
        return out

    def table_names(self) -> List[str]:
        with self._swap_lock:
            return list(self.tables)
