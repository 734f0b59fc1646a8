"""Persistent job-metrics datastore (sqlite).

Copy of ``dlrover_tpu/brain/datastore.py`` (the port imports nothing of the JAX
package).

Reference: the Go Brain's MySQL datastore
(``go/brain/pkg/datastore/recorder/mysql/``) recording job metrics /
job meta for the optimizer chain.  sqlite keeps the same durable,
queryable role without an external server — the file lives on the
master's PV (or local disk for single-job mode).
"""

import json
import sqlite3
import threading
import time
from typing import List, Optional

from dlrover_tpu_torch.brain.service import JobMetricRecord

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job_metrics (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_name TEXT NOT NULL,
    timestamp REAL NOT NULL,
    workers INTEGER,
    samples_per_sec REAL,
    cpu_percent REAL,
    memory_mb REAL,
    model_params INTEGER,
    finished INTEGER,
    extra TEXT
);
CREATE INDEX IF NOT EXISTS idx_job_name ON job_metrics (job_name);
"""


class SqliteJobMetricsStore:
    """Drop-in for :class:`~dlrover_tpu_torch.brain.service.JobMetricsStore`
    with real persistence + indexed queries.

    Multi-job safe: several masters (each its own process and
    connection) can feed ONE datastore file concurrently — the Go
    Brain's deployment shape.  Three things make that true: WAL mode
    (readers never block the single writer, writers append to the
    log instead of rewriting pages), a busy timeout so a write that
    catches the WAL lock queues instead of throwing
    ``database is locked``, and a bounded retry for the residual
    SQLITE_BUSY cases a timeout cannot cover (two writers racing the
    initial schema script, WAL checkpoint contention)."""

    def __init__(self, path: str = ":memory:",
                 busy_timeout_s: float = 10.0):
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(
            path, check_same_thread=False, timeout=busy_timeout_s,
        )
        self._conn.execute(
            f"PRAGMA busy_timeout = {int(busy_timeout_s * 1000)}"
        )
        if path != ":memory:":
            # WAL only exists for file-backed databases; NORMAL
            # durability pairs with it (fsync on checkpoint, not per
            # commit) — metric rows are advisory, not control state
            try:
                self._retry(
                    lambda: self._conn.execute(
                        "PRAGMA journal_mode = WAL"
                    )
                )
                self._conn.execute("PRAGMA synchronous = NORMAL")
            except sqlite3.OperationalError:
                pass  # stay on the rollback journal (still correct)
        with self._lock:
            self._retry(lambda: self._conn.executescript(_SCHEMA))
            self._conn.commit()

    def _retry(self, fn, attempts: int = 6, base_sleep: float = 0.05):
        """Run ``fn`` through transient SQLITE_BUSY/LOCKED errors —
        the shapes concurrent masters produce under checkpoint or
        schema races that the busy timeout does not absorb.  The
        open transaction is ROLLED BACK before each retry: a commit
        that catches the lock leaves its INSERT pending on the
        connection, and re-running fn() without the rollback would
        commit the row twice."""
        for i in range(attempts):
            try:
                return fn()
            except sqlite3.OperationalError as e:
                msg = str(e).lower()
                if ("locked" not in msg and "busy" not in msg) or (
                    i == attempts - 1
                ):
                    raise
                try:
                    self._conn.rollback()
                except sqlite3.Error:
                    pass
                time.sleep(base_sleep * (2 ** i))

    def persist(self, record: JobMetricRecord, **extra):
        def _write():
            self._conn.execute(
                "INSERT INTO job_metrics (job_name, timestamp, "
                "workers, samples_per_sec, cpu_percent, memory_mb, "
                "model_params, finished, extra) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    record.job_name,
                    record.timestamp or time.time(),
                    record.workers,
                    record.samples_per_sec,
                    record.cpu_percent,
                    record.memory_mb,
                    record.model_params,
                    int(record.finished),
                    json.dumps(extra) if extra else "",
                ),
            )
            self._conn.commit()

        with self._lock:
            self._retry(_write)

    def load(
        self, job_name: Optional[str] = None
    ) -> List[JobMetricRecord]:
        query = (
            "SELECT job_name, timestamp, workers, samples_per_sec, "
            "cpu_percent, memory_mb, model_params, finished "
            "FROM job_metrics"
        )
        args: tuple = ()
        if job_name is not None:
            query += " WHERE job_name = ?"
            args = (job_name,)
        with self._lock:
            rows = self._retry(
                lambda: self._conn.execute(query, args).fetchall()
            )
        return [
            JobMetricRecord(
                job_name=r[0], timestamp=r[1], workers=r[2] or 0,
                samples_per_sec=r[3] or 0.0, cpu_percent=r[4] or 0.0,
                memory_mb=r[5] or 0.0, model_params=r[6] or 0,
                finished=bool(r[7]),
            )
            for r in rows
        ]

    def load_extras(
        self, job_name: Optional[str] = None
    ) -> List[dict]:
        """The tagged extra columns (lifecycle events, goodput
        attributions) as dicts with their row timestamp — what the
        Brain's diagnosis consumers read back."""
        query = (
            "SELECT job_name, timestamp, extra FROM job_metrics "
            "WHERE extra != ''"
        )
        args: tuple = ()
        if job_name is not None:
            query += " AND job_name = ?"
            args = (job_name,)
        with self._lock:
            rows = self._retry(
                lambda: self._conn.execute(query, args).fetchall()
            )
        out = []
        for job, ts, extra in rows:
            try:
                doc = json.loads(extra)
            except (TypeError, ValueError):
                continue
            doc.update(job_name=job, timestamp=ts)
            out.append(doc)
        return out

    def job_names(self) -> List[str]:
        with self._lock:
            rows = self._retry(
                lambda: self._conn.execute(
                    "SELECT DISTINCT job_name FROM job_metrics"
                ).fetchall()
            )
        return [r[0] for r in rows]

    def close(self):
        with self._lock:
            self._conn.close()
