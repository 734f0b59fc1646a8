"""Env accessors for the agent<->trainer contract (role of
dlrover/python/common/env_utils.py), plus the shared /proc/<pid>/stat
field parser the process-supervision paths rely on.

Copy of ``dlrover_tpu/common/env_utils.py`` (the port imports nothing
of the JAX package).
"""

import os
from typing import List, Optional

from dlrover_tpu_torch.common.constants import NodeEnv


def _get_int(name: str, default: int = 0) -> int:
    try:
        return int(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


def _get_float(name: str, default: float = 0.0) -> float:
    try:
        return float(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


def proc_stat_fields(pid: int) -> Optional[List[bytes]]:
    """Fields of ``/proc/<pid>/stat`` AFTER the comm field, or None
    when the pid is gone.  comm (field 2) may itself contain spaces or
    ``)``, so fields are split after the LAST ``)`` — index 0 is field
    3 (state), index 1 is field 4 (ppid), index 19 is field 22
    (starttime in clock ticks).  One parser for every consumer
    (forkserver pid-reuse guard, chaos orphan scan) so the escaping
    caveat lives in exactly one place."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        return data.rsplit(b")", 1)[1].split()
    except (OSError, IndexError):
        return None


def get_node_id() -> int:
    return _get_int(NodeEnv.NODE_ID)


def get_node_rank() -> int:
    return _get_int(NodeEnv.NODE_RANK)


def get_node_num() -> int:
    return _get_int(NodeEnv.NODE_NUM, 1)


def get_rank() -> int:
    return _get_int(NodeEnv.RANK)


def get_world_size() -> int:
    return _get_int(NodeEnv.WORLD_SIZE, 1)


def get_local_rank() -> int:
    return _get_int(NodeEnv.LOCAL_RANK)


def get_local_world_size() -> int:
    return _get_int(NodeEnv.LOCAL_WORLD_SIZE, 1)


def get_master_addr() -> str:
    return os.getenv(NodeEnv.MASTER_ADDR, "")


def get_coordinator_addr() -> str:
    return os.getenv(NodeEnv.COORDINATOR_ADDR, "")


def get_job_name() -> str:
    return os.getenv(NodeEnv.JOB_NAME, "local-job")


def get_restart_count() -> int:
    return _get_int(NodeEnv.RESTART_COUNT)


def process_rss_bytes(pid: str = "self") -> int:
    """Current resident set size of ``pid`` from /proc (0 when
    unreadable) — the raw sample the memory-bound guards and the
    sparse-scale bench monitor."""
    try:
        with open(f"/proc/{pid}/statm", "rb") as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class PeakRssSampler:
    """Background sampler of this process's peak RSS over a scoped
    region (``with PeakRssSampler() as s: ... ; s.peak_extra_bytes``).

    VmHWM would be the exact kernel answer but cannot be reset
    portably (gVisor rejects the clear_refs write), so a ~1 ms
    sampling thread approximates the peak; allocation spikes held for
    O(window-import) or longer — exactly what the bounded-memory
    reshard guard bounds — are far wider than the sampling period.
    ``peak_extra_bytes`` is the peak minus the baseline taken at
    enter."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s
        self.baseline = 0
        self.peak = 0
        self._stop = None
        self._thread = None

    def __enter__(self) -> "PeakRssSampler":
        import threading

        self.baseline = self.peak = process_rss_bytes()
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                rss = process_rss_bytes()
                if rss > self.peak:
                    self.peak = rss
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="peak-rss-sampler"
        )
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        rss = process_rss_bytes()
        if rss > self.peak:
            self.peak = rss
        return False

    @property
    def peak_extra_bytes(self) -> int:
        return max(0, self.peak - self.baseline)
