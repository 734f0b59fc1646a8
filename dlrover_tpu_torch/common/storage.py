"""Checkpoint storage abstraction + deletion strategies.

Copy of ``dlrover_tpu/common/storage.py`` (role of
``dlrover/python/common/storage.py``): a small write/read/safe-move/
commit surface the async saver uses so storage backends are
interchangeable: the POSIX backend (local disk, NFS, FUSE-mounted
buckets) and the object-store backend over fsspec (``FsspecStorage``;
``fsspec`` is imported when one is built, as the card machines need not
have it).  Both fire the reference's chaos hook ``storage.write``; the
POSIX backend also ``storage.read`` and ``storage.move``.
"""

import mmap
import os
import shutil
import tempfile
import threading
from typing import List, Optional

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.log import default_logger as logger


class CheckpointDeletionStrategy:
    """Decides which persisted steps to clean after a new commit."""

    def clean_up(self, step: int, delete_fn):
        raise NotImplementedError


class KeepStepIntervalStrategy(CheckpointDeletionStrategy):
    """Keep checkpoints whose step % interval == 0, delete the rest
    (reference: storage.py:203).  Deletion is deferred by one commit —
    the step just persisted is never removed, only the previously
    committed one once a newer checkpoint exists (reference
    storage.py:301-305 tracks pre_step for exactly this)."""

    def __init__(self, keep_interval: int, checkpoint_dir: str):
        self._keep_interval = max(1, keep_interval)
        self._dir = checkpoint_dir
        self._pre_step = -1

    def clean_up(self, step: int, delete_fn):
        prev, self._pre_step = self._pre_step, step
        if prev < 0 or prev == step or prev % self._keep_interval == 0:
            return
        delete_fn(os.path.join(self._dir, str(prev)))


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    """Keep at most N latest step dirs (reference: storage.py:231)."""

    def __init__(self, max_to_keep: int, checkpoint_dir: str):
        self._max_to_keep = max(1, max_to_keep)
        self._dir = checkpoint_dir
        self._steps: List[int] = []
        self._lock = threading.Lock()

    def clean_up(self, step: int, delete_fn):
        with self._lock:
            self._steps.append(step)
            while len(self._steps) > self._max_to_keep:
                stale = self._steps.pop(0)
                delete_fn(os.path.join(self._dir, str(stale)))


class CheckpointStorage:
    """Abstract storage (reference: storage.py CheckpointStorage ABC)."""

    def write(self, content, path: str):
        raise NotImplementedError

    def read(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def read_view(self, path: str):
        """Bytes-like view of ``path`` for the restore pipeline.  The
        base implementation is an eager :meth:`read`; backends with a
        lazy option (posix mmap) override so page-in overlaps the
        assembly stage instead of serializing in front of it."""
        return self.read(path)

    def safe_move(self, src: str, dst: str):
        raise NotImplementedError

    def safe_makedirs(self, path: str):
        raise NotImplementedError

    def safe_rmtree(self, path: str):
        raise NotImplementedError

    def commit(self, step: int, success: bool):
        """Hook called after all shards of ``step`` are persisted."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError


class PosixDiskStorage(CheckpointStorage):
    """Local disk / NFS storage (reference: storage.py:128)."""

    def __init__(
        self,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
    ):
        self._deletion_strategy = deletion_strategy

    def write(self, content, path: str):
        # chaos hook: an io_error rule raises OSError into the saver's
        # per-shard error path; a stall rule models a hung NFS/disk
        _chaos.fire("storage.write", path=path)
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # write-to-temp + rename so readers never observe partial files
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, mode) as f:
                f.write(content)
            os.replace(tmp, path)
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read(self, path: str, mode: str = "rb"):
        _chaos.fire("storage.read", path=path)
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def read_view(self, path: str):
        """mmap the file read-only: attaching is O(1) and pages fault
        in lazily, so the restore pipeline's chunked parallel copies
        overlap disk read-ahead with assembly instead of waiting for a
        full eager read first.  The mapping outlives the fd (closed
        immediately) and is released when the last view drops."""
        _chaos.fire("storage.read", path=path)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                return b""
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)

    def safe_move(self, src: str, dst: str):
        _chaos.fire("storage.move", path=dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.exists(dst):
            self.safe_rmtree(dst)
        shutil.move(src, dst)

    def safe_makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def safe_rmtree(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))

    def commit(self, step: int, success: bool):
        if not success or self._deletion_strategy is None:
            return
        try:
            self._deletion_strategy.clean_up(step, self.safe_rmtree)
        except Exception:
            logger.exception("checkpoint clean-up failed for step %s", step)


class FsspecStorage(CheckpointStorage):
    """Object-store storage over fsspec — ``gs://`` buckets (gcsfs),
    ``s3://``, or ``memory://`` for tests (reference: storage.py:183,
    the pluggable storage factory of dlrover's storage.py:320).

    Atomicity model: an object PUT is atomic (readers see either
    nothing or the whole object), so shard writes need no temp+rename;
    the tracker file is one small object PUT, which replaces the
    POSIX backend's rename-based commit."""

    def __init__(
        self,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
        fs=None,
        protocol: str = "gs",
    ):
        if fs is None:
            import fsspec

            fs = fsspec.filesystem(protocol)
        self._fs = fs
        self._deletion_strategy = deletion_strategy

    def write(self, content, path: str):
        _chaos.fire("storage.write", path=path)
        mode = "wb" if isinstance(
            content, (bytes, bytearray, memoryview)
        ) else "w"
        with self._fs.open(path, mode) as f:
            f.write(content)

    def read(self, path: str, mode: str = "rb"):
        if not self._fs.exists(path):
            return None
        with self._fs.open(path, mode) as f:
            return f.read()

    def safe_move(self, src: str, dst: str):
        if self._fs.exists(dst):
            self.safe_rmtree(dst)
        self._fs.mv(src, dst, recursive=True)

    def safe_makedirs(self, path: str):
        # object stores have no real directories; makedirs is a no-op
        # beyond fsspec's bookkeeping
        try:
            self._fs.makedirs(path, exist_ok=True)
        except Exception:  # noqa: BLE001 - some backends reject it
            pass

    def safe_rmtree(self, path: str):
        try:
            if self._fs.exists(path):
                self._fs.rm(path, recursive=True)
        except FileNotFoundError:
            pass

    def exists(self, path: str) -> bool:
        return bool(self._fs.exists(path))

    def listdir(self, path: str) -> List[str]:
        if not self._fs.exists(path):
            return []
        names = []
        for entry in self._fs.ls(path, detail=False):
            name = str(entry).rstrip("/").rsplit("/", 1)[-1]
            if name:
                names.append(name)
        return sorted(names)

    def commit(self, step: int, success: bool):
        if not success or self._deletion_strategy is None:
            return
        try:
            self._deletion_strategy.clean_up(step, self.safe_rmtree)
        except Exception:  # noqa: BLE001
            logger.exception(
                "checkpoint clean-up failed for step %s", step
            )


def get_checkpoint_storage(
    deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
    path: str = "",
) -> CheckpointStorage:
    """Factory dispatching on the checkpoint path (reference:
    get_checkpoint_storage, storage.py:320): ``gs://...`` (or any
    ``proto://``) selects the fsspec object-store backend, everything
    else the POSIX backend (covers NFS and FUSE-mounted buckets)."""
    if "://" in path:
        protocol = path.split("://", 1)[0]
        return FsspecStorage(deletion_strategy, protocol=protocol)
    return PosixDiskStorage(deletion_strategy)
