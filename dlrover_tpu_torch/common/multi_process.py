"""Cross-process IPC primitives between the elastic agent and trainers.

Copy of ``dlrover_tpu/common/multi_process.py``, except that a server's
thread ends when the server is closed (the reference's loop re-reads the
attribute that ``close`` sets to None), and that the default socket
directory lies under ``tempfile.gettempdir()`` (it follows ``TMPDIR``)
instead of ``/tmp``.  The reference
implements unix-socket backed ``SharedLock`` / ``SharedQueue`` /
``SharedDict`` (server lives in the agent process,
clients in the training processes) plus a ``SharedMemory`` subclass
that survives process exit by skipping resource-tracker unlinking
(``dlrover/python/common/multi_process.py:225-609``).  This module
provides the same four primitives with the same ownership model: the
agent owns the state, trainers are thin clients, and checkpoint shared
memory outlives a crashed trainer so the agent can still persist it.
"""

import os
import queue
import socket
import tempfile
import threading
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Optional

from dlrover_tpu_torch.common.comm import (
    RemoteError,
    ResponseCache,
    _recv_frame,
    _send_frame,
)
from dlrover_tpu_torch.common.log import default_logger as logger


def socket_dir() -> str:
    d = os.getenv(
        "DLROVER_SHARED_DIR",
        os.path.join(tempfile.gettempdir(), f"dlrover_tpu_{os.getuid()}",
                     "sockets"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _socket_path(name: str) -> str:
    return os.path.join(socket_dir(), f"{name}.sock")


class LocalSocketComm:
    """Base for agent-hosted IPC objects.

    ``create=True`` (agent side) starts a unix-socket server thread;
    ``create=False`` (trainer side) is a client of the same name.
    """

    def __init__(self, name: str, create: bool):
        self._name = name
        self._create = create
        self._path = _socket_path(name)
        self._server: Optional[socket.socket] = None
        self._response_cache = ResponseCache()
        if create:
            self._start_server()

    # -- server ------------------------------------------------------------

    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self._path)
        self._server.listen(128)
        t = threading.Thread(
            target=self._serve, args=(self._server,),
            name=f"ipc-{self._name}", daemon=True,
        )
        t.start()

    def _serve(self, server: socket.socket):
        # the thread keeps its own reference: close() sets
        # self._server to None while this loop may be between accepts
        while True:
            try:
                conn, _ = server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket):
        with conn:
            while True:
                try:
                    req_id, request = _recv_frame(conn)
                except (ConnectionError, OSError, EOFError):
                    return
                except Exception:
                    logger.exception("bad IPC frame on %s", self._name)
                    return
                # replay cached response for a retried request so
                # non-idempotent ops (queue get/put) are exactly-once
                hit, resp = self._response_cache.get(req_id)
                if not hit:
                    try:
                        resp = self._handle(request)
                    except Exception as e:  # surface errors to client
                        resp = RemoteError(type(e).__name__, str(e))
                    self._response_cache.put(req_id, resp)
                try:
                    _send_frame(conn, resp)
                except (ConnectionError, OSError):
                    return

    def _handle(self, request):
        raise NotImplementedError

    # -- client ------------------------------------------------------------

    def _request(self, *request, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        req_id = uuid.uuid4().hex
        while True:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(max(0.1, deadline - time.monotonic()))
                    s.connect(self._path)
                    _send_frame(s, (req_id, request))
                    resp = _recv_frame(s)
                if isinstance(resp, Exception):
                    raise resp
                return resp
            except (ConnectionError, OSError, FileNotFoundError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"IPC server {self._name} unreachable at {self._path}"
                    )
                time.sleep(0.1)

    def close(self):
        if self._server is not None:
            try:
                # wakes the serving thread's accept(), which a close
                # alone leaves blocked
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            finally:
                self._server = None
            if os.path.exists(self._path):
                try:
                    os.unlink(self._path)
                except OSError:
                    pass


def _holder_gone(owner: Optional[str]) -> bool:
    """Whether the process of a lock owner (``pid-<pid>``, a process of
    this host) has exited: no ``/proc`` entry, or a zombie."""
    from dlrover_tpu_torch.common.env_utils import proc_stat_fields

    if not owner or not owner.startswith("pid-"):
        return False
    fields = proc_stat_fields(int(owner[len("pid-"):]))
    return fields is None or fields[0] in (b"Z", b"X")


class SharedLock(LocalSocketComm):
    """Cross-process lock (reference multi_process.py:225 SharedLock).

    The server side only ever does non-blocking try-acquire; blocking
    semantics are a client-side poll loop.  A server thread therefore
    never blocks on behalf of a client, so a client that times out or
    dies mid-acquire cannot orphan the lock in an un-releasable state.
    A client that dies while HOLDING it (a trainer SIGKILLed while its
    snapshot writer holds the shm lock) does not orphan it either: the
    next try-acquire takes over a lock whose holder's process is gone
    (the reference's lock stays held, and the next incarnation's saves
    wait on it until they time out).
    """

    _POLL_INTERVAL = 0.05

    def __init__(self, name: str, create: bool):
        self._lock = threading.Lock() if create else None
        self._owner: Optional[str] = None
        super().__init__(name, create)

    def _handle(self, request):
        verb = request[0]
        if verb == "try_acquire":
            (_, owner) = request
            ok = self._lock.acquire(blocking=False)
            if ok or _holder_gone(self._owner):
                self._owner = owner
                return True
            return False
        if verb == "release":
            (_, owner) = request
            # only the holder (or a force-release, e.g. agent cleanup
            # after a trainer died) may release
            if self._lock.locked() and (
                owner == self._owner or owner == "__force__"
            ):
                self._owner = None
                self._lock.release()
                return True
            return False
        if verb == "locked":
            return self._lock.locked()
        raise ValueError(f"unknown lock verb {verb}")

    def _try_acquire(self, owner: str) -> bool:
        if self._create:
            return self._handle(("try_acquire", owner))
        return self._request("try_acquire", owner)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        owner = f"pid-{os.getpid()}"
        if not blocking:
            return self._try_acquire(owner)
        deadline = None if timeout < 0 else time.monotonic() + timeout
        while True:
            if self._try_acquire(owner):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(self._POLL_INTERVAL)

    def release(self, force: bool = False) -> bool:
        """Release if held by this process; ``force=True`` breaks a
        dead holder's lock (agent cleanup after a trainer crash)."""
        owner = "__force__" if force else f"pid-{os.getpid()}"
        if self._create:
            return self._handle(("release", owner))
        return self._request("release", owner)

    def locked(self) -> bool:
        if self._create:
            return self._handle(("locked",))
        return self._request("locked")


class SharedQueue(LocalSocketComm):
    """Cross-process FIFO (reference multi_process.py:346 SharedQueue)."""

    def __init__(self, name: str, create: bool, maxsize: int = 0):
        self._queue: Optional[queue.Queue] = (
            queue.Queue(maxsize) if create else None
        )
        super().__init__(name, create)

    def _handle(self, request):
        verb = request[0]
        if verb == "put":
            self._queue.put(request[1])
            return True
        if verb == "get":
            (_, timeout) = request
            try:
                return ("ok", self._queue.get(timeout=timeout))
            except queue.Empty:
                return ("empty", None)
        if verb == "qsize":
            return self._queue.qsize()
        raise ValueError(f"unknown queue verb {verb}")

    def put(self, obj):
        if self._create:
            return self._handle(("put", obj))
        return self._request("put", obj)

    def get(self, timeout: float = 300.0):
        if self._create:
            status, obj = self._handle(("get", timeout))
        else:
            status, obj = self._request(
                "get", timeout, timeout=timeout + 30.0
            )
        if status == "empty":
            raise queue.Empty
        return obj

    def qsize(self) -> int:
        if self._create:
            return self._handle(("qsize",))
        return self._request("qsize")

    def empty(self) -> bool:
        return self.qsize() == 0


class SharedDict(LocalSocketComm):
    """Cross-process dict (reference multi_process.py:453 SharedDict)."""

    def __init__(self, name: str, create: bool):
        self._dict: Optional[Dict] = {} if create else None
        self._dict_lock = threading.Lock() if create else None
        super().__init__(name, create)

    def _handle(self, request):
        verb = request[0]
        with self._dict_lock:
            if verb == "update":
                self._dict.update(request[1])
                return True
            if verb == "set":
                self._dict = dict(request[1])
                return True
            if verb == "getall":
                return dict(self._dict)
        raise ValueError(f"unknown dict verb {verb}")

    def update(self, d: Dict):
        if self._create:
            return self._handle(("update", d))
        return self._request("update", d)

    def set(self, d: Dict):
        if self._create:
            return self._handle(("set", d))
        return self._request("set", d)

    def get(self, default_if_absent: bool = False) -> Dict:
        """``default_if_absent=True`` returns {} immediately when no
        server socket exists (e.g. reading checkpoint meta before any
        saver was created) instead of polling for 300 s."""
        if self._create:
            return self._handle(("getall",))
        if default_if_absent and not os.path.exists(self._path):
            return {}
        return self._request("getall")


class PersistentSharedMemory(shared_memory.SharedMemory):
    """POSIX shared memory that survives the creating process.

    CPython's resource tracker unlinks shm segments when the creating
    process exits; the reference subclasses SharedMemory to skip that so
    a checkpoint written by a crashed trainer can still be persisted and
    restored by the agent (``multi_process.py:537``).  Python 3.12 has
    no ``track=`` kwarg yet, so we unregister from the tracker
    explicitly.  Call :meth:`unlink` when a segment is truly retired.
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        super().__init__(name=name, create=create, size=size)
        try:
            resource_tracker.unregister(self._name, "shared_memory")
        except Exception:
            pass

    def unlink(self):
        # re-register so the tracker's cache stays consistent when the
        # base-class unlink unregisters again
        try:
            resource_tracker.register(self._name, "shared_memory")
        except Exception:
            pass
        super().unlink()

    def close(self):
        """Like the base close, but tolerant of still-exported buffer
        views: a consumer (e.g. a pinned-staging copy still in flight or a
        lingering torch.frombuffer view awaiting GC) keeping the mapping
        alive is not an error for our lifecycle — the mapping dies
        with the last reference; without this, interpreter-shutdown
        ``__del__`` spews ``BufferError: cannot close exported
        pointers exist`` tracebacks."""
        try:
            super().close()
        except BufferError:
            pass


def get_or_create_shm(name: str, size: int) -> PersistentSharedMemory:
    """Attach to ``name`` if it exists with sufficient size, else
    (re)create it."""
    try:
        shm = PersistentSharedMemory(name=name)
        if shm.size >= size:
            return shm
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass
    return PersistentSharedMemory(name=name, create=True, size=size)
