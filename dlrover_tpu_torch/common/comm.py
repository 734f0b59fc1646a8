"""Length-prefixed pickle frames for the port's IPC, with a restricted
unpickler.

Copy of the framing of ``dlrover_tpu/common/comm.py`` (``_send_frame``,
``_recv_frame``, ``_RestrictedUnpickler``, ``RemoteError``,
``ResponseCache``), cut to what the unix-socket primitives of
:mod:`dlrover_tpu_torch.common.multi_process` use; the master's TCP
server and client come with the launcher in a later slice.

Frame format: 8-byte big-endian length + pickle of the message.  The
unpickler is restricted to the message schema, so a stray client
cannot execute arbitrary reduce callables.  The schema's classes live
in this package, so the allowlist names ``dlrover_tpu_torch.`` (the
reference's ``dlrover_tpu.`` prefix would refuse every frame the port
sends) and nothing broader.
"""

import io
import pickle
import socket
import struct
import threading
from collections import OrderedDict

_LEN = struct.Struct(">Q")
# the reference's GRPC.MAX_MESSAGE_BYTES
_MAX_FRAME = 512 * 1024 * 1024

# Strict allowlist: dataclass message schema, container/scalar literals,
# and the numpy array reconstructors.  builtins is NOT broadly allowed —
# getattr/__import__ would be a remote-code-execution hole.
_ALLOWED_MODULE_PREFIXES = ("dlrover_tpu_torch.",)
_ALLOWED_GLOBALS = {
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "list"),
    ("builtins", "dict"),
    ("builtins", "tuple"),
    ("builtins", "bytearray"),
    ("builtins", "complex"),
    ("builtins", "bool"),
    ("builtins", "int"),
    ("builtins", "float"),
    ("builtins", "str"),
    ("builtins", "bytes"),
    ("builtins", "slice"),
    ("builtins", "range"),
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("collections", "deque"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    # contiguous-array fast path (protocol 5 pickles of ndarrays):
    # a pure reconstructor, builds an ndarray from raw bytes
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        if module.startswith("numpy") and name in ("dtype", "ndarray"):
            return super().find_class(module, name)
        if any(module.startswith(p) for p in _ALLOWED_MODULE_PREFIXES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden global {module}.{name} in message"
        )


def _loads(data: bytes):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > _MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)} bytes")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket):
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > _MAX_FRAME:
        raise ValueError(f"frame too large: {length} bytes")
    return _loads(_recv_exact(sock, length))


class RemoteError(Exception):
    """A handler-side failure, shipped as plain strings so it survives
    pickling/allowlisting regardless of the original exception type."""

    def __init__(self, type_name: str, message: str, tb: str = ""):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.remote_message = message
        self.remote_traceback = tb

    def __reduce__(self):
        # Exception's default reduce replays ``args`` (the single
        # joined string) into the two-arg __init__
        return (
            RemoteError,
            (self.type_name, self.remote_message,
             self.remote_traceback),
        )


class ResponseCache:
    """LRU of response frames keyed by request id, shared by every
    connection of a server, so a retried request is answered from cache
    instead of re-executing its handler."""

    def __init__(self, capacity: int = 8192):
        self._capacity = capacity
        self._cache: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, req_id: str):
        with self._lock:
            if req_id in self._cache:
                self._cache.move_to_end(req_id)
                return True, self._cache[req_id]
            return False, None

    def put(self, req_id: str, resp):
        if not req_id:
            return
        with self._lock:
            self._cache[req_id] = resp
            while len(self._cache) > self._capacity:
                self._cache.popitem(last=False)
