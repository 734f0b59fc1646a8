"""Socket message transport between master, agents and trainers.

Copy of ``dlrover_tpu/common/comm.py`` (the port imports nothing of
the JAX package).

The reference runs a gRPC service with a single generic ``report``/
``get`` RPC pair whose payloads are pickled dataclasses
(``dlrover/proto/elastic_training.proto:31-34``,
``dlrover/python/common/grpc.py``).  We keep exactly that contract —
two verbs, typed dataclass payloads — over a plain threaded TCP server
with length-prefixed frames: no proto codegen, same dispatch model, and
the unpickler is restricted to the message schema so a stray client
cannot execute arbitrary reduce callables.

Frame format: 8-byte big-endian length + pickle of
``(verb, node_id, node_type, req_id, message[, trace_ctx])``; response
frame is a pickled response message (``get``) or a bool ack
(``report``).  The ``req_id`` makes retries safe: the server caches
responses by id and replays them instead of re-executing a handler
whose response frame was lost, so reconnect-and-resend is exactly-once
for non-idempotent requests (KV ``add`` barriers, failure reports,
queue gets).  ``trace_ctx`` is the optional telemetry trace context
(``{"trace_id", "span_id"}``): the server adopts it while dispatching
so a handler-opened span is a child of the caller's span; 5-tuple
frames from older peers still dispatch.
"""

import io
import os
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from typing import Optional

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.constants import GRPC, NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing as _tracing
from dlrover_tpu_torch.telemetry.metrics import get_registry as _get_registry

_RPC_RETRIES_TOTAL = _get_registry().counter(
    "dlrover_rpc_client_retries_total",
    "Client roundtrips that failed and entered backoff, by verb",
)
_RPC_RECONNECTS_TOTAL = _get_registry().counter(
    "dlrover_rpc_client_reconnects_total",
    "TCP connections the client established (first + after drops)",
)
_RPC_RESYNC_PARKS_TOTAL = _get_registry().counter(
    "dlrover_rpc_resync_parks_total",
    "Roundtrips that exhausted retries and parked awaiting a "
    "master respawn",
)
_RPC_RESYNC_RECONNECTS_TOTAL = _get_registry().counter(
    "dlrover_rpc_resync_reconnects_total",
    "Parked clients that found the master back and resumed",
)
# fleet fan-in visibility: the threaded server spawns one thread per
# connection — with hundreds of agents that pile-up was invisible.
# state: accepted (lifetime), active (now), peak (high-water)
_CONNS_GAUGE = _get_registry().gauge(
    "dlrover_master_connections",
    "Message-server connections by state (accepted/active/peak)",
)
_CONNS_REJECTED_TOTAL = _get_registry().counter(
    "dlrover_master_conns_rejected_total",
    "Connects refused by the DLROVER_MASTER_MAX_CONNS guard",
)
# server-side turnaround per bare verb (frame decode -> response
# sent), next to the handler-only dlrover_rpc_seconds: the difference
# is dispatch overhead (response cache, chaos hook, pickling, send)
_RPC_SERVER_SECONDS = _get_registry().histogram(
    "dlrover_rpc_server_seconds",
    "Server-side request turnaround by bare verb (frame decode to "
    "response sent); subtracting the handler-only "
    "dlrover_rpc_seconds leaves the dispatch overhead",
)

# connection-guard knob: reject connects beyond this many concurrent
# connections with a clean RemoteError frame instead of a silent
# thread pile-up; 0 = unlimited (the historical behaviour)
MAX_CONNS_ENV = "DLROVER_MASTER_MAX_CONNS"

# reconnect-hardening knobs (chaos partition scenarios hammer this
# path; prod defaults preserve the former envelope: 0.5 s doubling,
# capped at 8 s)
RPC_RETRIES_ENV = "DLROVER_RPC_RETRIES"
RPC_BACKOFF_BASE_ENV = "DLROVER_RPC_BACKOFF_BASE"
RPC_BACKOFF_MAX_ENV = "DLROVER_RPC_BACKOFF_MAX"
# master crash recovery: when > 0, a client whose retry envelope is
# exhausted does NOT give up — it parks in a bounded re-resolve/
# reconnect loop (the master may be respawning; its address may have
# moved, so DLROVER_MASTER_ADDR is re-read every probe) and, once the
# master answers again, replays a session-resync handshake before
# resuming the original request
RPC_RESYNC_TIMEOUT_ENV = "DLROVER_MASTER_RESYNC_TIMEOUT"


def compute_backoff(
    attempt: int,
    base: float = 0.5,
    cap: float = 8.0,
    rng: Optional[random.Random] = None,
) -> float:
    """Jittered exponential backoff: ``base * 2**attempt`` capped at
    ``cap``, with equal jitter (uniform over the upper half) so a
    partition that drops N clients at once does not resynchronize them
    into a reconnect stampede against a just-recovered master."""
    # clamp the exponent BEFORE exponentiating: with env-tuned retry
    # counts in the thousands (riding out a long partition), a bare
    # 2.0**attempt overflows to OverflowError mid-retry-loop
    b = min(base * (2.0 ** min(attempt, 60)), cap)
    rng = rng or random
    return b / 2.0 + rng.uniform(0.0, b / 2.0)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default

_LEN = struct.Struct(">Q")
_MAX_FRAME = GRPC.MAX_MESSAGE_BYTES

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


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def addr_connected(addr: str, timeout: float = 2.0) -> bool:
    """Telnet-style reachability probe (reference:
    elastic_run.py:326 _check_to_use_dlrover_run)."""
    try:
        host, port = addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=timeout):
            return True
    except OSError:
        return False


class RequestHandler:
    """Interface the server dispatches to (master servicer implements it)."""

    def report(self, node_id: int, node_type: str, message) -> bool:
        raise NotImplementedError

    def get(self, node_id: int, node_type: str, message):
        raise NotImplementedError


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
        # joined string) into the two-arg __init__ — every error
        # frame un-pickled client-side died with a TypeError instead
        # of surfacing the typed remote failure
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


class _Connection(socketserver.BaseRequestHandler):
    def handle(self):
        server: "MessageServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = _recv_frame(sock)
            except (ConnectionError, OSError):
                return
            except Exception:
                logger.exception("malformed frame; dropping connection")
                return
            t_dispatch = time.perf_counter()
            bare_verb = "?"
            try:
                verb, node_id, node_type, req_id, message = frame[:5]
                bare_verb = verb if verb in ("get", "report") else "?"
                trace_ctx = frame[5] if len(frame) > 5 else None
                try:
                    # server-side chaos: a drop kills the connection
                    # BEFORE dispatch, so the client's retry replays
                    # the request against an intact handler (the
                    # response cache covers the executed-but-unacked
                    # case); a delay just stretches dispatch
                    _chaos.fire(
                        "rpc.server.dispatch",
                        verb=verb, node_id=node_id,
                    )
                except ConnectionError:
                    return
                hit, resp = server.response_cache.get(req_id)
                if not hit:
                    with _tracing.attach_context(trace_ctx):
                        if verb == "get":
                            resp = server.handler.get(
                                node_id, node_type, message
                            )
                        elif verb == "report":
                            resp = server.handler.report(
                                node_id, node_type, message
                            )
                        else:
                            resp = RemoteError(
                                "ValueError", f"unknown verb {verb!r}"
                            )
                    server.response_cache.put(req_id, resp)
            except Exception as e:
                logger.exception("handler error for frame %r", frame[:1])
                resp = RemoteError(
                    type(e).__name__, str(e), traceback.format_exc()
                )
            try:
                _send_frame(sock, resp)
                _RPC_SERVER_SECONDS.observe(
                    time.perf_counter() - t_dispatch, verb=bare_verb
                )
            except (ConnectionError, OSError):
                return
            except Exception:
                # unpicklable handler response: report instead of dying
                logger.exception("unpicklable response %r", type(resp))
                try:
                    _send_frame(
                        sock,
                        RemoteError(
                            "PicklingError",
                            f"unpicklable response of type {type(resp)}",
                        ),
                    )
                except (ConnectionError, OSError):
                    return


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    """Thread-per-connection server with connection accounting and
    an optional concurrency guard.

    The base class spawns an unbounded thread per accepted socket
    with zero visibility — under fleet-scale fan-in (hundreds of
    persistent agent connections) that is both the resource to watch
    and the one to bound.  Accounting feeds the
    ``dlrover_master_connections`` gauge; ``max_conns`` (ctor /
    ``DLROVER_MASTER_MAX_CONNS``) rejects over-limit connects with a
    clean :class:`RemoteError` frame (the client surfaces it as a
    typed exception instead of a hang) before any thread is spawned.
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler_cls, max_conns: int = 0):
        self.max_conns = int(max_conns)
        self._conn_lock = threading.Lock()
        self._conns_active = 0
        self._conns_accepted = 0
        self._conns_peak = 0
        super().__init__(addr, handler_cls)

    def _publish_conn_stats(self):
        # caller holds _conn_lock
        _CONNS_GAUGE.set(self._conns_accepted, state="accepted")
        _CONNS_GAUGE.set(self._conns_active, state="active")
        _CONNS_GAUGE.set(self._conns_peak, state="peak")

    def process_request(self, request, client_address):
        with self._conn_lock:
            if self.max_conns and self._conns_active >= self.max_conns:
                reject = True
            else:
                reject = False
                self._conns_active += 1
                self._conns_accepted += 1
                self._conns_peak = max(
                    self._conns_peak, self._conns_active
                )
            self._publish_conn_stats()
        if reject:
            _CONNS_REJECTED_TOTAL.inc()
            logger.warning(
                "connection from %s rejected: %d active >= "
                "max_conns %d", client_address, self._conns_active,
                self.max_conns,
            )
            # the handshake runs on a SHORT-LIVED thread (bounded by
            # the rejection rate, not the connection count — the
            # guard's point stands): the client's first request must
            # be DRAINED before closing, or close() on a socket with
            # unread bytes RSTs and can discard the queued error
            # frame — the client would then see ECONNRESET and burn
            # its whole retry envelope instead of failing typed
            threading.Thread(
                target=self._reject_conn,
                args=(request,),
                daemon=True,
                name="conn-reject",
            ).start()
            return
        super().process_request(request, client_address)

    def _reject_conn(self, request):
        try:
            request.settimeout(2.0)
            try:
                _recv_frame(request)  # drain the first request
            except Exception:  # noqa: BLE001 - any garbage is fine,
                pass  # the point is emptying the receive queue
            _send_frame(request, RemoteError(
                "ResourceExhausted",
                f"master connection limit {self.max_conns} "
                "reached",
            ))
            try:
                request.shutdown(socket.SHUT_WR)
            except OSError:
                pass
        except (OSError, ValueError):
            pass
        finally:
            self.shutdown_request(request)

    def finish_request(self, request, client_address):
        # runs on the per-connection thread; the finally fires when
        # the handler returns, so `active` tracks live threads (the
        # reject path never incremented and never lands here)
        try:
            super().finish_request(request, client_address)
        finally:
            with self._conn_lock:
                self._conns_active = max(0, self._conns_active - 1)
                self._publish_conn_stats()


class MessageServer:
    """Threaded request server (role of create_master_service,
    reference servicer.py:630)."""

    def __init__(
        self,
        port: int,
        handler: RequestHandler,
        host: str = "0.0.0.0",
        cache_capacity: int = 8192,
        max_conns: Optional[int] = None,
    ):
        """``cache_capacity`` bounds the idempotent-retry response
        cache; servers whose responses are LARGE (e.g. the coworker
        data service shipping whole batches) should size it to what
        memory affords x the retry window they must cover.
        ``max_conns`` (default ``DLROVER_MASTER_MAX_CONNS``, 0 =
        unlimited) bounds concurrent connections — each costs a
        server thread, and fleet-scale fan-in must degrade with a
        clean typed error instead of a thread pile-up."""
        self.handler = handler
        if max_conns is None:
            max_conns = int(_env_float(MAX_CONNS_ENV, 0))
        self._server = _ThreadingTCPServer(
            (host, port), _Connection, max_conns=max_conns
        )
        self._server.handler = handler  # type: ignore[attr-defined]
        self._server.response_cache = ResponseCache(  # type: ignore[attr-defined]
            capacity=cache_capacity
        )
        self._thread: Optional[threading.Thread] = None
        self.port = self._server.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="message-server",
            daemon=True,
        )
        self._thread.start()
        logger.info("MessageServer listening on port %s", self.port)

    def stop(self):
        # shutdown() blocks forever if serve_forever never ran (stop
        # before start); only the socket close is needed then
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()


class MessageClient:
    """Persistent client connection with retry (role of MasterClient's
    channel layer, reference elastic_agent/master_client.py:28
    retry_grpc_request)."""

    def __init__(
        self,
        addr: str,
        node_id: int = -1,
        node_type: str = "",
        timeout: float = 60.0,
        retries: Optional[int] = None,
        backoff_base: Optional[float] = None,
        backoff_max: Optional[float] = None,
        resync_timeout: Optional[float] = None,
    ):
        self._addr = addr
        self._node_id = node_id
        self._node_type = node_type
        self._timeout = timeout
        self._retries = max(1, int(
            retries if retries is not None
            else _env_float(RPC_RETRIES_ENV, 10)
        ))
        self._backoff_base = (
            backoff_base if backoff_base is not None
            else _env_float(RPC_BACKOFF_BASE_ENV, 0.5)
        )
        self._backoff_max = (
            backoff_max if backoff_max is not None
            else _env_float(RPC_BACKOFF_MAX_ENV, 8.0)
        )
        # 0 disables the park-for-respawn loop (the generic default:
        # ad-hoc clients should fail fast); the agent's MasterClient
        # turns it on so a master crash/restart is survivable
        self._resync_timeout = (
            resync_timeout if resync_timeout is not None
            else _env_float(RPC_RESYNC_TIMEOUT_ENV, 0.0)
        )
        self._session_resync_cb = None
        self._in_resync = False
        self._last_resync = -1e9
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def set_session_resync(self, callback):
        """Register the handshake replayed after a master comes back
        from a crash (the agent's MasterClient sends node id, restart
        count, last reported step and last acked task so the recovered
        master rebuilds live state without restarting trainers)."""
        self._session_resync_cb = callback

    def _connect(self) -> socket.socket:
        host, port = self._addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _RPC_RECONNECTS_TOTAL.inc()
        return sock

    def _roundtrip(self, verb: str, message):
        """One logical request, surviving both transient drops and a
        full master crash/restart.

        The inner attempt loop walks the jittered-backoff envelope.
        When it is exhausted and a resync window is configured, the
        client parks: it re-resolves the master address and probes
        reachability until the (re)spawned master answers or the
        window closes, replays the session-resync handshake, then
        retries the request — same req id, so a request the dead
        master executed-but-never-acked is answered from the response
        cache (or harmlessly re-executed by the recovered master,
        whose journal replay made the handlers idempotent)."""
        # one id for all attempts: a retry of an executed-but-unacked
        # request is answered from the server's response cache
        req_id = uuid.uuid4().hex
        try:
            return self._attempt_loop(verb, message, req_id)
        except (ConnectionError, OSError) as e:
            if self._resync_timeout <= 0:
                raise
            if not self._await_master(e):
                raise ConnectionError(
                    f"master at {self._addr} did not come back within "
                    f"the {self._resync_timeout:.0f}s resync window: "
                    f"{e}"
                ) from e
            if not self._in_resync:
                self._run_session_resync()
            return self._attempt_loop(verb, message, req_id)

    def _await_master(self, cause: Exception) -> bool:
        """Bounded re-resolve/reconnect park: the master process died
        (or a long partition outlived the retry envelope).  Re-read
        the ambient master address every probe — a respawned master
        may come back elsewhere — and return once it accepts
        connections."""
        _RPC_RESYNC_PARKS_TOTAL.inc()
        logger.warning(
            "master at %s unreachable (%s); parking up to %.0fs for "
            "a respawn", self._addr, cause, self._resync_timeout,
        )
        deadline = time.monotonic() + self._resync_timeout
        while time.monotonic() < deadline:
            env_addr = os.environ.get(NodeEnv.MASTER_ADDR, "")
            if env_addr and env_addr != self._addr:
                logger.warning(
                    "master address re-resolved: %s -> %s",
                    self._addr, env_addr,
                )
                self._addr = env_addr
            if addr_connected(self._addr, timeout=1.0):
                _RPC_RESYNC_RECONNECTS_TOTAL.inc()
                logger.info(
                    "master back at %s; resuming", self._addr
                )
                return True
            time.sleep(0.2 + self._rng.uniform(0.0, 0.2))
        return False

    def _run_session_resync(self):
        cb = self._session_resync_cb
        if cb is None:
            return
        self._in_resync = True
        try:
            cb()
        except Exception as e:  # noqa: BLE001 - the resync is
            # best-effort state rebuild; the original request decides
            # success
            logger.warning("session resync handshake failed: %s", e)
        finally:
            self._in_resync = False

    def _note_recovered(self):
        """A request succeeded AFTER at least one connection-level
        failure: the master may be a respawned incarnation that knows
        nothing of this session (its response cache and live state
        died with its predecessor), so replay the resync handshake.
        Rate-limited: a flaky window produces many reconnects but one
        handshake rebuilds everything."""
        if self._session_resync_cb is None or self._in_resync:
            return
        now = time.monotonic()
        if now - self._last_resync < 2.0:
            return
        self._last_resync = now
        self._run_session_resync()

    def _attempt_loop(self, verb: str, message, req_id: str):
        """Bounded, jittered-backoff retries of one request.

        Every attempt may fail at connect, send or receive — repeated
        connect failures (master rescheduling, RPC partition) walk the
        same exponential envelope as mid-stream drops, the sleep is
        jittered so a partition's worth of clients cannot reconnect in
        lockstep, and the final attempt raises immediately instead of
        paying one more backoff it can never use."""
        last_err: Optional[Exception] = None
        for attempt in range(self._retries):
            try:
                # chaos hook: a drop/partition rule raises
                # ConnectionError here and exercises exactly this
                # retry path; a delay rule stretches the roundtrip
                _chaos.fire(
                    "rpc.client.roundtrip", verb=verb, addr=self._addr
                )
                with self._lock:
                    if self._sock is None:
                        self._sock = self._connect()
                    # append the trace field only when a span is
                    # active: the common no-span frame stays a
                    # 5-tuple an un-upgraded server can unpack
                    trace_ctx = _tracing.inject_context()
                    frame = (
                        verb, self._node_id, self._node_type,
                        req_id, message,
                    )
                    if trace_ctx is not None:
                        frame += (trace_ctx,)
                    _send_frame(self._sock, frame)
                    resp = _recv_frame(self._sock)
                if isinstance(resp, Exception):
                    raise resp
                if last_err is not None:
                    # recovered after a connection-level failure: the
                    # server may be a fresh master incarnation —
                    # replay the session-resync handshake
                    self._note_recovered()
                return resp
            except (ConnectionError, OSError) as e:
                last_err = e
                _RPC_RETRIES_TOTAL.inc(verb=verb)
                with self._lock:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                if attempt + 1 >= self._retries:
                    break
                backoff = compute_backoff(
                    attempt, self._backoff_base, self._backoff_max,
                    self._rng,
                )
                logger.warning(
                    "connection to %s failed (%s); retry %d/%d in %.1fs",
                    self._addr, e, attempt + 1, self._retries, backoff,
                )
                time.sleep(backoff)
        raise ConnectionError(
            f"cannot reach master at {self._addr} after "
            f"{self._retries} attempts: {last_err}"
        )

    def get(self, message):
        return self._roundtrip("get", message)

    def report(self, message) -> bool:
        return bool(self._roundtrip("report", message))

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
