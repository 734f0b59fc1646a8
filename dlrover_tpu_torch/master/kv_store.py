"""Master-side key-value store.

Copy of ``dlrover_tpu/master/kv_store.py`` (the port imports nothing
of the JAX package).

Backs the rendezvous bootstrap store the agents expose to training
processes (role of the KV-store RPCs in
``dlrover/python/master/servicer.py`` + ``master_kv_store.py``): on
TPU the store carries the ``jax.distributed`` coordinator address and
any user barrier keys instead of a c10d TCPStore bootstrap.
"""

import threading
from typing import Dict, List, Optional


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, amount: int) -> int:
        """Atomic counter add (torch-Store-style ``add`` used for
        barriers)."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += amount
            self._store[key] = str(current).encode()
            self._cond.notify_all()
            return current

    def wait(self, keys: List[str], timeout: float = 300.0) -> bool:
        """Block until every key exists."""
        deadline = threading.TIMEOUT_MAX if timeout < 0 else timeout

        def _ready():
            return all(k in self._store for k in keys)

        with self._cond:
            return self._cond.wait_for(_ready, timeout=deadline)

    def delete(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._store.pop(key, None)

    def clear(self):
        with self._lock:
            self._store.clear()

    # -- crash recovery (master state journal) -------------------------

    def dump(self) -> Dict[str, str]:
        """JSON-safe copy of the store (values base64'd) for the
        master journal's full-state snapshot."""
        import base64

        with self._lock:
            return {
                k: base64.b64encode(v).decode("ascii")
                for k, v in self._store.items()
            }

    def load(self, dumped: Dict[str, str]):
        """Restore a :meth:`dump` (journal replay); waiters on
        restored keys are released."""
        import base64

        with self._cond:
            for k, v in dumped.items():
                try:
                    self._store[k] = base64.b64decode(v)
                except (ValueError, TypeError):
                    continue
            self._cond.notify_all()
