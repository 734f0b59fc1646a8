"""Coworker data service: CPU data hosts feed accelerator hosts.

Reference: ``atorch/service/coworker_data_service.py:1`` +
``atorch/data/coworker_dataset.py:1`` + the coworker process-group
creation (``atorch/distributed/distributed.py:565``) — CPU pods run
read + collate and stream ready batches over gRPC so accelerator
pods never spend step time on input work.

Copy of ``dlrover_tpu/trainer/coworker.py``, over the port's control-
plane transport (:mod:`dlrover_tpu_torch.common.comm` — framed pickles
over TCP with the restricted unpickler; numpy arrays are allowlisted):

- **data host**: :class:`CoworkerDataService` builds batches in
  worker threads into a bounded ready queue and answers
  ``next_batch`` requests; one service can feed many trainer hosts
  (each request pops the next batch — the dynamic-sharding contract
  of the reference's data service).
- **trainer host**: :class:`CoworkerDataLoader` streams batches over
  a persistent connection with lookahead (the next request is in
  flight while the current batch trains), places them on its
  ``device`` as the elastic loader does (a pinned host copy, then a
  copy on a side stream the consumer's stream waits on:
  :class:`~dlrover_tpu_torch.trainer.dataset.DevicePlacer`), and
  reports cumulative ``input_wait_s`` so the input-bound fraction of
  step time is measurable — the same contract as
  :class:`dlrover_tpu_torch.trainer.shm_loader.ShmDataLoader`, crossing
  a host boundary instead of a process one.
"""

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.comm import (
    MessageClient,
    MessageServer,
    RequestHandler,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer.dataset import default_collate


class CoworkerDataService(RequestHandler):
    """Data-host side: build batches ahead of demand, serve them over
    the comm layer.

    ``read_fn(index) -> sample`` and ``collate_fn(samples) -> batch``
    run in ``num_workers`` threads (reads are IO-bound; numpy collate
    releases the GIL for the memcpy-heavy part).  ``port=0`` picks a
    free port — read it back from ``.port``.
    """

    def __init__(
        self,
        read_fn: Callable[[int], Any],
        batch_size: int,
        index_iter,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 2,
        queue_depth: int = 8,
        port: int = 0,
        host: str = "0.0.0.0",
    ):
        self.batch_size = batch_size
        self._read_fn = read_fn
        self._collate = collate_fn or default_collate
        self._index_iter = iter(index_iter)
        self._index_lock = threading.Lock()
        self._ready: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        # the server socket exists before start(): a next_batch
        # arriving in that window must wait, not see end-of-data
        self._started = threading.Event()
        # one failed batch build poisons the service for EVERY
        # consumer: a single queued ('error',) item would reach one
        # consumer while the rest saw a clean end and silently lost
        # the failed batch's samples
        self._error: Optional[str] = None
        self._served = 0
        self._build_s = 0.0
        self._workers = [
            threading.Thread(target=self._build_loop, daemon=True)
            for _ in range(max(1, num_workers))
        ]
        # responses here are whole batches: the default 8192-frame
        # retry cache would pin gigabytes, while too few entries can
        # evict an executed-but-unacked batch before its retry lands
        # (losing those samples); 256 covers many consumers' retry
        # windows at bounded memory
        self._server = MessageServer(
            port, self, host=host, cache_capacity=256
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CoworkerDataService":
        self._server.start()
        for w in self._workers:
            w.start()
        self._started.set()
        return self

    def stop(self):
        self._stop.set()
        # unblock builders stuck on a full ready queue
        try:
            while True:
                self._ready.get_nowait()
        except queue.Empty:
            pass
        self._server.stop()

    @property
    def port(self) -> int:
        return self._server.port

    # -- batch building ----------------------------------------------------

    def _next_indices(self) -> Optional[List[int]]:
        with self._index_lock:
            out = []
            for _ in range(self.batch_size):
                try:
                    out.append(next(self._index_iter))
                except StopIteration:
                    break
            return out or None

    def _build_loop(self):
        while not self._stop.is_set():
            indices = self._next_indices()
            if indices is None:
                return
            t0 = time.perf_counter()
            try:
                batch = self._collate(
                    [self._read_fn(i) for i in indices]
                )
            except Exception as e:  # noqa: BLE001 - ship to trainer
                logger.error("coworker batch build failed: %s", e)
                self._error = repr(e)
                return
            self._build_s += time.perf_counter() - t0
            with self._id_lock:
                batch_id = self._next_id
                self._next_id += 1
            self._put(("batch", batch_id, batch))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._ready.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    # -- RequestHandler ----------------------------------------------------

    def report(self, node_id, node_type, message) -> bool:
        return True

    def get(self, node_id, node_type, message):
        if message == "stats":
            return self.stats()
        if message != "next_batch":
            raise ValueError(f"unknown coworker request {message!r}")
        while True:
            if self._error is not None:
                return ("error", self._error)
            if self._stop.is_set():
                # stop() without (or before) start(): release any
                # waiting consumer instead of polling forever
                return ("end",)
            try:
                # short poll: the END answer must not cost a long
                # timeout cycle (it lands in the consumer's
                # input-wait accounting)
                item = self._ready.get(timeout=0.05)
            except queue.Empty:
                if not self._started.is_set():
                    # start() has not run yet: the workers exist but
                    # none has started — is_alive() would read as
                    # end-of-data
                    continue
                # end-of-data only when no builder can still
                # produce a batch (builders exit only after draining
                # the index iterator; one may still hold an in-flight
                # batch, so every builder thread must be gone)
                alive = any(w.is_alive() for w in self._workers)
                if (not alive and self._ready.empty()
                        and self._error is None):
                    return ("end",)
                continue
            self._served += 1 if item[0] == "batch" else 0
            return item

    def stats(self) -> Dict[str, float]:
        return {
            "served": self._served,
            "build_s": round(self._build_s, 4),
            "ready_depth": self._ready.qsize(),
        }


class CoworkerDataLoader:
    """Trainer-host side: stream batches from a coworker service.

    A fetcher thread keeps ``prefetch`` requests ahead of the
    consumer (the network round trip and the service-side build
    overlap device compute); batches are torch tensors on ``device``
    (the GPU unless another is named).
    """

    def __init__(
        self,
        addr: str,
        device=None,
        prefetch: int = 2,
        node_id: int = 0,
        timeout: float = 60.0,
    ):
        from dlrover_tpu_torch.trainer.dataset import DevicePlacer

        self._addr = addr
        self._placer = DevicePlacer(device)
        self._prefetch = max(1, prefetch)
        self._client = MessageClient(
            addr, node_id=node_id, node_type="coworker_consumer",
            timeout=timeout,
        )
        self._q: "queue.Queue" = queue.Queue(
            maxsize=self._prefetch
        )
        self._fetcher: Optional[threading.Thread] = None
        self._input_wait_s = 0.0
        self._batches = 0

    def _fetch_loop(self):
        while True:
            try:
                item = self._client.get("next_batch")
            except Exception as e:  # noqa: BLE001
                item = ("error", repr(e))
            self._q.put(item)
            if item[0] != "batch":
                return

    def _place(self, batch):
        return self._placer.place(batch)[0]

    def __iter__(self):
        if self._fetcher is not None:
            # a second iteration would race the first fetcher on the
            # shared queue and replay its stale prefetched batches —
            # the loader is one stream; make a new one per epoch
            raise RuntimeError(
                "CoworkerDataLoader is single-use: create a new "
                "loader (new connection) for another pass"
            )
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True
        )
        self._fetcher.start()
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self._input_wait_s += time.perf_counter() - t0
            kind = item[0]
            if kind == "end":
                return
            if kind == "error":
                raise RuntimeError(
                    f"coworker data service failed: {item[1]}"
                )
            _, batch_id, batch = item
            self._batches += 1
            yield self._place(batch)

    def stats(self) -> Dict[str, float]:
        """Cumulative input-side accounting (the loader contract the
        bench's input-bound fraction reads)."""
        return {
            "input_wait_s": round(self._input_wait_s, 4),
            "batches": self._batches,
        }

    def service_stats(self) -> Dict[str, float]:
        return self._client.get("stats")
