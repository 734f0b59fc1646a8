"""Worker side of dynamic data sharding.

Reference: ``dlrover/python/elastic_agent/sharding/client.py:29,231``
(``ShardingClient`` / ``IndexShardingClient``).  Workers pull shard
tasks (index ranges) from the master, ack completed shards so the
master can recycle a dead worker's outstanding shards, and checkpoint
the dataset position.  ``IndexShardingClient`` flattens shards into a
per-sample index stream with a prefetch thread, which is what elastic
datasets consume.

Copy of ``dlrover_tpu/agent/sharding_client.py`` over the port's
``MasterClient``: host code, no torch.  The dataset checkpoint strings
of ``get_checkpoint()`` and ``restore_checkpoint()`` are the master's,
the same in both packages.
"""

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ShardTask


class ShardingClient:
    """Shard-level client: get_task / report_task_result."""

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        shuffle: bool = False,
        task_type: str = TaskType.TRAINING,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "text",
        master_client: Optional[MasterClient] = None,
    ):
        self._client = master_client or MasterClient.singleton()
        self.dataset_name = dataset_name
        self.batch_size = batch_size
        self._lock = threading.Lock()
        self._current_task: Optional[ShardTask] = None
        self._pending: List[ShardTask] = []
        # Idempotent on the master side: the first worker to report wins.
        self._client.report_dataset_shard_params(
            batch_size=batch_size,
            num_epochs=num_epochs,
            dataset_size=dataset_size,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            dataset_name=dataset_name,
            task_type=task_type,
            storage_type=storage_type,
        )

    def fetch_task(self) -> Optional[ShardTask]:
        """Fetch the next shard; None once the dataset is exhausted."""
        while True:
            task: ShardTask = self._client.get_task(self.dataset_name)
            if task.task_type == TaskType.WAIT:
                time.sleep(2)
                continue
            if task.task_id < 0:
                return None
            with self._lock:
                self._pending.append(task)
                self._current_task = task
            return task

    def report_task_done(
        self, task_id: Optional[int] = None, success: bool = True,
        error: str = "",
    ):
        with self._lock:
            if task_id is None and self._pending:
                task_id = self._pending[0].task_id
            self._pending = [t for t in self._pending if t.task_id != task_id]
        if task_id is not None:
            self._client.report_task_result(
                self.dataset_name, task_id, success=success, error=error
            )

    def get_checkpoint(self) -> str:
        return self._client.get_dataset_checkpoint(self.dataset_name)

    def restore_checkpoint(self, content: str):
        self._client.restore_dataset_checkpoint(self.dataset_name, content)


class IndexShardingClient(ShardingClient):
    """Per-sample index stream over shard tasks with background
    prefetch (reference: sharding/client.py:231)."""

    def __init__(self, *args, prefetch_depth: int = 4096, **kwargs):
        super().__init__(*args, **kwargs)
        self._index_queue: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=prefetch_depth
        )
        # Delivery-order accounting: fetch_sample_index appends each
        # delivered sample's task_id; report_batch_done pops in FIFO
        # order and acks a task once all its samples are processed.
        # (The prefetch thread runs far ahead of the consumer, so the
        # "currently consumed shard" can only be derived from delivery
        # order, never from the prefetch position.)
        self._delivered: "deque[int]" = deque()
        self._task_sizes: Dict[int, int] = {}
        self._acked_counts: Dict[int, int] = {}
        self._consume_lock = threading.Lock()
        self._stopped = threading.Event()
        self._prefetch_thread = threading.Thread(
            target=self._prefetch_loop, daemon=True, name="index-prefetch"
        )
        self._prefetch_thread.start()

    def _prefetch_loop(self):
        try:
            while not self._stopped.is_set():
                task = self.fetch_task()
                if task is None:
                    self._index_queue.put(None)
                    return
                indices = (
                    task.indices
                    if task.indices is not None
                    else list(range(task.start, task.end))
                )
                with self._consume_lock:
                    self._task_sizes[task.task_id] = len(indices)
                for idx in indices:
                    self._index_queue.put((task.task_id, idx))
        except Exception as e:  # noqa: BLE001
            logger.error("index prefetch thread died: %s", e)
            self._index_queue.put(None)

    def fetch_sample_index(self, timeout: float = 300.0) -> Optional[int]:
        """Next global sample index, or None at end of data."""
        item = self._index_queue.get(timeout=timeout)
        if item is None:
            return None
        task_id, idx = item
        with self._consume_lock:
            self._delivered.append(task_id)
        return idx

    def report_batch_done(self, batch_size: Optional[int] = None):
        """Mark the next ``batch_size`` delivered samples processed;
        ack each shard whose samples are all processed (reference:
        client.py report_batch_done)."""
        consumed = batch_size or self.batch_size
        to_ack = []
        with self._consume_lock:
            for _ in range(consumed):
                if not self._delivered:
                    break
                tid = self._delivered.popleft()
                self._acked_counts[tid] = (
                    self._acked_counts.get(tid, 0) + 1
                )
                if self._acked_counts[tid] >= self._task_sizes.get(
                    tid, float("inf")
                ):
                    to_ack.append(tid)
                    del self._acked_counts[tid]
                    del self._task_sizes[tid]
        for tid in to_ack:
            self.report_task_done(tid)

    def stop(self):
        self._stopped.set()
