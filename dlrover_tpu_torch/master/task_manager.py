"""Server side of dynamic data sharding.

Copy of ``dlrover_tpu/master/task_manager.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/shard/task_manager.py`` +
``batch_dataset_manager.py``: per-dataset shard task queues, dispatch to
whichever worker asks, ack on completion, timeout-based reassignment of
tasks whose worker died or stalled, and dataset position
checkpoint/restore so a relaunched job resumes mid-epoch.
"""

import dataclasses
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import DatasetShardParams, ShardTask
from dlrover_tpu_torch.master.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)
from dlrover_tpu_torch.telemetry.events import emit_event

_TASK_TIMEOUT = 1800.0


@dataclass
class _DoingTask:
    task: ShardTask
    worker_id: int
    start_time: float = field(default_factory=time.time)


class BatchDatasetManager:
    """Dispatches one dataset's shard tasks (reference
    ``batch_dataset_manager.py:203``)."""

    def __init__(self, task_type: str, splitter: DatasetSplitter):
        self.task_type = task_type
        self.splitter = splitter
        self.todo: List[ShardTask] = []
        self.doing: Dict[int, _DoingTask] = {}
        self._task_id = 0
        self._completed_count = 0
        # last successful ack — hang detection keys off real progress,
        # not dispatch (a worker looping fetch-without-ack must still
        # read as hung even while reassignment cycles its tasks)
        self.last_ack_time = time.time()

    def _fill_todo(self):
        if self.todo or self.doing:
            return
        if self.splitter.epoch_finished():
            return
        self.splitter.create_shards()
        for shard in self.splitter.get_shards():
            self.todo.append(
                ShardTask(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    dataset_name=self.splitter.dataset_name,
                    start=shard.start,
                    end=shard.end,
                    indices=shard.indices,
                )
            )
            self._task_id += 1

    def get_task(self, worker_id: int) -> ShardTask:
        self._fill_todo()
        if not self.todo:
            if self.doing:
                return ShardTask(task_id=-1, task_type=TaskType.WAIT)
            return ShardTask(task_id=-1, task_type=TaskType.NONE)
        task = self.todo.pop(0)
        self.doing[task.task_id] = _DoingTask(task, worker_id)
        return task

    def report_task(self, task_id: int, success: bool) -> bool:
        doing = self.doing.pop(task_id, None)
        if doing is None:
            return False
        if success:
            self._completed_count += 1
            self.last_ack_time = time.time()
        else:
            self.todo.insert(0, doing.task)
        return True

    def recycle_worker_tasks(self, worker_id: int):
        """Return a dead worker's shards to the queue (reference
        TaskRescheduleCallback behaviour)."""
        stale = [
            tid
            for tid, d in self.doing.items()
            if d.worker_id == worker_id
        ]
        for tid in stale:
            self.todo.insert(0, self.doing.pop(tid).task)
        if stale:
            logger.info(
                "recycled %d tasks of worker %s on dataset %s",
                len(stale),
                worker_id,
                self.splitter.dataset_name,
            )

    def reassign_timeout_tasks(self, timeout: float = _TASK_TIMEOUT):
        now = time.time()
        stale = [
            tid
            for tid, d in self.doing.items()
            if now - d.start_time > timeout
        ]
        for tid in stale:
            self.todo.insert(0, self.doing.pop(tid).task)

    def completed(self) -> bool:
        return (
            self.splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    @property
    def completed_count(self) -> int:
        return self._completed_count

    def checkpoint(self) -> Dict:
        """Doing tasks fold back into todo: an un-acked shard is redone
        after restore (reference ``get_dataset_checkpoint:243``)."""
        todo = [
            (t.task.start, t.task.end) for t in self.doing.values()
        ] + [(t.start, t.end) for t in self.todo]
        return {
            "dataset": self.splitter.dataset_name,
            "epoch": self.splitter.epoch,
            "completed": self._completed_count,
            "todo": todo,
        }

    def restore(self, state: Dict):
        self.splitter.epoch = state.get("epoch", 0)
        self._completed_count = state.get("completed", 0)
        self.todo = []
        self.doing = {}
        for start, end in state.get("todo", []):
            self.todo.append(
                ShardTask(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    dataset_name=self.splitter.dataset_name,
                    start=start,
                    end=end,
                )
            )
            self._task_id += 1

    # -- master crash recovery (state journal) -------------------------

    def full_state(self) -> Dict:
        """Exact internal state for the master journal's snapshot —
        unlike :meth:`checkpoint` (the worker-facing dataset position)
        it preserves in-flight leases with their task ids, so journal
        records appended after the snapshot still resolve."""
        return {
            "epoch": self.splitter.epoch,
            "completed": self._completed_count,
            "next_task_id": self._task_id,
            "todo": [(t.start, t.end) for t in self.todo],
            "doing": [
                {
                    "task_id": tid,
                    "worker": d.worker_id,
                    "start": d.task.start,
                    "end": d.task.end,
                }
                for tid, d in self.doing.items()
            ],
        }

    def load_full_state(self, state: Dict):
        self.splitter.epoch = int(state.get("epoch", 0))
        self._completed_count = int(state.get("completed", 0))
        self._task_id = int(state.get("next_task_id", 0))
        self.todo = [
            ShardTask(
                task_id=-1,
                task_type=self.task_type,
                dataset_name=self.splitter.dataset_name,
                start=start,
                end=end,
            )
            for start, end in state.get("todo", [])
        ]
        self.doing = {}
        for lease in state.get("doing", []):
            task = ShardTask(
                task_id=int(lease["task_id"]),
                task_type=self.task_type,
                dataset_name=self.splitter.dataset_name,
                start=int(lease["start"]),
                end=int(lease["end"]),
            )
            self.doing[task.task_id] = _DoingTask(
                task, int(lease.get("worker", -1))
            )

    def replay_dispatch(
        self, task_id: int, worker_id: int, start: int, end: int
    ):
        """Re-apply one journaled dispatch: move the (start, end)
        shard from todo into a lease under the journaled task id.  The
        splitters are deterministic (seeded shuffle), so refilling the
        todo queue regenerates identical shards — indices included."""
        self._fill_todo()
        task: Optional[ShardTask] = None
        for i, t in enumerate(self.todo):
            if t.start == start and t.end == end:
                task = self.todo.pop(i)
                break
        if task is None:
            # a re-dispatch of a shard replay still holds in doing
            # (recycle/timeout raced the journal order)
            for tid, d in list(self.doing.items()):
                if d.task.start == start and d.task.end == end:
                    task = self.doing.pop(tid).task
                    break
        if task is None:
            # state drift (e.g. restored from an older snapshot):
            # rebuild the lease from the journaled range rather than
            # losing the shard
            task = ShardTask(
                task_id=task_id,
                task_type=self.task_type,
                dataset_name=self.splitter.dataset_name,
                start=start,
                end=end,
            )
        task.task_id = task_id
        self.doing[task_id] = _DoingTask(task, worker_id)
        self._task_id = max(self._task_id, task_id + 1)

    def replay_ack(self, task_id: int, success: bool):
        doing = self.doing.pop(task_id, None)
        if doing is None:
            return
        if success:
            self._completed_count += 1
            self.last_ack_time = time.time()
        else:
            self.todo.insert(0, doing.task)

    def requeue_unacked(self) -> int:
        """Recovery epilogue: every lease that was never acked goes
        back to the head of the queue — delivered-but-unacked shards
        are redone (at-least-once), acked shards never re-dispatch
        (their ack is journaled), so none are lost and none complete
        twice."""
        stale = sorted(self.doing)
        self.todo[:0] = [self.doing.pop(tid).task for tid in stale]
        return len(stale)

    def reconcile_acked(self, task_id: int) -> bool:
        """A surviving worker reports (at session resync) that it
        already acked ``task_id``, but this master does not hold it as
        done — the journal MIRROR's group-commit lag can lose the last
        window of acks on a different-host respawn.  Complete the task
        now, whether the recovered state holds it as an in-flight
        lease or (already re-queued) back in todo; the deterministic
        splitter keeps task ids stable across replays, so the id is a
        safe key.  Returns whether anything changed."""
        doing = self.doing.pop(task_id, None)
        if doing is not None:
            self._completed_count += 1
            self.last_ack_time = time.time()
            return True
        for i, t in enumerate(self.todo):
            if t.task_id == task_id:
                self.todo.pop(i)
                self._completed_count += 1
                self.last_ack_time = time.time()
                return True
        return False


class StreamingDatasetManager(BatchDatasetManager):
    """Unbounded-stream dispatch (reference
    ``streaming_dataset_manager.py:204``): shards are emitted from
    growing partition offsets, the todo queue refills while earlier
    shards are still in flight, and the checkpoint carries the
    partition offsets so a restore resumes the stream exactly where
    acked consumption stopped (un-acked shards are re-queued)."""

    def _fill_todo(self):
        # streams keep flowing: refill whenever the todo queue drains,
        # without waiting for in-flight shards to complete
        if self.todo:
            return
        if self.splitter.epoch_finished():
            return
        self.splitter.create_shards()
        for shard in self.splitter.get_shards():
            self.todo.append(
                ShardTask(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    dataset_name=self.splitter.dataset_name,
                    start=shard.start,
                    end=shard.end,
                    indices=shard.indices,
                )
            )
            self._task_id += 1

    def completed(self) -> bool:
        # unbounded unless the splitter was capped
        return (
            self.splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    def checkpoint(self) -> Dict:
        state = super().checkpoint()
        state["partition_offsets"] = dict(
            self.splitter.partition_offsets.offsets
        )
        state["emitted"] = self.splitter._emitted
        return state

    def restore(self, state: Dict):
        super().restore(state)
        offsets = state.get("partition_offsets")
        if offsets is not None:
            self.splitter.partition_offsets.offsets = dict(offsets)
        self.splitter._emitted = state.get("emitted", 0)

    def full_state(self) -> Dict:
        state = super().full_state()
        state["partition_offsets"] = dict(
            self.splitter.partition_offsets.offsets
        )
        state["emitted"] = self.splitter._emitted
        return state

    def load_full_state(self, state: Dict):
        super().load_full_state(state)
        offsets = state.get("partition_offsets")
        if offsets is not None:
            # JSON round-trips dict keys as strings; partitions are ints
            self.splitter.partition_offsets.offsets = {
                int(k): v for k, v in offsets.items()
            }
        self.splitter._emitted = int(state.get("emitted", 0))


class TaskManager:
    """Owns every dataset's manager (reference ``TaskManager:37``)."""

    def __init__(self, worker_restart_timeout: float = 0.0):
        self._lock = threading.Lock()
        self._datasets: Dict[str, BatchDatasetManager] = {}
        self._dataset_params: Dict[str, Dict] = {}
        self._worker_restart_timeout = worker_restart_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # speed-monitor hook: set by the master so task completion can
        # feed throughput accounting
        self.speed_monitor = None
        # master crash recovery: when a StateJournal is attached every
        # dispatch/ack/registration is durably recorded BEFORE the
        # response leaves this process (journal.py)
        self.journal = None

    def _jot(self, kind: str, data: Dict):
        if self.journal is not None:
            self.journal.append(kind, data)

    def new_dataset(self, params: DatasetShardParams):
        with self._lock:
            self._new_dataset_locked(params)

    def _new_dataset_locked(self, params: DatasetShardParams):
        if params.dataset_name in self._datasets:
            return
        splitter = new_dataset_splitter(
            storage_type=params.storage_type,
            shuffle=params.shuffle,
            batch_size=params.batch_size,
            dataset_size=params.dataset_size,
            num_epochs=params.num_epochs,
            dataset_name=params.dataset_name,
            num_minibatches_per_shard=params.num_minibatches_per_shard,
        )
        manager_cls = (
            StreamingDatasetManager
            if params.storage_type == "stream"
            else BatchDatasetManager
        )
        self._datasets[params.dataset_name] = manager_cls(
            params.task_type or TaskType.TRAINING, splitter
        )
        self._dataset_params[params.dataset_name] = dataclasses.asdict(
            params
        )
        self._jot("dataset", self._dataset_params[params.dataset_name])
        logger.info(
            "new dataset %s registered (%s)",
            params.dataset_name, manager_cls.__name__,
        )

    def get_dataset_task(
        self, worker_id: int, dataset_name: str
    ) -> ShardTask:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return ShardTask(task_id=-1, task_type=TaskType.NONE)
            task = ds.get_task(worker_id)
            if task.task_id >= 0:
                # journal the lease before the shard leaves the
                # process: a crash after this line re-queues it, a
                # crash before never handed it out — either way no
                # shard is lost
                self._jot(
                    "dispatch",
                    {
                        "dataset": dataset_name,
                        "task_id": task.task_id,
                        "worker": worker_id,
                        "start": task.start,
                        "end": task.end,
                    },
                )
                emit_event(
                    "shard_dispatch",
                    dataset=dataset_name,
                    task_id=task.task_id,
                    worker=worker_id,
                    start=task.start,
                    end=task.end,
                )
        if task.task_id >= 0:
            # deterministic kill point for the master-recovery chaos
            # scenarios: "the Nth shard dispatch" is stable across
            # runs where wall-clock triggers are not
            _chaos.fire(
                "master.task_dispatch",
                dataset=dataset_name,
                task_id=task.task_id,
                worker=worker_id,
            )
        return task

    def report_dataset_task(
        self, dataset_name: str, task_id: int, success: bool
    ) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return False
            doing = ds.doing.get(task_id)
            accepted = ds.report_task(task_id, success)
            if accepted:
                self._jot(
                    "ack",
                    {
                        "dataset": dataset_name,
                        "task_id": task_id,
                        "success": bool(success),
                    },
                )
                emit_event(
                    "shard_ack",
                    dataset=dataset_name,
                    task_id=task_id,
                    success=bool(success),
                    start=doing.task.start if doing else -1,
                    end=doing.task.end if doing else -1,
                    worker=doing.worker_id if doing else -1,
                )
            return accepted

    def recycle_worker_tasks(self, worker_id: int):
        with self._lock:
            for ds in self._datasets.values():
                ds.recycle_worker_tasks(worker_id)

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.completed() for ds in self._datasets.values())

    def get_dataset_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return ""
            return json.dumps(ds.checkpoint())

    def restore_dataset_from_checkpoint(
        self, dataset_name: str, content: str
    ) -> bool:
        if not content:
            return False
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return False
            ds.restore(json.loads(content))
            self._jot(
                "ds_restore",
                {"dataset": dataset_name, "content": content},
            )
            return True

    # -- master crash recovery (state journal) -------------------------

    def snapshot_state(self) -> Dict:
        """Full sharding state for the journal snapshot."""
        with self._lock:
            return {
                name: {
                    "params": self._dataset_params.get(name, {}),
                    "state": ds.full_state(),
                }
                for name, ds in self._datasets.items()
            }

    def restore_state(self, state: Dict):
        """Load a journal snapshot (attach the journal only AFTER
        restore/replay, or replayed mutations re-journal)."""
        with self._lock:
            for name, entry in state.items():
                params = entry.get("params") or {}
                if params:
                    self._new_dataset_locked(
                        DatasetShardParams(**params)
                    )
                ds = self._datasets.get(name)
                if ds is not None:
                    ds.load_full_state(entry.get("state") or {})

    def apply_journal_entry(self, kind: str, data: Dict) -> bool:
        """Re-apply one incremental journal record; returns whether
        the kind belonged to this manager."""
        if kind == "dataset":
            self.new_dataset(DatasetShardParams(**data))
            return True
        if kind == "dispatch":
            with self._lock:
                ds = self._datasets.get(data.get("dataset", ""))
                if ds is not None:
                    ds.replay_dispatch(
                        int(data["task_id"]),
                        int(data.get("worker", -1)),
                        int(data["start"]),
                        int(data["end"]),
                    )
            return True
        if kind == "ack":
            with self._lock:
                ds = self._datasets.get(data.get("dataset", ""))
                if ds is not None:
                    ds.replay_ack(
                        int(data["task_id"]),
                        bool(data.get("success", True)),
                    )
            return True
        if kind == "ack_reconciled":
            with self._lock:
                ds = self._datasets.get(data.get("dataset", ""))
                if ds is not None:
                    ds.reconcile_acked(int(data["task_id"]))
            return True
        if kind == "ds_restore":
            self.restore_dataset_from_checkpoint(
                data.get("dataset", ""), data.get("content", "")
            )
            return True
        return False

    def reconcile_acked_task(
        self, dataset_name: str, task_id: int
    ) -> bool:
        """Session-resync reconciliation: the worker's reported last
        ack closes any lease the recovered master still holds open —
        the guard that keeps exactly-once sharding true when the
        journal MIRROR's group-commit lag dropped the final acks of a
        dead master (different-host respawn).  Journaled under its own
        kind so a later replay re-applies the completion without
        fabricating a ``shard_ack`` event (the original ack is already
        in the event log)."""
        if task_id < 0 or not dataset_name:
            return False
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return False
            changed = ds.reconcile_acked(task_id)
            if changed:
                self._jot(
                    "ack_reconciled",
                    {"dataset": dataset_name, "task_id": task_id},
                )
                logger.warning(
                    "resync reconciled lost ack: dataset %s task %s "
                    "(journal mirror lag)", dataset_name, task_id,
                )
            return changed

    def reconcile_acked_tasks(
        self, pairs: List[Tuple[str, int]]
    ) -> int:
        """Batched session-resync reconciliation: close every lease
        in ``pairs`` ((dataset, task_id) tuples — the agent's whole
        recent-ack history) and journal the changed ones with ONE
        multi-record append.  The per-ack flavour journaled each
        reconcile individually: a 64-ack resync did up to 64
        sequential appends under the journal io lock — the first
        control-plane SLO breach at 250 fleet agents.  Returns how
        many leases actually changed."""
        changed: List[Tuple[str, int]] = []
        with self._lock:
            for dataset_name, task_id in pairs:
                if task_id < 0 or not dataset_name:
                    continue
                ds = self._datasets.get(dataset_name)
                if ds is None:
                    continue
                if ds.reconcile_acked(task_id):
                    changed.append((dataset_name, task_id))
            if changed and self.journal is not None:
                self.journal.append_many([
                    (
                        "ack_reconciled",
                        {"dataset": d, "task_id": t},
                    )
                    for d, t in changed
                ])
        if changed:
            logger.warning(
                "resync reconciled %d lost ack(s) in one journal "
                "batch: %s (journal mirror lag)",
                len(changed),
                ", ".join(f"{d}#{t}" for d, t in changed[:8]),
            )
        return len(changed)

    def requeue_unacked(self) -> int:
        """Recovery epilogue: return every un-acked lease to the
        queues (the dead master's in-flight shards)."""
        with self._lock:
            return sum(
                ds.requeue_unacked() for ds in self._datasets.values()
            )

    # -- timeout reassignment thread --------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._reassign_loop, name="task-reassign", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _reassign_loop(self):
        while not self._stop.wait(30.0):
            with self._lock:
                for ds in self._datasets.values():
                    ds.reassign_timeout_tasks()

    def task_hanged(self, timeout: float = 1800.0) -> bool:
        """True when a dataset has work in flight or pending but no
        shard was successfully acked for ``timeout`` seconds (feeds
        master hang detection; reference ``task_manager.py:145``).
        Keyed off ack time, not dispatch time, so the periodic
        reassignment of stale tasks cannot mask the hang."""
        now = time.time()
        with self._lock:
            if not self._datasets:
                return False
            for ds in self._datasets.values():
                if (ds.doing or ds.todo) and (
                    now - ds.last_ack_time > timeout
                ):
                    return True
            return False
