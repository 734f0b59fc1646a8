"""Master restart recovery: snapshot capture + journal replay.

Copy of ``dlrover_tpu/master/recovery.py`` (the port imports nothing
of the JAX package).

The journal (:mod:`dlrover_tpu_torch.master.journal`) records WHAT happened;
this module knows WHERE each record lives in the master's sub-managers
— job manager node table, rendezvous rounds, dataset shard leases, KV
store, terminal exit decisions — and rebuilds them on a respawned
master.  Replay is idempotent: it only ever loads into freshly
constructed managers (the :class:`JobMaster` being built), and
applying the same snapshot+entries again produces the same state.
"""

import base64
from typing import Any, Dict

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.journal import JournalReplay


def capture_snapshot(master) -> Dict[str, Any]:
    """Full control-plane state of a live master, JSON-safe."""
    return {
        "job_name": master.job_name,
        "node_num": master.node_num,
        "recoveries": master.recoveries,
        "rdzv": {
            name: mngr.journal_state()
            for name, mngr in master.rdzv_managers.items()
        },
        "task_manager": master.task_manager.snapshot_state(),
        "job_manager": master.job_manager.snapshot_state(),
        "kv": master.kv_store.dump(),
        "resize": master.resize_coordinator.journal_state(),
    }


def restore_master(master, replayed: JournalReplay) -> Dict[str, int]:
    """Load a replayed journal into a freshly built master.

    Order matters: the snapshot first (base state), then the
    incremental entries in seq order, then the recovery epilogue that
    re-queues every un-acked shard lease — so a shard the dead master
    dispatched but never saw acked is redone, while an acked shard
    (its ack is journaled) never dispatches again."""
    snap = replayed.snapshot or {}
    if snap:
        master.recoveries = int(snap.get("recoveries", 0))
        master.task_manager.restore_state(
            snap.get("task_manager") or {}
        )
        master.job_manager.restore_state(
            snap.get("job_manager") or {}
        )
        master.kv_store.load(snap.get("kv") or {})
        for name, state in (snap.get("rdzv") or {}).items():
            mngr = master.rdzv_managers.get(name)
            if mngr is not None:
                mngr.restore_round(
                    state.get("round", 0),
                    state.get("participants") or {},
                )
                # network-check flavour: statuses/elapsed/grouping
                # from the snapshot, not just membership
                if hasattr(mngr, "restore_check_state"):
                    mngr.restore_check_state(state)
        # AFTER the rdzv rounds: pending-ness of a replayed resize is
        # judged against the restored round/world
        master.resize_coordinator.restore_state(
            snap.get("resize") or {}
        )
    applied = 0
    for _seq, kind, data in replayed.entries:
        try:
            if master.task_manager.apply_journal_entry(kind, data):
                applied += 1
                continue
            if master.job_manager.apply_journal_entry(kind, data):
                applied += 1
                continue
            if kind == "rdzv":
                mngr = master.rdzv_managers.get(data.get("name", ""))
                if mngr is not None:
                    mngr.restore_round(
                        data.get("round", 0),
                        data.get("participants") or {},
                    )
                applied += 1
                continue
            if master.resize_coordinator.apply_journal_entry(
                kind, data
            ):
                applied += 1
                continue
            if kind == "netcheck_status":
                master.network_rdzv.restore_status(
                    data.get("round", 0),
                    data.get("node_id", 0),
                    data.get("normal", True),
                    data.get("elapsed", 0.0),
                )
                applied += 1
                continue
            if kind == "kv_set":
                master.kv_store.set(
                    data.get("key", ""),
                    base64.b64decode(data.get("value", "")),
                )
                applied += 1
                continue
            if kind == "kv_add":
                master.kv_store.add(
                    data.get("key", ""), int(data.get("amount", 0))
                )
                applied += 1
                continue
            logger.warning("unknown journal record kind %r", kind)
        except Exception:  # noqa: BLE001 - one bad record must not
            # abort recovery; prefix consistency already bounds what
            # a corrupt entry can reference
            logger.exception(
                "journal replay failed for %r record", kind
            )
    master.resize_coordinator.reconcile_after_replay()
    requeued = master.task_manager.requeue_unacked()
    if requeued:
        logger.info(
            "recovery re-queued %d un-acked shard lease(s)", requeued
        )
    return {
        "entries": len(replayed.entries),
        "applied": applied,
        "requeued": requeued,
        "snapshot": 1 if snap else 0,
        "truncated": 1 if replayed.truncated else 0,
    }
