"""Chaos harness: drive a mini-cluster through a scenario and verify
recovery invariants from the telemetry event log alone.

:func:`run_scenario` launches the same supervision tree production
uses — the launcher (``python -m dlrover_tpu_torch.run``) spawns a
local master subprocess, runs the elastic agent in-process, and the
agent spawns/monitors the toy train loop — with ``DLROVER_CHAOS``
exported so every process of the job arms the scenario, and
``DLROVER_EVENT_LOG`` collecting one JSONL stream from all of them.
Afterwards the :class:`Invariant` checkers read ONLY that event log
(plus a /proc scan for the orphan check): if an invariant cannot be
decided from telemetry, the telemetry is the bug.

Copy of ``dlrover_tpu/chaos/harness.py``, cut to the single-node path
and the invariants its scenarios need:

- :class:`WorkerRestarted` — the fault produced a supervised restart.
- :class:`RendezvousReconverged` — an elastic-training rendezvous
  completed AFTER the fault, within a bound.
- :class:`BoundedStepLoss` — steps lost across the fault ≤ one
  checkpoint interval (from ``train_step`` + ``chaos_inject`` events).
- :class:`TrainingCompleted` / :class:`FinalStepCommitted` — the step
  budget finished and the final checkpoint committed.
- :class:`LossTrajectoryMatches` — every reported loss equals an
  uninterrupted control's, with at least one step replayed.
- :class:`RestoredFromTier` — the first post-fault restore's tier.
- :class:`HangDiagnosed` / :class:`OnlyCulpritRestarted` — the hang
  diagnosis trail.
- :class:`MasterRecovered` / :class:`MasterRecoveredFromMirror` /
  :class:`HealthyWorkersNotRestarted` — the master-recovery trail.
- :class:`NoDuplicateShards` — every sample index of the sharded
  dataset acked exactly once across the fault.
- :class:`GoodputConservation` / :class:`GoodputLossAttributed` — the
  goodput ledger closes and names its losses.
- :class:`DeterministicTimeline` — the ``chaos_inject`` sequence
  matches a reference timeline (cross-run determinism).
- :class:`EventRecorded` — an event type was recorded.
- :class:`NoOrphanProcesses` — nothing spawned for the job outlives
  it (forkserver children included).

Multi-agent runs (slice 4.2): :func:`run_scenario_multinode` drives N
launcher processes against one journal-backed master subprocess, and
:func:`run_elastic_resize_scenario` the world-resize churn (a shared
checkpoint directory on one box stands in for the shared filesystem),
with :class:`WorldSizeTrajectory`, :class:`BoundedStepLossPerRestart`,
:class:`ResizePhasesOnTimeline`, :class:`NodeCompletedSteps`,
:class:`NoRestartForNode` and :class:`InjectionsOnlyOnNode`; the resize
set also holds ``NoDuplicateShards`` over the lead rank's sharded
dataset.  The sparse set: :class:`KvStateRoundTrip`,
:class:`SpillBreakerTripped`, :class:`KvReshardExactlyOnce` and
:class:`KvStreamingReshardReplayed` decide from the ``kv_checkpoint``
digests that rows, frequencies and optimizer slots came through a kill
or a reshard bit for bit, and :func:`seed_sparse_world_checkpoint`
writes the committed world-2 checkpoint the streaming-reshard kill
restores from.  The serving set (slice 9.1):
:class:`ServedGenerationCommitted`, :class:`PublishExactlyOnce`,
:class:`ServingConverged` and :class:`ReplicaReingested` decide from the
``serving_publish``/``serving_ingest`` digests that no torn generation
was served, and :class:`RoutedTrafficClean`,
:class:`ReplicaShedAndReadmitted`,
:class:`FleetHealthyReplicasNotRestarted` and
:class:`RouterReplayMatchesLive` hold the routed fleet of
:func:`run_serving_fleet_scenario`; :func:`run_serving_scenario` runs
the train-to-serve loop beside a supervised replica.  The step-cache
set (slice 8.2): :class:`CompileCacheHitOnRecovery`,
:class:`AotCacheHitOnRecovery`, :class:`RetraceBelow`,
:class:`RecoveryCycleBelow` and :class:`RecoveryPhasesOnTimeline` decide
from the ``compile_cache``/``aot_cache``/``recovery_phase`` events that a
respawn found its step's entry and kernel libraries and recovered within
the reference's ceilings; the ``compile_cache`` run option scopes the
job's compile cache to the run's workdir.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.chaos.scenarios import (
    CHAOS_TRAIN_SCRIPT,
    CKPT_EVERY_ENV,
    DISK_EVERY_ENV,
    RESIZE_TRAIN_SCRIPT,
    RL_TRAIN_SCRIPT,
    RUN_OPTIONS,
    SHARD_DATASET_ENV,
    SPARSE_RESHARD_TRAIN_SCRIPT,
    SPARSE_RESIZE_TRAIN_SCRIPT,
    SPARSE_SERVING_TRAIN_SCRIPT,
    SPARSE_TRAIN_SCRIPT,
    STEP_SLEEP_ENV,
    TOTAL_STEPS_ENV,
    resize_reference_losses,
    rl_reference_losses,
    sparse_reference_losses,
)
from dlrover_tpu_torch.chaos.schedule import load_scenario
from dlrover_tpu_torch.common.env_utils import proc_stat_fields
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import timeline as flight
from dlrover_tpu_torch.telemetry.events import (
    EVENT_LOG_ENV,
    EVENTS_AGGREGATE_ENV,
    collect_events,
)

CHAOS_EVENT = "chaos_inject"

TRAIN_SCRIPTS = {
    "default": CHAOS_TRAIN_SCRIPT,
    "sparse": SPARSE_TRAIN_SCRIPT,
    "resize": RESIZE_TRAIN_SCRIPT,
    "sparse_resize": SPARSE_RESIZE_TRAIN_SCRIPT,
    "sparse_reshard": SPARSE_RESHARD_TRAIN_SCRIPT,
    "sparse_serving": SPARSE_SERVING_TRAIN_SCRIPT,
    "rl": RL_TRAIN_SCRIPT,
}


def seed_sparse_world_checkpoint(
    ckpt_dir: str,
    world: int = 2,
    step: int = 4,
    out_json: str = "",
    n_keys: int = 1200,
    dim: int = 16,
) -> Dict:
    """Write a COMMITTED ``world``-rank sparse checkpoint directly in
    the storage layout (rank_N.ckpt/rank_N.meta + tracker; reference
    ``harness.py:82``) — no shm, no saver — so a world-1 job restoring
    from ``ckpt_dir`` must run the cross-world STREAMING reshard on its
    first load.  Each rank's table holds exactly the keys
    ``owner_of_keys`` assigns it, trained a few GroupAdam steps so
    values/freq/slots are non-trivial.  Returns (and writes to
    ``out_json``) the per-table additive digest sums and the
    distinct-union row count the exactly-once invariant checks
    against."""
    import pickle

    import numpy as np

    from dlrover_tpu_torch.checkpoint.saver import (
        meta_file,
        shard_file,
        step_dirname,
    )
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        CheckpointConfig,
        TensorMeta,
        _flatten_state_dict,
    )
    from dlrover_tpu_torch.checkpoint.sparse import (
        KV_STATE_KEY,
        SparseStateAdapter,
        owner_of_keys,
        rows_digest,
    )
    from dlrover_tpu_torch.common.constants import CheckpointConstant
    from dlrover_tpu_torch.ops.kv_variable import (
        GroupAdamOptimizer,
        KvVariable,
    )

    def _serialize(state_dict, rank: int) -> Tuple[Dict, bytes]:
        """state dict -> (meta, raw) in the exact shm/storage layout the
        engine's restore reads back."""
        flat = _flatten_state_dict(state_dict)
        entries, scalars = [], {}
        for key, leaf in flat.items():
            if isinstance(leaf, (np.ndarray, np.generic)):
                entries.append((key, np.ascontiguousarray(leaf)))
            else:
                scalars[key] = leaf
        blob = pickle.dumps(scalars)
        metas, offset = {}, 0
        for key, arr in entries:
            metas[key] = TensorMeta(
                shape=tuple(arr.shape), dtype=str(arr.dtype),
                offset=offset, nbytes=arr.nbytes,
            )
            offset += arr.nbytes
        raw = bytearray(offset + len(blob))
        for key, arr in entries:
            m = metas[key]
            raw[m.offset:m.offset + m.nbytes] = arr.tobytes()
        raw[offset:] = blob
        meta = {
            "tensors": metas,
            "config": CheckpointConfig(
                step=step, path=ckpt_dir, rank=rank,
                world_size=world, global_shard_num=world,
            ),
            "scalar_offset": offset,
            "scalar_nbytes": len(blob),
        }
        return meta, bytes(raw)

    step_dir = os.path.join(ckpt_dir, step_dirname(step))
    os.makedirs(step_dir, exist_ok=True)
    keys = np.arange(n_keys, dtype=np.int64)
    table_sums: Dict[str, int] = {}
    union_rows = 0
    for rank in range(world):
        table = KvVariable(dim=dim, seed=rank + 21, name="emb")
        opt = GroupAdamOptimizer(table, learning_rate=5e-3)
        adapter = SparseStateAdapter(digest=True)
        adapter.register_optimizer(opt)
        mine = keys[owner_of_keys(keys, world) == rank]
        rng = np.random.default_rng(rank + 3)
        for _ in range(3):
            batch = rng.choice(mine, size=min(256, mine.size),
                               replace=False)
            opt.apply_gradients(
                batch, np.tanh(table.gather(batch)) * 0.1
            )
        kv_state = adapter.export_state(step=step, rank=rank)
        for name, tbl in adapter.tables.items():
            k, v, f = tbl.export()
            table_sums[name] = (
                table_sums.get(name, 0) + rows_digest(k, v, f)
            ) % (1 << 64)
            union_rows += len(k)
        sd = {
            "w": np.zeros(8, np.float32),
            KV_STATE_KEY: kv_state,
        }
        meta, raw = _serialize(sd, rank)
        with open(os.path.join(step_dir, shard_file(rank)), "wb") as f:
            f.write(raw)
        with open(os.path.join(step_dir, meta_file(rank)), "wb") as f:
            f.write(pickle.dumps(meta))
    with open(
        os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE), "w"
    ) as f:
        f.write(str(step))
    seed = {
        "step": int(step),
        "world": int(world),
        "rows": int(union_rows),
        "tables": {n: f"{s:016x}" for n, s in table_sums.items()},
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(seed, f, indent=2)
    return seed


@dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def __bool__(self):
        return self.ok


class Invariant:
    """Base checker: decide pass/fail from the job's event list."""

    name = "invariant"
    # a measured duration held to a wall-clock ceiling: run_scenario
    # re-measures a run once when only such invariants failed
    ceiling_class = False

    def check(self, events: List[dict],
              run: "ChaosRunReport") -> InvariantResult:
        raise NotImplementedError


def _injections(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("type") == CHAOS_EVENT]


def _first_fault_ts(events: List[dict]) -> Optional[float]:
    inj = _injections(events)
    return inj[0]["ts"] if inj else None


class WorkerRestarted(Invariant):
    name = "worker_restarted"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        restarts = [
            e for e in events
            if e.get("type") == "worker_restart"
            and e["ts"] >= fault_ts
        ]
        if not restarts:
            return InvariantResult(
                self.name, False, "no worker_restart after the fault"
            )
        return InvariantResult(
            self.name, True,
            f"{len(restarts)} restart(s) after fault",
        )


class RendezvousReconverged(Invariant):
    """An elastic-training rendezvous completed after the fault, and
    the gap stayed under ``within_s``."""

    name = "rendezvous_reconverged"

    def __init__(self, within_s: float = 120.0):
        self.within_s = within_s

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        rounds = [
            e for e in events
            if e.get("type") == "rendezvous_complete"
            and e.get("rdzv") == "elastic-training"
            and e["ts"] > fault_ts
        ]
        if not rounds:
            return InvariantResult(
                self.name, False,
                "no elastic-training rendezvous completed after the "
                "fault",
            )
        gap = rounds[0]["ts"] - fault_ts
        if gap > self.within_s:
            return InvariantResult(
                self.name, False,
                f"reconverged after {gap:.1f}s > bound {self.within_s}s",
            )
        return InvariantResult(
            self.name, True, f"reconverged in {gap:.1f}s"
        )


class BoundedStepLoss(Invariant):
    """Steps lost across the fault ≤ one checkpoint interval, computed
    from telemetry only: the highest ``train_step`` of the first
    incarnation vs the first ``train_step`` of a respawned one."""

    name = "bounded_step_loss"

    def __init__(self, ckpt_interval: int):
        self.ckpt_interval = ckpt_interval

    def check(self, events, run):
        first = [
            e["step"] for e in events
            if e.get("type") == "train_step"
            and e.get("restart_count", 0) == 0
        ]
        resumed = [
            e["step"] for e in events
            if e.get("type") == "train_step"
            and e.get("restart_count", 0) > 0
        ]
        if not first:
            return InvariantResult(
                self.name, False, "no train_step events at all"
            )
        if not resumed:
            return InvariantResult(
                self.name, False,
                "no post-restart train_step events (recovery never "
                "stepped)",
            )
        last_before = max(first)
        resume_at = min(resumed)
        lost = last_before - (resume_at - 1)
        if lost > self.ckpt_interval:
            return InvariantResult(
                self.name, False,
                f"lost {lost} step(s) (last pre-fault {last_before}, "
                f"resumed at {resume_at}) > interval "
                f"{self.ckpt_interval}",
            )
        if lost < 0:
            return InvariantResult(
                self.name, False,
                f"resumed AHEAD of progress (last pre-fault "
                f"{last_before}, resumed at {resume_at})",
            )
        return InvariantResult(
            self.name, True,
            f"lost {lost} step(s) ≤ interval {self.ckpt_interval} "
            f"(resumed at {resume_at} after {last_before})",
        )


class TrainingCompleted(Invariant):
    """The job stepped through its full budget and committed the final
    checkpoint."""

    name = "training_completed"

    def __init__(self, total_steps: int):
        self.total_steps = total_steps

    def check(self, events, run):
        steps = [
            e["step"] for e in events if e.get("type") == "train_step"
        ]
        commits = [
            e["step"] for e in events
            if e.get("type") == "checkpoint_commit"
        ]
        if not steps or max(steps) < self.total_steps:
            return InvariantResult(
                self.name, False,
                f"highest step {max(steps) if steps else None} < "
                f"budget {self.total_steps}",
            )
        if self.total_steps not in commits:
            return InvariantResult(
                self.name, False,
                f"final step {self.total_steps} never committed "
                f"(commits: {sorted(set(commits))})",
            )
        return InvariantResult(
            self.name, True,
            f"stepped to {max(steps)}, committed {self.total_steps}",
        )



class HangDiagnosed(Invariant):
    """Deep-diagnosis invariant: within ``within_s`` of the injected
    stall, the master reached a *hung* verdict that carries captured
    stack evidence and a measured stall duration, fed by at least one
    agent ``hang_evidence`` capture (stacks present)."""

    name = "hang_diagnosed"

    def __init__(self, within_s: float = 30.0):
        self.within_s = within_s

    def check(self, events, run):
        stalls = [
            e for e in _injections(events)
            if e.get("action") == "stall"
        ]
        if not stalls:
            return InvariantResult(
                self.name, False, "no stall injection recorded"
            )
        t0 = stalls[0]["ts"]
        evidence = [
            e for e in events
            if e.get("type") == "hang_evidence" and e["ts"] >= t0
        ]
        if not evidence:
            return InvariantResult(
                self.name, False,
                "no hang_evidence capture after the stall (agent "
                "watchdog never fired)",
            )
        if not any(e.get("stacks") for e in evidence):
            return InvariantResult(
                self.name, False,
                "hang_evidence carries no stacks",
            )
        verdicts = [
            e for e in events
            if e.get("type") == "diagnosis_verdict"
            and e.get("hung") and e["ts"] >= t0
        ]
        if not verdicts:
            return InvariantResult(
                self.name, False,
                "no hung diagnosis_verdict after the stall",
            )
        v = verdicts[0]
        gap = v["ts"] - t0
        stall_s = v.get("stall_s")
        if not isinstance(stall_s, (int, float)) or stall_s <= 0:
            return InvariantResult(
                self.name, False,
                f"verdict carries no measured stall ({stall_s!r})",
            )
        if not v.get("evidence"):
            return InvariantResult(
                self.name, False,
                "verdict carries no evidence excerpt",
            )
        if gap > self.within_s:
            return InvariantResult(
                self.name, False,
                f"diagnosed after {gap:.1f}s > bound "
                f"{self.within_s}s",
            )
        return InvariantResult(
            self.name, True,
            f"hung verdict in {gap:.1f}s (stall {stall_s:.1f}s, "
            f"{len(evidence)} evidence capture(s))",
        )


class OnlyCulpritRestarted(Invariant):
    """A hang verdict must restart exactly the culprit node: at least
    one restart happened, every restart is on ``culprit_rank``, and
    the job was never aborted for the hang."""

    def __init__(self, culprit_rank: int = 0):
        self.culprit_rank = culprit_rank
        self.name = f"only_culprit_node{culprit_rank}_restarted"

    def check(self, events, run):
        restarts = [
            e for e in events if e.get("type") == "worker_restart"
        ]
        if not restarts:
            return InvariantResult(
                self.name, False,
                "no worker_restart (culprit never relaunched)",
            )
        strays = [
            e for e in restarts
            if e.get("node_rank") != self.culprit_rank
        ]
        if strays:
            return InvariantResult(
                self.name, False,
                f"{len(strays)} restart(s) on non-culprit nodes: "
                f"{sorted({e.get('node_rank') for e in strays})}",
            )
        aborted = [
            e for e in events
            if e.get("type") == "master_exit"
            and e.get("exit_reason") == "hang_error"
        ]
        if aborted:
            return InvariantResult(
                self.name, False,
                "job aborted for the hang instead of a targeted "
                "restart",
            )
        return InvariantResult(
            self.name, True,
            f"{len(restarts)} restart(s), all on culprit node "
            f"{self.culprit_rank}",
        )



class LossTrajectoryMatches(Invariant):
    """Resharded-restore correctness, decided from the event log
    alone: every reported ``train_step`` loss must equal the
    uninterrupted-control trajectory at that step (the resize train
    loop derives its batch from the step index, so the control is a
    pure recomputation), AND at least one step must carry records
    from two distinct incarnations/nodes — the proof that replay /
    cross-node agreement was actually exercised, not vacuously
    skipped.  A restore that resharded the params wrong diverges at
    the first replayed step."""

    name = "loss_trajectory_matches_control"

    def __init__(self, expected: Sequence[float],
                 rtol: float = 1e-3, atol: float = 1e-5):
        self.expected = list(expected)
        self.rtol = rtol
        self.atol = atol

    def check(self, events, run):
        by_step = {}
        for e in events:
            if e.get("type") != "train_step":
                continue
            loss = e.get("loss")
            if not isinstance(loss, (int, float)):
                continue
            step = int(e.get("step", 0))
            by_step.setdefault(step, []).append(
                (e.get("node_rank"), e.get("restart_count"), loss)
            )
        if not by_step:
            return InvariantResult(
                self.name, False, "no train_step events carry a loss"
            )
        mismatches = []
        for step, recs in sorted(by_step.items()):
            if not (1 <= step <= len(self.expected)):
                mismatches.append(f"step {step} outside control")
                continue
            want = self.expected[step - 1]
            for rank, count, loss in recs:
                if abs(loss - want) > self.atol + self.rtol * abs(want):
                    mismatches.append(
                        f"step {step} node{rank} r{count}: "
                        f"{loss:.6g} != control {want:.6g}"
                    )
        if mismatches:
            return InvariantResult(
                self.name, False,
                f"{len(mismatches)} loss divergence(s): "
                f"{mismatches[:5]}",
            )
        multi = [
            step for step, recs in by_step.items()
            if len({(r, c) for r, c, _ in recs}) > 1
        ]
        if not multi:
            return InvariantResult(
                self.name, False,
                "no step was reported by more than one incarnation/"
                "node — the cross-check never ran",
            )
        return InvariantResult(
            self.name, True,
            f"{len(by_step)} step(s) match control "
            f"({len(multi)} with multi-incarnation agreement)",
        )



class WorldSizeTrajectory(Invariant):
    """Elastic-resize invariant: the completed-world size actually
    changed through the expected sequence — e.g. ``[2, 1, 2]`` means
    the elastic-training rendezvous completed at 2 nodes, later at 1,
    later at 2 again (extra rounds between are allowed; the FINAL
    round must match the last expected size)."""

    name = "world_size_trajectory"

    def __init__(self, expected: Sequence[int]):
        self.expected = list(expected)

    def check(self, events, run):
        sizes = [
            len(e.get("nodes") or [])
            for e in events
            if e.get("type") == "rendezvous_complete"
            and e.get("rdzv") == "elastic-training"
        ]
        if not sizes:
            return InvariantResult(
                self.name, False, "no elastic rendezvous rounds"
            )
        want = list(self.expected)
        i = 0
        for size in sizes:
            if i < len(want) and size == want[i]:
                i += 1
        if i < len(want):
            return InvariantResult(
                self.name, False,
                f"round sizes {sizes} do not contain the expected "
                f"trajectory {want} (matched {i}/{len(want)})",
            )
        if sizes[-1] != want[-1]:
            return InvariantResult(
                self.name, False,
                f"final world is {sizes[-1]}, expected {want[-1]} "
                f"(sizes: {sizes})",
            )
        return InvariantResult(
            self.name, True, f"round sizes {sizes} ⊇ {want}"
        )


class BoundedStepLossPerRestart(Invariant):
    """Per-restart step loss: for every ``worker_restart`` on node N
    at incarnation C, the steps lost between incarnation C-1's last
    step and C's first step stay within one durable-checkpoint
    interval, and the new incarnation never resumes AHEAD of recorded
    progress.  A restart that lost more passes only if it resumed
    exactly from the newest durable commit that existed when the new
    incarnation booted (a kill can land past the last commit by more
    than the cadence, and a cross-world restore skips the per-node shm
    tier)."""

    name = "bounded_step_loss_per_restart"

    def __init__(self, interval: int):
        self.interval = interval

    def check(self, events, run):
        steps = {}
        first_ts = {}
        for e in events:
            if e.get("type") != "train_step":
                continue
            key = (e.get("node_rank"), e.get("restart_count", 0))
            steps.setdefault(key, []).append(int(e.get("step", 0)))
            ts = e.get("ts")
            if ts is not None:
                prev = first_ts.get(key)
                if prev is None or ts < prev:
                    first_ts[key] = ts
        commits = sorted(
            (e["ts"], int(e.get("step", 0)))
            for e in events
            if e.get("type") == "checkpoint_commit"
            and e.get("ts") is not None
        )
        checked = 0
        problems = []
        for e in events:
            if e.get("type") != "worker_restart":
                continue
            rank = e.get("node_rank")
            count = e.get("restart_count")
            before = steps.get((rank, count - 1))
            after = steps.get((rank, count))
            if not before or not after:
                continue  # an incarnation never stepped: nothing lost
            lost = max(before) - (min(after) - 1)
            checked += 1
            if lost < 0:
                problems.append(
                    f"node{rank} r{count} resumed AHEAD "
                    f"({min(after)} after {max(before)})"
                )
            elif lost > self.interval:
                boot_ts = first_ts.get((rank, count))
                best = max(
                    (step for ts, step in commits
                     if boot_ts is None or ts <= boot_ts),
                    default=None,
                )
                if best is not None and min(after) - 1 == best:
                    continue  # resumed from the newest durable commit
                problems.append(
                    f"node{rank} r{count} lost {lost} step(s) > "
                    f"interval {self.interval} and did not resume "
                    f"from the newest commit "
                    f"({best if best is not None else 'none seen'})"
                )
        if problems:
            return InvariantResult(self.name, False, "; ".join(problems))
        if not checked:
            return InvariantResult(
                self.name, False,
                "no restart had steps on both sides to compare",
            )
        return InvariantResult(
            self.name, True,
            f"{checked} restart(s) within interval {self.interval}",
        )


class ResizePhasesOnTimeline(Invariant):
    """The assembled flight-recorder timeline carries the
    ``dlrover_resize_seconds`` phase breakdown: per resize decision a
    ``decide``/``rendezvous``/``first_step`` trail (``drain`` and
    ``reshard_restore`` where the events exist), rendered as
    ``resize``-cause slices."""

    name = "resize_phases_on_timeline"

    def __init__(self, min_resizes: int = 1):
        self.min_resizes = min_resizes

    def check(self, events, run):
        tl = run.job_timeline
        if tl is None:
            tl = flight.assemble(events)
        slices = tl.slices_by_cat(flight.CAUSE_RESIZE)
        if not slices:
            return InvariantResult(
                self.name, False, "no resize slices on the timeline"
            )
        phases = {}
        for s in slices:
            phases.setdefault(s.meta.get("phase"), []).append(
                round(s.duration, 3)
            )
        completed = len(phases.get("rendezvous", []))
        if completed < self.min_resizes:
            return InvariantResult(
                self.name, False,
                f"only {completed} resize(s) reached a completed "
                f"rendezvous phase (need {self.min_resizes}); "
                f"phases: {phases}",
            )
        missing = {"decide", "rendezvous", "first_step"} - set(phases)
        if missing:
            return InvariantResult(
                self.name, False,
                f"phase(s) {sorted(missing)} absent from the "
                f"timeline (have {sorted(phases)})",
            )
        if "reshard_restore" not in phases:
            return InvariantResult(
                self.name, False,
                f"no reshard_restore phase on any resize — the "
                f"re-formed world never restored (phases: {phases})",
            )
        return InvariantResult(
            self.name, True,
            f"{completed} completed resize(s); phase durations "
            f"{ {k: v for k, v in sorted(phases.items())} }",
        )


class NodeCompletedSteps(Invariant):
    """Per-node progress in a multi-agent run: node ``rank`` stepped
    through at least ``total_steps`` (train_step events carry
    node_rank)."""

    def __init__(self, rank: int, total_steps: int):
        self.rank = rank
        self.total_steps = total_steps
        self.name = f"node{rank}_completed"

    def check(self, events, run):
        steps = [
            e["step"] for e in events
            if e.get("type") == "train_step"
            and e.get("node_rank") == self.rank
        ]
        top = max(steps) if steps else None
        if top is None or top < self.total_steps:
            return InvariantResult(
                self.name, False,
                f"node {self.rank} reached step {top} < budget "
                f"{self.total_steps}",
            )
        return InvariantResult(
            self.name, True, f"node {self.rank} reached step {top}",
        )


class NoRestartForNode(Invariant):
    """An un-faulted node must never be restarted by someone else's
    fault."""

    def __init__(self, rank: int):
        self.rank = rank
        self.name = f"node{rank}_not_restarted"

    def check(self, events, run):
        restarts = [
            e for e in events
            if e.get("type") == "worker_restart"
            and e.get("node_rank") == self.rank
        ]
        if restarts:
            return InvariantResult(
                self.name, False,
                f"node {self.rank} restarted {len(restarts)} "
                "time(s) though it was never faulted",
            )
        return InvariantResult(
            self.name, True, f"node {self.rank} never restarted"
        )


class InjectionsOnlyOnNode(Invariant):
    """The fault stayed confined to its target: every injection's
    node_rank equals ``rank`` (subset-partition scenarios)."""

    def __init__(self, rank: int, action: str = ""):
        self.rank = rank
        self.action = action
        self.name = f"injections_only_on_node{rank}"

    def check(self, events, run):
        inj = _injections(events)
        if self.action:
            inj = [e for e in inj if e.get("action") == self.action]
        if not inj:
            return InvariantResult(
                self.name, False, "no matching injections recorded"
            )
        strays = [e for e in inj if e.get("node_rank") != self.rank]
        if strays:
            return InvariantResult(
                self.name, False,
                f"{len(strays)} injection(s) fired on other nodes: "
                f"{[e.get('node_rank') for e in strays]}",
            )
        return InvariantResult(
            self.name, True,
            f"{len(inj)} injection(s), all on node {self.rank}",
        )


class DeterministicTimeline(Invariant):
    """The run's fault timeline equals a reference timeline (usually a
    prior run of the same scenario+seed)."""

    name = "deterministic_timeline"

    def __init__(self, reference: Sequence[Tuple]):
        self.reference = [tuple(r) for r in reference]

    def check(self, events, run):
        timeline = timeline_from_events(events)
        if timeline != self.reference:
            return InvariantResult(
                self.name, False,
                f"timeline {timeline} != reference {self.reference}",
            )
        return InvariantResult(
            self.name, True, f"{len(timeline)} injection(s) identical"
        )


class RestoredFromTier(Invariant):
    """The first post-fault restore came from the expected tier —
    e.g. a torn/corrupted shm snapshot must be refused and recovery
    must fall back to the storage tier.  Decided entirely from the
    ``checkpoint_restore`` event's ``tier`` field (shm / storage /
    orbax), which the engine stamps on every successful restore."""

    name = "restored_from_tier"

    def __init__(self, tier: str):
        self.tier = tier

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        restores = [
            e for e in events
            if e.get("type") == "checkpoint_restore"
            and e["ts"] >= fault_ts
        ]
        if not restores:
            return InvariantResult(
                self.name, False,
                "no checkpoint_restore event after the fault",
            )
        tiers = [e.get("tier") for e in restores]
        if tiers[0] != self.tier:
            return InvariantResult(
                self.name, False,
                f"first post-fault restore came from tier "
                f"{tiers[0]!r}, expected {self.tier!r} "
                f"(all: {tiers})",
            )
        return InvariantResult(
            self.name, True,
            f"restored from {self.tier!r} tier (step "
            f"{restores[0].get('step')})",
        )



class EventRecorded(Invariant):
    """At least ``min_count`` events of ``event_type`` exist (e.g. a
    ``warm_fork_fallback`` proving the cold-spawn path ran)."""

    def __init__(self, event_type: str, min_count: int = 1):
        self.event_type = event_type
        self.min_count = min_count
        self.name = f"event_recorded[{event_type}]"

    def check(self, events, run):
        hits = [e for e in events if e.get("type") == self.event_type]
        if len(hits) < self.min_count:
            return InvariantResult(
                self.name, False,
                f"{len(hits)} {self.event_type!r} event(s) < "
                f"required {self.min_count}",
            )
        return InvariantResult(
            self.name, True, f"{len(hits)} event(s)"
        )



class CompileCacheHitOnRecovery(Invariant):
    """The replacement incarnation's first post-restore step HIT the
    job's compile cache — decided from the ``compile_cache`` event the
    trainer-side retrace monitor emits (kernel libraries before/after
    the bracketed first step; ``aot-hit`` or ``kernel-cache-hit``)."""

    name = "compile_cache_hit"

    def check(self, events, run):
        witnesses = [
            e for e in events
            if e.get("type") == "compile_cache"
            and int(e.get("restart_count", 0) or 0) > 0
        ]
        if not witnesses:
            return InvariantResult(
                self.name, False,
                "no compile_cache event from a respawned incarnation "
                "(retrace monitor never ran)",
            )
        misses = [e for e in witnesses if not e.get("hit")]
        if misses:
            e = misses[0]
            return InvariantResult(
                self.name, False,
                f"cache MISS on restart "
                f"#{e.get('restart_count')}: entries "
                f"{e.get('entries_before')}->{e.get('entries_after')} "
                f"in {e.get('dir')}",
            )
        e = witnesses[0]
        return InvariantResult(
            self.name, True,
            f"cache HIT on restart #{e.get('restart_count')} "
            f"({e.get('entries_before')} warm entries, retrace "
            f"{e.get('retrace_s')}s)",
        )


class RetraceBelow(Invariant):
    """Measured ``retrace + aot`` of every respawned incarnation
    stays under the ceiling — re-establishing a runnable step (the
    entry's library loads and the first eager call on an AOT hit, a
    build or a load inside the first call otherwise) must translate
    into TIME, not just a filesystem witness."""

    ceiling_class = True

    def __init__(self, ceiling_s: float):
        self.ceiling_s = ceiling_s
        self.name = f"retrace_below[{ceiling_s:g}s]"

    def check(self, events, run):
        # keyed by (node_rank, restart_count) — in a multi-node run
        # one rank's fast recovery must not mask another's violation
        budgets = flight.recovery_budgets(events)
        totals = [
            (key, phases.get("retrace", 0.0) + phases.get("aot", 0.0))
            for key, phases in budgets.items()
            if key[1] > 0 and "retrace" in phases
        ]
        if not totals:
            return InvariantResult(
                self.name, False,
                "no retrace recovery_phase event from a respawned "
                "incarnation",
            )
        worst = max(totals, key=lambda x: x[1])
        if worst[1] > self.ceiling_s:
            return InvariantResult(
                self.name, False,
                f"retrace+aot {worst[1]:.3f}s on node{worst[0][0]} "
                f"restart #{worst[0][1]} > ceiling {self.ceiling_s}s",
            )
        return InvariantResult(
            self.name, True,
            f"worst retrace+aot {worst[1]:.3f}s ≤ {self.ceiling_s}s "
            f"across {len(totals)} recovery(ies)",
        )


class AotCacheHitOnRecovery(Invariant):
    """The replacement incarnation's step resolved through an AOT
    cache entry (the first incarnation's miss wrote it, and its kernel
    libraries were loaded before the first call) — decided from the
    ``aot_cache`` events."""

    name = "aot_cache_hit"

    def check(self, events, run):
        witnesses = [
            e for e in events
            if e.get("type") == "aot_cache"
            and int(e.get("restart_count", 0) or 0) > 0
        ]
        if not witnesses:
            return InvariantResult(
                self.name, False,
                "no aot_cache event from a respawned incarnation "
                "(the resolve never ran)",
            )
        misses = [e for e in witnesses if not e.get("hit")]
        if misses:
            e = misses[0]
            return InvariantResult(
                self.name, False,
                f"AOT miss on restart #{e.get('restart_count')}: "
                f"resolution={e.get('resolution')} "
                f"reason={e.get('reason', '')!r}",
            )
        e = witnesses[0]
        return InvariantResult(
            self.name, True,
            f"AOT hit on restart #{e.get('restart_count')} "
            f"(load {e.get('load_s')}s, critical-path wait "
            f"{e.get('wait_s', e.get('load_s'))}s)",
        )


class RecoveryCycleBelow(Invariant):
    """The whole measured death→first-step budget of every respawned
    incarnation stays under the ceiling — the sub-second-recovery
    acceptance, decided from the summed ``recovery_phase`` events
    (the same numbers the timeline's budget section prints)."""

    ceiling_class = True

    def __init__(self, ceiling_s: float):
        self.ceiling_s = ceiling_s
        self.name = f"recovery_cycle_below[{ceiling_s:g}s]"

    def check(self, events, run):
        budgets = flight.recovery_budgets(events)
        cycles = [
            (count, sum(
                v for k, v in phases.items()
                if k in flight.RECOVERY_PHASES
            ))
            for (_rank, count), phases in budgets.items()
            if count > 0 and "first_step" in phases
        ]
        if not cycles:
            return InvariantResult(
                self.name, False,
                "no complete recovery budget from a respawned "
                "incarnation",
            )
        worst = max(cycles, key=lambda x: x[1])
        if worst[1] > self.ceiling_s:
            return InvariantResult(
                self.name, False,
                f"death->first-step {worst[1]:.3f}s on restart "
                f"#{worst[0]} > ceiling {self.ceiling_s}s",
            )
        return InvariantResult(
            self.name, True,
            f"worst cycle {worst[1]:.3f}s ≤ {self.ceiling_s}s "
            f"across {len(cycles)} recovery(ies)",
        )


class RecoveryPhasesOnTimeline(Invariant):
    """The assembled flight-recorder timeline carries the recovery
    breakdown slices (spawn/import/restore/retrace/first_step) for a
    respawned incarnation — the budget is not just measured, it is
    visible where operators look."""

    name = "recovery_phases_on_timeline"

    REQUIRED = ("restore", "retrace", "first_step")

    def check(self, events, run):
        if run.job_timeline is None:
            return InvariantResult(
                self.name, False, "no assembled job timeline"
            )
        phases = {
            s.meta.get("phase")
            for s in run.job_timeline.slices
            if s.cat == flight.CAT_RECOVERY_PHASE
            and int(s.meta.get("restart_count", 0) or 0) > 0
        }
        missing = [p for p in self.REQUIRED if p not in phases]
        if missing:
            return InvariantResult(
                self.name, False,
                f"recovery slices missing phase(s) {missing} "
                f"(present: {sorted(p for p in phases if p)})",
            )
        return InvariantResult(
            self.name, True,
            f"phases on timeline: {sorted(p for p in phases if p)}",
        )


class MasterRecoveredFromMirror(Invariant):
    """The respawned master's recovery was seeded from the
    storage-tier journal mirror (``master_recovered.from_mirror``) —
    the witness that a FRESH local journal dir (a different host)
    still recovers the job."""

    name = "master_recovered_from_mirror"

    def check(self, events, run):
        recovered = [
            e for e in events if e.get("type") == "master_recovered"
        ]
        if not recovered:
            return InvariantResult(
                self.name, False, "no master_recovered event"
            )
        from_mirror = [e for e in recovered if e.get("from_mirror")]
        if not from_mirror:
            return InvariantResult(
                self.name, False,
                f"{len(recovered)} recovery(ies), none seeded from "
                "the mirror (the fresh-journal respawn found local "
                "state?)",
            )
        e = from_mirror[0]
        return InvariantResult(
            self.name, True,
            f"recovery #{e.get('recoveries')} seeded from the "
            f"mirror: {e.get('entries')} entries replayed",
        )


class MasterRecovered(Invariant):
    """A respawned master replayed the journal after the fault
    (``master_recovered``) AND at least one client replayed the
    session-resync handshake against it (``master_resync`` or
    ``agent_resync``)."""

    name = "master_recovered"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        recovered = [
            e for e in events
            if e.get("type") == "master_recovered"
            and e["ts"] >= fault_ts
        ]
        if not recovered:
            return InvariantResult(
                self.name, False,
                "no master_recovered event after the fault (journal "
                "replay never ran)",
            )
        resyncs = [
            e for e in events
            if e.get("type") in ("master_resync", "agent_resync")
            and e["ts"] >= fault_ts
        ]
        if not resyncs:
            return InvariantResult(
                self.name, False,
                "master recovered but no client session-resync "
                "handshake followed",
            )
        rec = recovered[0]
        return InvariantResult(
            self.name, True,
            f"recovery #{rec.get('recoveries')} replayed "
            f"{rec.get('entries')} entries (re-queued "
            f"{rec.get('requeued')} lease(s)); "
            f"{len(resyncs)} client resync(s)",
        )


class HealthyWorkersNotRestarted(Invariant):
    """A master crash must NOT cascade into worker restarts: healthy
    trainers ride out the outage on the parked RPC path."""

    name = "healthy_workers_not_restarted"

    def check(self, events, run):
        restarts = [
            e for e in events if e.get("type") == "worker_restart"
        ]
        if restarts:
            return InvariantResult(
                self.name, False,
                f"{len(restarts)} worker restart(s): a master crash "
                "cascaded into the data plane",
            )
        return InvariantResult(self.name, True, "no worker restarts")


class NoDuplicateShards(Invariant):
    """Dataset-shard exactly-once accounting across the fault, from
    ``shard_ack`` events alone: every sample index acked exactly once
    (none lost, none completed twice)."""

    name = "no_duplicate_shards"

    def __init__(self, dataset_size: int, dataset: str = "chaos-ds"):
        self.dataset_size = dataset_size
        self.dataset = dataset

    def check(self, events, run):
        acks = [
            e for e in events
            if e.get("type") == "shard_ack"
            and e.get("dataset") == self.dataset
            and e.get("success")
        ]
        if not acks:
            return InvariantResult(
                self.name, False, "no successful shard_ack events"
            )
        ranges = [(e.get("start"), e.get("end")) for e in acks]
        dupes = {r for r in ranges if ranges.count(r) > 1}
        if dupes:
            return InvariantResult(
                self.name, False,
                f"shard range(s) acked more than once: "
                f"{sorted(dupes)}",
            )
        covered = set()
        for start, end in ranges:
            covered.update(range(int(start), int(end)))
        missing = set(range(self.dataset_size)) - covered
        if missing:
            return InvariantResult(
                self.name, False,
                f"{len(missing)} sample(s) never acked (lost "
                f"shards): {sorted(missing)[:10]}",
            )
        return InvariantResult(
            self.name, True,
            f"{len(acks)} shard(s) acked exactly once, full "
            f"coverage of {self.dataset_size} samples",
        )


class FinalStepCommitted(Invariant):
    """The job's last reached step ended up durably committed (the
    shard-driven loops derive their budget from the dataset, so the
    bound is 'whatever the trainer actually reached')."""

    name = "final_step_committed"

    def check(self, events, run):
        steps = [
            e["step"] for e in events if e.get("type") == "train_step"
        ]
        commits = [
            e.get("step") for e in events
            if e.get("type") == "checkpoint_commit"
        ]
        if not steps:
            return InvariantResult(
                self.name, False, "no train_step events"
            )
        final = max(steps)
        if final not in commits:
            return InvariantResult(
                self.name, False,
                f"final step {final} never committed "
                f"(commits: {sorted(set(commits))})",
            )
        return InvariantResult(
            self.name, True, f"final step {final} committed"
        )



class GoodputLossAttributed(Invariant):
    """Flight-recorder invariant: the assembled timeline's
    goodput-loss diagnosis must attribute at least
    ``min_attributed_frac`` of the measured non-training wall-clock
    to NAMED causes (rendezvous / restore / master recovery /
    straggler) — an unattributed majority means the telemetry lost
    the causal trail.  Reads the ready-made ``run.attribution``
    instead of re-parsing raw events; runs with no measurable loss
    pass vacuously."""

    name = "goodput_loss_attributed"

    def __init__(self, min_attributed_frac: float = 0.5,
                 expect_cause: str = ""):
        self.min_attributed_frac = min_attributed_frac
        self.expect_cause = expect_cause

    def check(self, events, run):
        attr = run.attribution
        if attr is None:
            tl = flight.assemble(events)
            attr = flight.attribute_goodput_loss(tl)
        loss = attr["loss_s"]
        if loss <= 0:
            return InvariantResult(
                self.name, True, "no non-training time to attribute"
            )
        named = sum(
            v for k, v in attr["buckets"].items()
            if k != flight.CAUSE_UNATTRIBUTED
        )
        frac = named / loss
        if self.expect_cause and (
            attr["buckets"].get(self.expect_cause, 0.0) <= 0
        ):
            return InvariantResult(
                self.name, False,
                f"expected cause {self.expect_cause!r} got 0s "
                f"(buckets: {attr['buckets']})",
            )
        if frac < self.min_attributed_frac:
            return InvariantResult(
                self.name, False,
                f"only {frac:.0%} of {loss:.3f}s lost attributed "
                f"(buckets: {attr['buckets']})",
            )
        return InvariantResult(
            self.name, True,
            f"{frac:.0%} of {loss:.3f}s lost attributed "
            f"({ {k: round(v, 3) for k, v in attr['buckets'].items()} })",
        )


class GoodputConservation(Invariant):
    """Goodput-ledger invariant: the per-incarnation wall-clock
    partition must CLOSE — every incarnation's attributed categories
    sum to its measured wall clock within ``eps`` (default 2%).  An
    attribution the ledger cannot explain is a bug, not a rounding
    error.  With ``named_floor`` > 0 the scenario additionally proves
    causality: at least that fraction of total non-productive time
    must land in NAMED categories (not ``idle_unattributed``) — the
    worker-kill scenarios assert 90%, i.e. the death-witness ->
    rendezvous -> restore -> first-step chain was actually observed.
    Runs whose ledger has no incarnations (no step/restart telemetry
    at all) pass vacuously; the floor is only enforced once there is
    ``min_loss_s`` of non-productive time to explain."""

    name = "goodput_conservation"

    def __init__(self, eps: float = 0.02,
                 named_floor: float = 0.0,
                 min_loss_s: float = 1.0):
        self.eps = eps
        self.named_floor = named_floor
        self.min_loss_s = min_loss_s

    def check(self, events, run):
        from dlrover_tpu_torch.telemetry import goodput as _goodput

        ledger = _goodput.build_ledger(events)
        if not ledger.incarnations:
            return InvariantResult(
                self.name, True, "no incarnations in ledger"
            )
        errors = ledger.conservation_errors(self.eps)
        if errors:
            return InvariantResult(
                self.name, False,
                "conservation violated: " + "; ".join(errors),
            )
        loss = ledger.loss_totals()
        nonprod = sum(loss.values())
        detail = (
            f"{len(ledger.incarnations)} incarnation(s) close "
            f"within {self.eps:.0%}"
        )
        if self.named_floor > 0 and nonprod >= self.min_loss_s:
            named = nonprod - loss.get(_goodput.IDLE, 0.0)
            frac = named / nonprod
            if frac < self.named_floor:
                return InvariantResult(
                    self.name, False,
                    f"only {frac:.0%} of {nonprod:.3f}s "
                    f"non-productive time named (< "
                    f"{self.named_floor:.0%}; totals: "
                    f"{ {k: round(v, 3) for k, v in loss.items() if v > 0} })",
                )
            detail += (
                f"; {frac:.0%} of {nonprod:.3f}s non-productive "
                f"time named"
            )
        return InvariantResult(self.name, True, detail)



def _kv_events(events: List[dict], stage: str) -> List[dict]:
    return [
        e for e in events
        if e.get("type") == "kv_checkpoint" and e.get("stage") == stage
    ]


class KvStateRoundTrip(Invariant):
    """Sparse state is bit-identical through the kill/restore cycle,
    decided from telemetry alone: the first post-fault kv restore's
    per-table content digests (keys + values + frequency counters +
    optimizer slot tables) equal the digests the matching export
    stamped before the fault.  Requires ``DLROVER_KV_DIGEST`` armed in
    the run."""

    name = "kv_state_round_trip"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        restores = [
            e for e in _kv_events(events, "restore")
            if e["ts"] >= fault_ts
        ]
        if not restores:
            return InvariantResult(
                self.name, False, "no kv restore after the fault"
            )
        restore = restores[0]
        digests = restore.get("digests")
        if not digests:
            return InvariantResult(
                self.name, False,
                "kv restore carries no digests "
                "(DLROVER_KV_DIGEST not armed?)",
            )
        step = restore.get("step")
        exports = [
            e for e in _kv_events(events, "export")
            if e.get("step") == step and e.get("digests")
            and e["ts"] <= restore["ts"]
        ]
        if not exports:
            return InvariantResult(
                self.name, False,
                f"no digested kv export at restored step {step}",
            )
        expected = exports[-1]["digests"]
        if expected != digests:
            diff = sorted(
                t for t in set(expected) | set(digests)
                if expected.get(t) != digests.get(t)
            )
            return InvariantResult(
                self.name, False,
                f"digest mismatch at step {step} for table(s) {diff}: "
                f"exported {expected} != restored {digests}",
            )
        rows = sum(int(d.get("rows", 0)) for d in digests.values())
        return InvariantResult(
            self.name, True,
            f"{len(digests)} table(s), {rows} row(s) bit-identical "
            f"through the cycle at step {step}",
        )


class SpillBreakerTripped(Invariant):
    """The injected spill-tier fault tripped the production
    write-failure breaker (not just the export skip): some post-fault kv
    export event carries ``spill_disabled``, the stat the tables write
    through to telemetry when the cold tier is taken offline."""

    name = "spill_breaker_tripped"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        hits = [
            e for e in _kv_events(events, "export")
            if e["ts"] >= fault_ts and e.get("spill_disabled")
        ]
        if not hits:
            return InvariantResult(
                self.name, False,
                "no post-fault kv export reports spill_disabled — "
                "the breaker never tripped",
            )
        lost = max(int(e.get("lost_rows", 0)) for e in hits)
        return InvariantResult(
            self.name, True,
            f"breaker tripped ({len(hits)} export(s) with the cold "
            f"tier offline, up to {lost} stranded row(s) skipped)",
        )


class KvReshardExactlyOnce(Invariant):
    """Cross-world sparse restores redistribute the hash table EXACTLY
    ONCE, decided from events alone.  For every resharded restore
    generation (grouped by restored step + new world size):

    - the per-rank imported row counts sum to the distinct union of the
      old world's rows (``total_rows``, which every participant must
      agree on) — no row lost, none imported twice;
    - per table, the restore digests (additive across disjoint shards)
      sum — mod 2**64 — to the sum of the old ranks' export digests at
      that step: the redistributed CONTENT is the old content, bit for
      bit.
    """

    name = "kv_reshard_exactly_once"

    def __init__(self, min_reshards: int = 2):
        self.min_reshards = min_reshards

    @staticmethod
    def _sum64(hexes: List[str]) -> int:
        total = 0
        for h in hexes:
            total = (total + int(h, 16)) % (1 << 64)
        return total

    def check(self, events, run):
        groups: Dict[tuple, Dict[int, dict]] = {}
        for e in _kv_events(events, "restore"):
            if not e.get("resharded"):
                continue
            key = (e.get("step"), e.get("world_size"))
            # one record per (group, rank): retries keep the last
            groups.setdefault(key, {})[e.get("rank")] = e
        if len(groups) < self.min_reshards:
            return InvariantResult(
                self.name, False,
                f"only {len(groups)} resharded restore generation(s) "
                f"(need {self.min_reshards}): {sorted(groups)}",
            )
        # last digested export per (step, rank)
        exports: Dict[tuple, dict] = {}
        for e in _kv_events(events, "export"):
            if e.get("digests") and e.get("step") is not None:
                exports[(e["step"], e.get("rank", 0))] = e
        problems = []
        detail = []
        for (step, world), by_rank in sorted(groups.items()):
            recs = list(by_rank.values())
            totals = {int(r.get("total_rows", -1)) for r in recs}
            if len(totals) != 1:
                problems.append(
                    f"step {step}->world {world}: ranks disagree on "
                    f"total_rows {sorted(totals)}"
                )
                continue
            total_rows = totals.pop()
            got_rows = sum(int(r.get("rows", 0)) for r in recs)
            if got_rows != total_rows:
                problems.append(
                    f"step {step}->world {world}: imported "
                    f"{got_rows} != union {total_rows} row(s)"
                )
                continue
            src = [
                exp for (s, _r), exp in exports.items() if s == step
            ]
            if not src:
                problems.append(
                    f"step {step}: no digested source exports"
                )
                continue
            tables = set()
            for r in recs:
                tables |= set(r.get("digests") or {})
            bad_tables = []
            for table in sorted(tables):
                want = self._sum64([
                    exp["digests"][table]["sum"]
                    for exp in src if table in exp["digests"]
                ])
                got = self._sum64([
                    r["digests"][table]["sum"]
                    for r in recs if table in (r.get("digests") or {})
                ])
                if want != got:
                    bad_tables.append(table)
            if bad_tables:
                problems.append(
                    f"step {step}->world {world}: digest sums "
                    f"diverge for table(s) {bad_tables}"
                )
                continue
            detail.append(
                f"step {step}->world {world}: {total_rows} row(s) "
                f"across {len(recs)} rank(s)"
            )
        if problems:
            return InvariantResult(
                self.name, False, "; ".join(problems)
            )
        return InvariantResult(
            self.name, True,
            f"{len(detail)} exactly-once reshard(s): "
            + "; ".join(detail),
        )


class KvStreamingReshardReplayed(Invariant):
    """A worker SIGKILLed mid-streaming-reshard is replaced by one that
    replays the reshard from the SAME committed storage with
    exactly-once rows, decided from events + the seeder's JSON:

    - the fault fired on a ``kv.reshard_chunk`` hook (the kill landed
      mid-stream, after at least one chunk imported);
    - a post-fault ``kv_checkpoint`` restore with ``streamed`` ran in
      MORE than one chunk and imported rows == total_rows == the
      seeder's distinct union (no row lost, no chunk double-imported);
    - its per-table digests equal the seeder's per-shard export sums
      (additive across the disjoint world-2 shards)."""

    name = "kv_streaming_reshard_replayed"

    def __init__(self, seed_json_path: str):
        self.seed_json_path = seed_json_path

    def check(self, events, run):
        try:
            with open(self.seed_json_path) as f:
                seed = json.load(f)
        except (OSError, ValueError) as e:
            return InvariantResult(
                self.name, False, f"seed JSON unreadable: {e}"
            )
        inj = [
            e for e in _injections(events)
            if e.get("point") == "kv.reshard_chunk"
        ]
        if not inj:
            return InvariantResult(
                self.name, False,
                "no chaos_inject on kv.reshard_chunk — the kill "
                "never landed mid-reshard",
            )
        fault_ts = inj[0]["ts"]
        restores = [
            e for e in _kv_events(events, "restore")
            if e.get("resharded") and e.get("streamed")
            and e["ts"] >= fault_ts
        ]
        if not restores:
            return InvariantResult(
                self.name, False,
                "no streamed resharded kv restore after the fault",
            )
        r = restores[-1]
        if int(r.get("chunks", 0)) <= 1:
            return InvariantResult(
                self.name, False,
                f"reshard ran in {r.get('chunks')} chunk(s) — not "
                "actually streamed (window too large?)",
            )
        rows, total = int(r.get("rows", -1)), int(
            r.get("total_rows", -2)
        )
        if not (rows == total == int(seed["rows"])):
            return InvariantResult(
                self.name, False,
                f"imported {rows} row(s) vs union {total} vs seeded "
                f"{seed['rows']} — rows lost or double-imported",
            )
        if not seed.get("tables"):
            return InvariantResult(
                self.name, False, "seed JSON names no tables"
            )
        digests = r.get("digests") or {}
        bad = []
        for table, want in seed["tables"].items():
            got = (digests.get(table) or {}).get("sum")
            if got != want:
                bad.append(f"{table}: {got} != seeded {want}")
        if bad:
            return InvariantResult(
                self.name, False,
                "digest mismatch vs seeded shards: " + "; ".join(bad),
            )
        return InvariantResult(
            self.name, True,
            f"replayed reshard imported {rows}/{total} row(s) in "
            f"{r.get('chunks')} chunk(s), {len(digests)} table "
            f"digest(s) equal the seeded sums (kill at chunk "
            f"{inj[0].get('step')} of incarnation 0)",
        )


def _serving_events(events: List[dict], etype: str) -> List[dict]:
    return [e for e in events if e.get("type") == etype]


class ServedGenerationCommitted(Invariant):
    """The replica never served a torn or uncommitted generation,
    decided from events alone: every ``serving_ingest`` generation
    has EXACTLY ONE matching committed ``serving_publish``, and the
    per-table content digests the replica verified over what it
    ACTUALLY applied equal the ones the publisher stamped at commit.
    (The ingest event is emitted only after the full apply under the
    swap lock, so a half-applied generation — e.g. a replica killed
    mid-ingest — can never produce one.)"""

    name = "served_generation_committed"

    def check(self, events, run):
        publishes = {}
        for e in _serving_events(events, "serving_publish"):
            publishes.setdefault(e.get("generation"), []).append(e)
        ingests = _serving_events(events, "serving_ingest")
        if not ingests:
            return InvariantResult(
                self.name, False, "no serving_ingest events recorded"
            )
        problems = []
        for e in ingests:
            gen = e.get("generation")
            pubs = publishes.get(gen)
            if not pubs:
                problems.append(
                    f"gen {gen} ingested but never published"
                )
                continue
            want = pubs[-1].get("tables") or {}
            got = e.get("tables") or {}
            if want != got:
                problems.append(
                    f"gen {gen} digest mismatch: published {want} != "
                    f"ingested {got}"
                )
        if problems:
            return InvariantResult(
                self.name, False, "; ".join(problems[:4])
            )
        gens = sorted({e.get("generation") for e in ingests})
        return InvariantResult(
            self.name, True,
            f"{len(ingests)} ingest(s) over generation(s) "
            f"{gens[0]}..{gens[-1]}, every digest matches its commit",
        )


class PublishExactlyOnce(Invariant):
    """Every committed generation was published exactly once
    (``serving_publish`` is emitted after the tracker advance): no
    generation number repeats, and the sequence is monotonic — the
    trainer killed mid-publish left its half-written generation
    uncommitted and its replacement moved on to a fresh number."""

    name = "publish_exactly_once"

    def check(self, events, run):
        pubs = _serving_events(events, "serving_publish")
        if not pubs:
            return InvariantResult(
                self.name, False, "no serving_publish events recorded"
            )
        gens = [e.get("generation") for e in pubs]
        dupes = sorted({g for g in gens if gens.count(g) > 1})
        if dupes:
            return InvariantResult(
                self.name, False,
                f"generation(s) {dupes} published more than once",
            )
        if gens != sorted(gens):
            return InvariantResult(
                self.name, False,
                f"publish sequence not monotonic: {gens}",
            )
        bases = sum(1 for e in pubs if e.get("kind") == "base")
        return InvariantResult(
            self.name, True,
            f"{len(gens)} generation(s) ({bases} base), each "
            "committed exactly once",
        )


class ServingConverged(Invariant):
    """The replica caught up: the LAST committed generation (highest
    ``serving_publish``) was ingested — freshness converges to zero
    lag after the chaos settles."""

    name = "serving_converged"

    def check(self, events, run):
        pubs = _serving_events(events, "serving_publish")
        ingests = _serving_events(events, "serving_ingest")
        if not pubs or not ingests:
            return InvariantResult(
                self.name, False,
                f"{len(pubs)} publish / {len(ingests)} ingest "
                "event(s)",
            )
        last_pub = max(e.get("generation") for e in pubs)
        got = {e.get("generation") for e in ingests}
        if last_pub not in got:
            return InvariantResult(
                self.name, False,
                f"final committed generation {last_pub} never "
                f"ingested (replica reached {max(got)})",
            )
        fresh = [
            e.get("freshness_s") for e in ingests
            if e.get("generation") == last_pub
            and isinstance(e.get("freshness_s"), (int, float))
        ]
        tail = f" (freshness {fresh[-1]:.3f}s)" if fresh else ""
        return InvariantResult(
            self.name, True,
            f"replica converged on generation {last_pub}{tail}",
        )


class ReplicaReingested(Invariant):
    """After the fault, a RESPAWNED replica re-ingested from
    committed state: some post-fault ``serving_ingest`` carries
    ``respawned`` and the respawn's first ingest is a BASE (a fresh
    replica cannot apply a delta onto nothing — re-basing is the
    recovery path under test)."""

    name = "replica_reingested"

    def check(self, events, run):
        fault_ts = _first_fault_ts(events)
        if fault_ts is None:
            return InvariantResult(
                self.name, False, "no chaos_inject event recorded"
            )
        post = [
            e for e in _serving_events(events, "serving_ingest")
            if e.get("respawned") and e["ts"] >= fault_ts
        ]
        if not post:
            return InvariantResult(
                self.name, False,
                "no post-fault ingest from a respawned replica",
            )
        first = post[0]
        if first.get("kind") != "base":
            return InvariantResult(
                self.name, False,
                f"respawned replica's first ingest was a "
                f"{first.get('kind')!r} (gen {first.get('generation')}"
                "), not a re-base",
            )
        return InvariantResult(
            self.name, True,
            f"respawned replica re-based at generation "
            f"{first.get('generation')} and applied {len(post)} "
            "generation(s)",
        )


def _fleet_injections(events: List[dict], point: str) -> List[dict]:
    return [
        e for e in _injections(events) if e.get("point") == point
    ]


class RoutedTrafficClean(Invariant):
    """The fleet's headline verdict, decided from events alone: the
    router's ``serving_route`` windows counted real traffic with ZERO
    ``failed`` and ZERO ``stale`` outcomes, the freshness floor never
    regressed across windows, and the load harness's client-side
    aggregate (``serving_lookup_stats`` with ``replica="load"``)
    agrees that no failure ever reached a caller."""

    name = "routed_traffic_clean"

    def check(self, events, run):
        windows = [
            e for e in events if e.get("type") == "serving_route"
        ]
        if not windows:
            return InvariantResult(
                self.name, False, "no serving_route window recorded"
            )
        total = sum(int(e.get("count") or 0) for e in windows)
        failed = sum(int(e.get("failed") or 0) for e in windows)
        stale = sum(int(e.get("stale") or 0) for e in windows)
        if total == 0:
            return InvariantResult(
                self.name, False,
                f"{len(windows)} windows but zero routed lookups",
            )
        floors = [
            int(e.get("generation_floor", -1))
            for e in sorted(windows, key=lambda e: e.get("ts", 0))
        ]
        regress = [
            (a, b) for a, b in zip(floors, floors[1:]) if b < a
        ]
        if failed or stale or regress:
            return InvariantResult(
                self.name, False,
                f"routed {total}: failed={failed} stale={stale} "
                f"floor_regressions={regress[:3]}",
            )
        loads = [
            e for e in events
            if e.get("type") == "serving_lookup_stats"
            and e.get("replica") == "load"
        ]
        client_failed = sum(int(e.get("failed") or 0) for e in loads)
        if client_failed:
            return InvariantResult(
                self.name, False,
                f"{client_failed} client-visible lookup failure(s)",
            )
        return InvariantResult(
            self.name, True,
            f"{total} routed over {len(windows)} windows, 0 failed, "
            f"0 stale, floor {floors[0]}->{floors[-1]} monotonic, "
            f"client failures 0",
        )


class ReplicaShedAndReadmitted(Invariant):
    """The SIGKILLed pool member was shed (``replica_status`` state
    suspect/lost from the router) within ``window_s`` of the
    injection, and its RESPAWNED incarnation later re-joined and was
    re-admitted at a served generation — the pool healed without any
    caller noticing."""

    def __init__(self, killed_id: int, window_s: float):
        self.killed_id = killed_id
        self.window_s = window_s
        self.name = f"replica_shed_within[{window_s:g}s]"

    def check(self, events, run):
        kills = _fleet_injections(events, "serving.ingest")
        if not kills:
            return InvariantResult(
                self.name, False,
                "no serving.ingest injection (replica never killed)",
            )
        kill_ts = kills[0]["ts"]
        status = [
            e for e in events
            if e.get("type") == "replica_status"
            and int(e.get("replica_id", -1)) == self.killed_id
        ]
        sheds = [
            e for e in status
            if e.get("state") in ("suspect", "lost")
            and e["ts"] >= kill_ts
        ]
        if not sheds:
            return InvariantResult(
                self.name, False,
                f"replica {self.killed_id} was never shed after the "
                "kill",
            )
        shed_lag = sheds[0]["ts"] - kill_ts
        if shed_lag > self.window_s:
            return InvariantResult(
                self.name, False,
                f"shed {shed_lag:.2f}s after the kill > "
                f"{self.window_s:g}s window",
            )
        back = [
            e for e in status
            if e.get("state") in ("joined", "recovered", "admitted")
            and e.get("respawned") and e["ts"] > kill_ts
        ]
        if not back:
            return InvariantResult(
                self.name, False,
                f"respawned replica {self.killed_id} never re-joined "
                "the table",
            )
        return InvariantResult(
            self.name, True,
            f"shed {shed_lag:.2f}s after the kill; respawn "
            f"re-admitted at gen {back[-1].get('generation')}",
        )


class FleetHealthyReplicasNotRestarted(Invariant):
    """Blast radius: NO pool member other than the killed one ever
    reported a respawned incarnation — neither the replica kill nor
    the router kill/replay may restart healthy replicas."""

    def __init__(self, killed_id: int):
        self.killed_id = killed_id
        self.name = "fleet_healthy_not_restarted"

    def check(self, events, run):
        respawned = {
            int(e.get("replica_id", -1))
            for e in events
            if e.get("type") == "replica_status" and e.get("respawned")
        }
        strays = sorted(respawned - {self.killed_id})
        if strays:
            return InvariantResult(
                self.name, False,
                f"healthy replica(s) {strays} reported respawned "
                "incarnations",
            )
        return InvariantResult(
            self.name, True,
            f"only replica {self.killed_id} respawned",
        )


class RouterReplayMatchesLive(Invariant):
    """The router was killed mid-stream, resumed routing after its
    respawn, and a cold journal replay reconstructs EXACTLY the live
    routing table the runner snapshotted (per-member generation /
    draining / removed plus the freshness floor) — membership is a
    deterministic function of the journal, not of runtime luck."""

    def __init__(self, journal_dir: str, live_snapshot_json: str):
        self.journal_dir = journal_dir
        self.live_snapshot_json = live_snapshot_json
        self.name = "router_replay_matches_live"

    @staticmethod
    def _view(members: Dict) -> Dict[int, Tuple]:
        return {
            int(v["replica_id"]): (
                int(v.get("generation", -1)),
                bool(v.get("draining")),
                bool(v.get("removed")),
            )
            for v in members
        }

    def check(self, events, run):
        kills = _fleet_injections(events, "serving.route")
        if not kills:
            return InvariantResult(
                self.name, False,
                "no serving.route injection (router never killed)",
            )
        kill_ts = kills[0]["ts"]
        resumed = [
            e for e in events
            if e.get("type") == "serving_route"
            and e["ts"] > kill_ts and int(e.get("count") or 0) > 0
        ]
        if not resumed:
            return InvariantResult(
                self.name, False,
                "no routed traffic after the router kill (respawn "
                "never resumed routing)",
            )
        try:
            with open(self.live_snapshot_json) as f:
                live = json.load(f)
        except OSError as e:
            return InvariantResult(
                self.name, False, f"no live table snapshot: {e}"
            )
        from dlrover_tpu_torch.serving.router import RoutingTable

        replayed = RoutingTable.replayed(self.journal_dir)
        snap = replayed.snapshot()
        got = self._view(snap["members"])
        want = self._view(live["members"])
        if got != want or (
            snap["generation_floor"] != live["generation_floor"]
        ):
            return InvariantResult(
                self.name, False,
                f"replayed table != live: replay={got} "
                f"floor={snap['generation_floor']} vs live={want} "
                f"floor={live['generation_floor']}",
            )
        return InvariantResult(
            self.name, True,
            f"replay == live across {len(want)} member(s), floor "
            f"{snap['generation_floor']}; routing resumed "
            f"({len(resumed)} post-kill windows)",
        )

class NoOrphanProcesses(Invariant):
    """No process whose cmdline or environment references the job's
    workdir survives the run — catches leaked trainers, forkserver
    children whose template died, and the local master (matched via
    its inherited env)."""

    name = "no_orphan_processes"

    def __init__(self, marker: str, grace_s: float = 5.0):
        self.marker = marker
        self.grace_s = grace_s

    def check(self, events, run):
        deadline = time.time() + self.grace_s
        leftovers = scan_processes(self.marker)
        while leftovers and time.time() < deadline:
            time.sleep(0.2)  # freshly-killed procs may linger a beat
            leftovers = scan_processes(self.marker)
        if leftovers:
            return InvariantResult(
                self.name, False, f"orphans: {leftovers}"
            )
        return InvariantResult(self.name, True, "no survivors")


def _ancestors(pid: int) -> List[int]:
    """pid plus its ppid chain up to init (a shell wrapper invoking
    the harness carries the workdir in ITS cmdline and must never be
    reported as an orphan)."""
    chain = []
    while pid > 1 and len(chain) < 64:
        chain.append(pid)
        fields = proc_stat_fields(pid)
        if fields is None:
            break
        try:
            pid = int(fields[1])  # ppid
        except (IndexError, ValueError):
            break
    chain.append(pid)
    return chain


def scan_processes(marker: str) -> List[int]:
    """Live (non-zombie) pids whose cmdline OR environment contains
    ``marker``, excluding this process and its ancestors.  The environ
    check is what catches a leaked local master: its argv carries no
    workdir, but it inherits ``DLROVER_SHARED_DIR=<workdir>/sock``."""
    skip = set(_ancestors(os.getpid()))
    out: List[int] = []
    marker_b = marker.encode()
    # stdlib runtime infrastructure legitimately outlives a run and
    # inherits the run's env (the harness's own multiprocessing
    # resource tracker, spawned lazily mid-run) — never an orphan
    infra = (b"resource_tracker", b"semaphore_tracker",
             b"multiprocessing.forkserver")
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        if pid in skip:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
            if any(tag in cmdline for tag in infra):
                continue
            matched = marker_b in cmdline
            if not matched:
                try:
                    with open(f"/proc/{pid}/environ", "rb") as f:
                        matched = marker_b in f.read()
                except OSError:  # other-user process: environ hidden
                    pass
            if not matched:
                continue
            fields = proc_stat_fields(pid)
            if fields is not None and fields[0] != b"Z":
                out.append(pid)
        except OSError:
            continue
    return out


def timeline_from_events(events: List[dict]) -> List[Tuple]:
    """Cross-run-comparable fault timeline from the event log:
    ``(seq, point, rule, action, step)`` per injection, ordered by
    emitting source then per-process seq (with step as tiebreak).
    Caveat: two processes with the SAME source both injecting (e.g. a
    future multi-agent partition) collide on (source, seq) — such
    scenarios need a per-process discriminator in the key before
    their timelines compare stably across runs."""
    inj = _injections(events)
    inj.sort(
        key=lambda e: (
            e.get("source", ""), e.get("seq", 0), e.get("step") or 0,
        )
    )
    return [
        (
            e.get("seq"), e.get("point"), e.get("rule"),
            e.get("action"), e.get("step"),
        )
        for e in inj
    ]


@dataclass
class ChaosRunReport:
    scenario: str
    seed: int
    rc: int
    workdir: str
    event_log: str
    events: List[dict] = field(default_factory=list)
    timeline: List[Tuple] = field(default_factory=list)
    invariants: List[InvariantResult] = field(default_factory=list)
    # flight recorder: the assembled job timeline + goodput-loss
    # attribution, ready-made for invariants and post-mortems (no
    # re-parsing of raw events)
    job_timeline: Optional[flight.JobTimeline] = None
    attribution: Optional[dict] = None
    # wall clock at which the harness respawned the job's master (the
    # resize runner's ``respawn_master``), None when it did not
    master_respawned_at: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.rc == 0 and all(r.ok for r in self.invariants)

    def summary(self) -> str:
        lines = [
            f"scenario {self.scenario!r} seed={self.seed} rc={self.rc}",
            f"events: {len(self.events)}  injections: "
            f"{len(self.timeline)}",
        ]
        for t in self.timeline:
            lines.append(f"  inject {t}")
        if self.attribution and self.attribution["loss_s"] > 0:
            lines.append(
                f"  goodput {self.attribution['goodput']:.4f}  "
                f"lost {self.attribution['loss_s']:.3f}s "
                f"{self.attribution['buckets']}"
            )
        for r in self.invariants:
            mark = "PASS" if r.ok else "FAIL"
            lines.append(f"  [{mark}] {r.name}: {r.detail}")
        lines.append("RESULT: " + ("PASS" if self.ok else "FAIL"))
        return "\n".join(lines)


class _patched_env:
    """Set env vars for the run, restore the previous values after —
    the harness runs inside long-lived test processes."""

    def __init__(self, values: Dict[str, str]):
        self._values = values
        self._saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        for k, v in self._values.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False


def _build_report(
    scenario, rc: int, workdir: str, event_log: str,
    extra_sources: Optional[List[str]] = None,
) -> ChaosRunReport:
    """Collect the run's event stream (master log + any agent-shipped
    logs), assemble the flight-recorder timeline and goodput-loss
    attribution, and wrap everything in a report — the single
    post-run ingestion path both harness flavours share."""
    sources = [event_log] + list(extra_sources or [])
    events = collect_events(sources)
    report = ChaosRunReport(
        scenario=scenario.name,
        seed=scenario.seed,
        rc=rc,
        workdir=workdir,
        event_log=event_log,
        events=events,
        timeline=timeline_from_events(events),
    )
    try:
        report.job_timeline = flight.assemble(events)
        report.attribution = flight.attribute_goodput_loss(
            report.job_timeline
        )
    except Exception:  # noqa: BLE001 - assembly bug must not hide
        # the raw events from the invariants
        logger.exception("flight-recorder assembly failed")
    return report


def default_invariants(
    total_steps: int, ckpt_every: int, workdir: str,
    goodput_named_floor: float = 0.0,
) -> List[Invariant]:
    """The full recovery set — appropriate for scenarios whose fault
    is expected to crash a worker.  Every recovery scenario also
    proves its goodput accounting CLOSES (conservation within 2% per
    incarnation); pass ``goodput_named_floor`` to additionally demand
    that fraction of non-productive time land in named categories."""
    return [
        WorkerRestarted(),
        RendezvousReconverged(),
        BoundedStepLoss(ckpt_interval=ckpt_every),
        TrainingCompleted(total_steps=total_steps),
        NoOrphanProcesses(marker=workdir),
        GoodputConservation(named_floor=goodput_named_floor),
    ]


# scenarios whose fault kills a worker and therefore must show the
# full restart/reconverge/step-loss trail; every other scenario's
# DESIRED outcome is "the job rides it out with no restart at all",
# so only completion + no-orphans apply
RECOVERY_SCENARIOS = frozenset({
    "kill-worker-midstep", "sigterm-worker-midstep",
})


def invariants_for_scenario(
    name: str, total_steps: int, ckpt_every: int, workdir: str,
    disk_every: Optional[int] = None,
    env: Optional[Dict[str, str]] = None,
) -> List[Invariant]:
    """The reference's selection, for the scenarios the port has.
    ``env`` is the run's exported env (the RL loop's device and preset
    pick its control's)."""
    env = env or {}
    if name == "master-kill-restart-midround":
        # the control-plane recovery trail: journal replay, client
        # resyncs, exactly-once sharding, NO data-plane restarts —
        # and the flight recorder must attribute the outage to
        # master recovery
        return [
            MasterRecovered(),
            HealthyWorkersNotRestarted(),
            NoDuplicateShards(dataset_size=total_steps),
            FinalStepCommitted(),
            GoodputLossAttributed(
                min_attributed_frac=0.5,
                expect_cause=flight.CAUSE_MASTER_RECOVERY,
            ),
            # the ledger's per-incarnation accounting must still
            # close across the control-plane outage (the silent gap
            # lands in idle_unattributed, never breaks conservation)
            GoodputConservation(),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "warm-recovery-cache-hit":
        # the invisible-recovery trail: the full recovery set PLUS
        # the AOT hit witnessed from events (the first incarnation's
        # miss wrote the entry this one hits), the
        # compile-cache witness agreeing (status=aot-hit), the
        # measured retrace+aot under a ceiling that separates the
        # regimes, the WHOLE death->first-step cycle bounded, and
        # the budget's phase slices on the assembled timeline.
        # The reference's ceilings and knobs, unchanged.  The port's
        # step is eager: an AOT hit books the entry's library loads as
        # aot and the first eager call as retrace (the tiny CPU GPT's
        # is tens of ms); a build inside the first call (nvcc, tens of
        # seconds) or a cold import would trip 1.0 s.  The cycle
        # ceiling bounds the whole budget under host noise; tighten
        # both via the env knobs on quieter hardware.
        return default_invariants(
            total_steps, ckpt_every, workdir
        ) + [
            CompileCacheHitOnRecovery(),
            AotCacheHitOnRecovery(),
            RetraceBelow(ceiling_s=float(os.environ.get(
                "DLROVER_CHAOS_RETRACE_CEILING_S", "1.0"
            ))),
            RecoveryCycleBelow(ceiling_s=float(os.environ.get(
                "DLROVER_CHAOS_CYCLE_CEILING_S", "3.0"
            ))),
            RecoveryPhasesOnTimeline(),
        ]
    if name == "master-respawn-other-host":
        # the master-kill trail with the host-portability twist: the
        # respawn has a FRESH journal dir, so recovery must be seeded
        # from the storage-tier mirror — and exactly-once sharding
        # must still hold (resync ack-reconciliation covers the
        # mirror's group-commit lag)
        return [
            MasterRecovered(),
            MasterRecoveredFromMirror(),
            EventRecorded("journal_mirror_flush"),
            HealthyWorkersNotRestarted(),
            NoDuplicateShards(dataset_size=total_steps),
            FinalStepCommitted(),
            NoOrphanProcesses(marker=workdir),
        ]
    if name in ("warm-template-import-kill",
                "warm-template-midspawn-kill"):
        return [
            EventRecorded("warm_fork_fallback"),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "shm-corrupt-storage-fallback":
        # full recovery trail PLUS the tier assertion; step loss is
        # bounded by the DISK interval (the shm interval's snapshot
        # was deliberately torn).  ``disk_every`` is the interval the
        # run ACTUALLY used (run_scenario passes its resolved value);
        # standalone callers fall back to the scenario's RUN_OPTIONS
        if not disk_every:
            disk_every = RUN_OPTIONS.get(name, {}).get("disk_every", 0)
        return [
            WorkerRestarted(),
            RendezvousReconverged(),
            BoundedStepLoss(ckpt_interval=max(ckpt_every, disk_every)),
            RestoredFromTier("storage"),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "trainer-hang-detected":
        # the deep-diagnosis trail: evidence captured, hung verdict
        # with stacks + measured stall, ONLY the culprit restarted,
        # bounded loss, completion — and the loss attribution books
        # the stall under the hang bucket with real durations
        return [
            HangDiagnosed(within_s=30.0),
            OnlyCulpritRestarted(culprit_rank=0),
            BoundedStepLoss(ckpt_interval=ckpt_every),
            TrainingCompleted(total_steps=total_steps),
            GoodputLossAttributed(
                min_attributed_frac=0.75,
                expect_cause=flight.CAUSE_HANG,
            ),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "rl-rollout-worker-kill":
        # the elastic-RL acceptance trail: full recovery set + the PPO
        # loss trajectory equal to the uninterrupted control (flash
        # restore + deterministic train-step replay + the requeued
        # lease regenerated bit-identically), exactly-once rollout-
        # lease accounting from the master's journaled dispatch/ack
        # trail, and the recovery outage booked to a real cause bucket
        return default_invariants(
            total_steps, ckpt_every, workdir
        ) + [
            LossTrajectoryMatches(rl_reference_losses(
                total_steps,
                device=env.get("DLROVER_CHAOS_RL_DEVICE", "cpu"),
                preset=env.get("DLROVER_CHAOS_RL_PRESET", "tiny"),
            )),
            NoDuplicateShards(
                dataset_size=total_steps, dataset="rl-rollouts"
            ),
            GoodputLossAttributed(min_attributed_frac=0.5),
        ]
    if name == "sparse-streaming-reshard-kill":
        # the streaming-reshard trail: the worker died mid-reshard (no
        # train_step in incarnation 0, so no BoundedStepLoss), the
        # replacement replayed the reshard exactly-once against the
        # seeder's digests, and the job still finished + committed
        return [
            WorkerRestarted(),
            KvStreamingReshardReplayed(
                os.path.join(workdir, "seed_kv.json")
            ),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "sparse-kill-restore":
        # the sparse acceptance trail: full recovery set + the loss
        # trajectory equal to the uninterrupted DeepFM control (on the
        # run's device) + the kv digests proving rows/freq/slots
        # bit-identical through the cycle
        return default_invariants(
            total_steps, ckpt_every, workdir
        ) + [
            LossTrajectoryMatches(sparse_reference_losses(
                total_steps,
                device=env.get("DLROVER_CHAOS_SPARSE_DEVICE", "cpu"),
            )),
            KvStateRoundTrip(),
        ]
    if name == "serving-replica-kill-midingest":
        # the trainer is undisturbed (completion only); the serving
        # assertions carry the scenario: every served generation was
        # committed with matching digests (no torn serve), committed
        # exactly once, the respawned replica re-based from committed
        # state, and the replica converged on the final generation
        return [
            TrainingCompleted(total_steps=total_steps),
            ServedGenerationCommitted(),
            PublishExactlyOnce(),
            ReplicaReingested(),
            ServingConverged(),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "serving-fleet-replica-kill":
        # the fleet trail, decided from the merged router/replica/
        # load event logs: clean routed traffic throughout BOTH kills
        # (zero failed, zero stale, floor monotonic, zero client-
        # visible failures), the killed member shed within the
        # heartbeat window and its respawn re-admitted, no healthy
        # member restarted, and the respawned router's journal replay
        # equal to the live routing table.  The shed window is the
        # 1 s heartbeat timeout + the 0.4 s sweep cadence + CI slack.
        return [
            RoutedTrafficClean(),
            ReplicaShedAndReadmitted(killed_id=0, window_s=3.0),
            FleetHealthyReplicasNotRestarted(killed_id=0),
            RouterReplayMatchesLive(
                os.path.join(workdir, "router_journal"),
                os.path.join(workdir, "router_table_live.json"),
            ),
            GoodputConservation(),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "serving-trainer-kill-midpublish":
        # the data-plane recovery trail (the kill lands mid-step) PLUS
        # publish exactly-once across the trainer replacement: the
        # half-published generation never committed, the replacement
        # re-based at a fresh number, the replica kept serving and
        # converged — and the restored trainer's loss trajectory still
        # equals the uninterrupted control (publishing is side-effect-
        # free for training)
        return [
            WorkerRestarted(),
            BoundedStepLoss(ckpt_interval=ckpt_every),
            TrainingCompleted(total_steps=total_steps),
            LossTrajectoryMatches(sparse_reference_losses(
                total_steps,
                device=env.get("DLROVER_CHAOS_SPARSE_DEVICE", "cpu"),
            )),
            ServedGenerationCommitted(),
            PublishExactlyOnce(),
            ServingConverged(),
            NoOrphanProcesses(marker=workdir),
        ]
    if name == "sparse-spill-io-error":
        # no loss-trajectory assertion: rows stranded on the dead spill
        # disk are LOST by design — the contract is graceful
        # degradation (breaker trips, DRAM rows commit, the restore
        # round-trips exactly what the post-fault export contains)
        return [
            WorkerRestarted(),
            RendezvousReconverged(),
            BoundedStepLoss(ckpt_interval=ckpt_every),
            SpillBreakerTripped(),
            KvStateRoundTrip(),
            TrainingCompleted(total_steps=total_steps),
            NoOrphanProcesses(marker=workdir),
        ]
    if name in RECOVERY_SCENARIOS:
        # the worker-kill trail must also NAME >=90% of its
        # non-productive time (death witness -> rendezvous ->
        # restore -> first step), not dump it in idle_unattributed
        return default_invariants(
            total_steps, ckpt_every, workdir,
            goodput_named_floor=0.9,
        )
    return [
        TrainingCompleted(total_steps=total_steps),
        NoOrphanProcesses(marker=workdir),
    ]


def check_invariants(
    report: ChaosRunReport, checks: Sequence[Invariant]
) -> ChaosRunReport:
    """Evaluate ``checks`` on the report's events into
    ``report.invariants`` (a checker that crashes is a FAIL)."""
    for inv in checks:
        try:
            report.invariants.append(inv.check(report.events, report))
        except Exception as e:  # noqa: BLE001 - a checker bug is a FAIL
            logger.exception("invariant %s crashed", inv.name)
            report.invariants.append(
                InvariantResult(inv.name, False, f"checker crashed: {e}")
            )
    return report


def scenario_env(
    scenario, workdir: str, total_steps: int, ckpt_every: int,
    disk_every: int = 0,
    extra_env: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, str], str]:
    """The env a run of ``scenario`` under ``workdir`` exports (the
    scenario file, the event log, the loop's knobs, a socket dir and
    metrics file of the run's own, no ambient master) and the event
    log's path.  Writes the scenario file."""
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    event_log = os.path.join(workdir, "events.jsonl")
    opts = RUN_OPTIONS.get(scenario.name, {})
    env = {
        _chaos.CHAOS_ENV: spec_path,
        EVENT_LOG_ENV: event_log,
        TOTAL_STEPS_ENV: str(total_steps),
        CKPT_EVERY_ENV: str(ckpt_every),
        "DLROVER_SHARED_DIR": os.path.join(workdir, "sock"),
        "DLROVER_METRICS_FILE": os.path.join(workdir, "metrics.json"),
        # isolation: an ambient master address (a previous in-process
        # run, an outer job) must not hijack this mini-cluster — empty
        # means "spawn a fresh local master"
        "DLROVER_MASTER_ADDR": "",
    }
    if disk_every:
        env[DISK_EVERY_ENV] = str(disk_every)
    if opts.get("shard_dataset"):
        # shard-driven loop: one sample per shard, one shard per step
        env[SHARD_DATASET_ENV] = str(total_steps)
    if opts.get("compile_cache"):
        # workdir-scoped compile cache: incarnation 0's kernel build and
        # AOT entry deterministically pre-populate the replacement's,
        # with no cross-run pollution from a tmpdir default
        env["DLROVER_COMPILE_CACHE_DIR"] = os.path.join(
            workdir, "torch_cache"
        )
    if opts.get("journal_mirror"):
        # storage-tier journal mirror under the run's workdir; the
        # master (and its respawns) read this env at construction
        env["DLROVER_MASTER_JOURNAL_MIRROR_DIR"] = os.path.join(
            workdir, "journal_mirror"
        )
    env.update(opts.get("extra_env", {}))
    if extra_env:
        env.update(extra_env)
    return env, event_log


def launch(
    scenario, env: Dict[str, str], script_argv: List[str],
    max_restarts: int = 2, monitor_interval: float = 0.3,
    warm_restart: bool = False, launcher_args: Sequence[str] = (),
) -> int:
    """Run ``script_argv`` (the script and its arguments) under the
    launcher in this process with ``env`` exported and ``scenario``
    armed here too (the agent, its saver and monitors run in this
    process, and their hook points must see the scenario; ``None``
    arms nothing here); returns the launcher's exit code.
    ``launcher_args`` are further launcher options (``--network-check``)."""
    argv = [
        "--nproc_per_node=1",
        f"--max_restarts={max_restarts}",
        f"--monitor_interval={monitor_interval}",
    ]
    if warm_restart:
        argv.append("--warm-restart")
    argv += list(launcher_args) + list(script_argv)

    from dlrover_tpu_torch import run as launcher

    with _patched_env(env):
        if scenario is not None:
            _chaos.install(scenario)
        try:
            return launcher.main(argv)
        finally:
            _chaos.uninstall()


def run_scenario(
    scenario,
    workdir: str,
    total_steps: Optional[int] = None,
    ckpt_every: Optional[int] = None,
    max_restarts: int = 2,
    monitor_interval: float = 0.3,
    warm_restart: bool = False,
    invariants: Optional[List[Invariant]] = None,
    disk_every: Optional[int] = None,
    extra_env: Optional[Dict[str, str]] = None,
    _ceiling_budget: Optional[int] = None,
) -> ChaosRunReport:
    """Run ``scenario`` against a fresh single-node mini-cluster under
    ``workdir`` and evaluate the invariants.  With ``invariants=None``
    the set is chosen by scenario name (recovery scenarios get the
    full restart trail, ride-it-out scenarios completion+no-orphans);
    pass ``invariants=[]`` to skip checking entirely.

    When the run otherwise succeeded (rc == 0) but SOME invariants
    failed and every failure is ceiling-class (a measured duration vs
    a wall-clock ceiling — ``RetraceBelow``/``RecoveryCycleBelow``),
    the scenario is re-measured ONCE in a fresh sub-workdir and the
    second report returned, as the reference does: a trip by a few ms
    on a loaded host is measurement noise, while a real regression
    trips both runs.  ``DLROVER_CHAOS_CEILING_REMEASURE`` sets the
    retry budget (default 1; 0 disables).

    ``total_steps``/``ckpt_every``/``disk_every`` (durable mid-run
    saves), ``warm_restart`` and ``extra_env`` default to the
    scenario's entry in :data:`scenarios.RUN_OPTIONS`, so named
    scenarios run correctly from the CLI and tests alike."""
    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    if total_steps is None:
        total_steps = int(opts.get("total_steps", 10))
    if ckpt_every is None:
        ckpt_every = int(opts.get("ckpt_every", 2))
    if disk_every is None:
        disk_every = int(opts.get("disk_every", 0))
    warm_restart = warm_restart or bool(opts.get("warm_restart"))
    env, event_log = scenario_env(
        scenario, workdir, total_steps, ckpt_every,
        disk_every=disk_every, extra_env=extra_env,
    )
    if opts.get("seed_kv_world"):
        # pre-seed a committed old-world sparse checkpoint so the job's
        # FIRST restore is a cross-world streaming reshard; the
        # seeder's digest sums land in seed_kv.json for the
        # exactly-once invariant
        seed_sparse_world_checkpoint(
            os.path.join(workdir, "ckpt"),
            world=int(opts["seed_kv_world"]),
            out_json=os.path.join(workdir, "seed_kv.json"),
        )
    # the toy loop of RUN_OPTIONS' "train_script", as the reference
    # selects it
    script = os.path.join(workdir, "chaos_train.py")
    with open(script, "w") as f:
        f.write(TRAIN_SCRIPTS[opts.get("train_script", "default")])
    rc = launch(
        scenario, env, [script, os.path.join(workdir, "ckpt")],
        max_restarts=max_restarts, monitor_interval=monitor_interval,
        warm_restart=warm_restart,
    )
    report = _build_report(scenario, rc, workdir, event_log)
    checks = (
        invariants if invariants is not None
        else invariants_for_scenario(
            scenario.name, total_steps, ckpt_every, workdir,
            disk_every=disk_every, env=env,
        )
    )
    report = check_invariants(report, checks)
    if _ceiling_budget is None:
        _ceiling_budget = int(os.environ.get(
            "DLROVER_CHAOS_CEILING_REMEASURE", "1"
        ))
    failed = [r for r in report.invariants if not r.ok]
    by_name = {inv.name: inv for inv in checks}
    if (
        failed and report.rc == 0 and _ceiling_budget > 0
        and all(
            getattr(by_name.get(r.name), "ceiling_class", False)
            for r in failed
        )
    ):
        logger.warning(
            "ceiling-class trip(s) only (%s); re-measuring once in a "
            "fresh workdir",
            ", ".join(f"{r.name}: {r.detail}" for r in failed),
        )
        return run_scenario(
            scenario,
            os.path.join(workdir, "ceiling_remeasure"),
            total_steps=total_steps,
            ckpt_every=ckpt_every,
            max_restarts=max_restarts,
            monitor_interval=monitor_interval,
            warm_restart=warm_restart,
            invariants=invariants,
            disk_every=disk_every,
            extra_env=extra_env,
            _ceiling_budget=_ceiling_budget - 1,
        )
    return report


def run_serving_scenario(
    scenario,
    workdir: str,
    total_steps: Optional[int] = None,
    max_replica_respawns: int = 1,
    replica_lookup_batch: int = 256,
    converge_timeout_s: float = 20.0,
    invariants: Optional[List[Invariant]] = None,
    **kwargs,
) -> ChaosRunReport:
    """Run a train-to-serve scenario: the single-node mini-cluster
    (trainer publishing serving generations) PLUS a supervised
    read-only replica subprocess (``python -m dlrover_tpu_torch.serving``)
    ingesting them while driving lookup traffic.

    The replica gets its OWN event log (merged into the report like
    an agent-shipped log) and the scenario spec via ``DLROVER_CHAOS``
    — rules targeting it select on ``DLROVER_SERVING_ROLE=replica``.
    A replica that dies is respawned up to ``max_replica_respawns``
    times with ``DLROVER_SERVING_RESPAWNED=1`` (the schedule's
    env-equals guard against re-firing, and the ``respawned`` stamp
    on its events).  After training finishes the runner waits for the
    replica to converge on the final committed generation, then stops
    it via the stop file before the orphan scan runs."""
    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    os.makedirs(workdir, exist_ok=True)
    serving_dir = os.path.join(workdir, "serving")
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    replica_log = os.path.join(workdir, "serving_events.jsonl")
    stop_file = os.path.join(workdir, "serving_stop")

    replica_env = _pkg_env(dict(os.environ))
    replica_env.update(opts.get("extra_env", {}))
    replica_env.update({
        _chaos.CHAOS_ENV: spec_path,
        EVENT_LOG_ENV: replica_log,
        "DLROVER_SERVING_ROLE": "replica",
        "DLROVER_SERVING_RESPAWNED": "",
        # the replica needs no master and must not inherit one
        "DLROVER_MASTER_ADDR": "",
    })
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.serving",
        "--dir", serving_dir,
        "--poll", "0.1",
        "--batch", str(replica_lookup_batch),
        "--key-space", "4000",
        "--stats-every", "0.5",
        "--stop-file", stop_file,
    ]
    state = {"proc": None, "respawns": 0, "stopping": False}

    def _spawn(respawned: bool):
        env = dict(replica_env)
        if respawned:
            env["DLROVER_SERVING_RESPAWNED"] = "1"
        state["proc"] = subprocess.Popen(  # noqa: S603
            cmd, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def _supervise():
        while not state["stopping"]:
            proc = state["proc"]
            if proc is None:
                return
            rc = proc.wait()
            if state["stopping"] or rc == 0:
                return
            if state["respawns"] >= max_replica_respawns:
                logger.warning(
                    "serving replica died rc=%s with no respawn "
                    "budget left", rc,
                )
                return
            state["respawns"] += 1
            logger.warning(
                "serving replica died rc=%s; respawning (%d/%d)",
                rc, state["respawns"], max_replica_respawns,
            )
            _spawn(respawned=True)

    _spawn(respawned=False)
    supervisor = threading.Thread(
        target=_supervise, daemon=True, name="serving-replica-sup"
    )
    supervisor.start()

    try:
        base = run_scenario(
            scenario, workdir,
            total_steps=total_steps,
            invariants=[],
            extra_env={"DLROVER_SERVING_DIR": serving_dir},
            **kwargs,
        )
        # let the replica converge on the final committed generation
        # before stopping it (the freshness the invariants assert)
        from dlrover_tpu_torch.serving.publisher import (
            committed_generation,
        )

        deadline = time.time() + converge_timeout_s
        target = committed_generation(serving_dir)
        while time.time() < deadline and target > 0:
            try:
                ingested = {
                    e.get("generation")
                    for e in collect_events([replica_log])
                    if e.get("type") == "serving_ingest"
                }
            except OSError:
                ingested = set()
            if target in ingested:
                break
            time.sleep(0.25)
    finally:
        state["stopping"] = True
        with open(stop_file, "w") as f:
            f.write("stop")
        proc = state["proc"]
        if proc is not None:
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        supervisor.join(timeout=5.0)

    report = _build_report(
        scenario, base.rc, workdir, base.event_log,
        extra_sources=[replica_log],
    )
    resolved_steps = total_steps if total_steps is not None else int(
        opts.get("total_steps", 10)
    )
    checks = (
        invariants if invariants is not None
        else invariants_for_scenario(
            scenario.name, resolved_steps,
            int(opts.get("ckpt_every", 2)), workdir,
            env=dict(os.environ, **opts.get("extra_env", {})),
        )
    )
    return check_invariants(report, checks)


def run_serving_fleet_scenario(
    scenario,
    workdir: str,
    pool_size: Optional[int] = None,
    generations: Optional[int] = None,
    publish_every_s: Optional[float] = None,
    load_streams: Optional[int] = None,
    lookup_floor_ms: Optional[float] = None,
    heartbeat_s: float = 0.25,
    heartbeat_timeout_s: float = 1.0,
    converge_timeout_s: float = 30.0,
    max_router_respawns: int = 1,
    invariants: Optional[List[Invariant]] = None,
) -> ChaosRunReport:
    """Run a serving-FLEET scenario: an in-process publisher shipping
    embedding generations (bases forced mid-run via ``compact_every``
    so drained re-bases land under load), a supervised
    :class:`~dlrover_tpu_torch.serving.pool.ReplicaPool` of replica
    subprocesses, a ``python -m dlrover_tpu_torch.serving.router``
    subprocess fronting them (journaled membership; respawned on
    death with ``DLROVER_SERVING_RESPAWNED=1`` onto the SAME port so
    clients reconnect), and a
    :class:`~dlrover_tpu_torch.fleet.lookup_load.LookupLoadHarness` driving
    real routed lookups throughout.

    The RUNNER process never arms the scenario — only the replica and
    router subprocesses receive ``DLROVER_CHAOS``, so kill rules
    select their targets via ``DLROVER_SERVING_ROLE`` /
    ``DLROVER_SERVING_REPLICA_ID`` env guards.  All subprocess event
    logs are merged into the report; before teardown the runner
    snapshots the LIVE routing table (``router_table_live.json``) for
    the journal-replay-determinism invariant and emits the load
    harness's client-side aggregate as a ``serving_lookup_stats``
    event (``replica="load"``), so every verdict decides from events
    alone."""
    import numpy as np

    from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
    from dlrover_tpu_torch.common.comm import MessageClient
    from dlrover_tpu_torch.fleet.lookup_load import LookupLoadHarness
    from dlrover_tpu_torch.ops.kv_variable import KvVariable
    from dlrover_tpu_torch.serving.messages import RoutingTableRequest
    from dlrover_tpu_torch.serving.pool import ReplicaPool
    from dlrover_tpu_torch.serving.publisher import (
        EmbeddingPublisher,
        committed_generation,
    )
    from dlrover_tpu_torch.telemetry.events import emit_event

    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    if pool_size is None:
        pool_size = int(opts.get("pool_size", 2))
    if generations is None:
        generations = int(opts.get("generations", 10))
    if publish_every_s is None:
        publish_every_s = float(opts.get("publish_every_s", 0.35))
    if load_streams is None:
        load_streams = int(opts.get("load_streams", 4))
    if lookup_floor_ms is None:
        lookup_floor_ms = float(opts.get("lookup_floor_ms", 2.0))
    os.makedirs(workdir, exist_ok=True)
    serving_dir = os.path.join(workdir, "serving")
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    event_log = os.path.join(workdir, "events.jsonl")
    router_log = os.path.join(workdir, "events_router.jsonl")
    journal_dir = os.path.join(workdir, "router_journal")
    router_port_file = os.path.join(workdir, "router.port")
    router_stop = os.path.join(workdir, "router.stop")
    live_json = os.path.join(workdir, "router_table_live.json")

    router_env = _pkg_env(dict(os.environ))
    router_env.update(opts.get("extra_env", {}))
    router_env.update({
        _chaos.CHAOS_ENV: spec_path,
        EVENT_LOG_ENV: router_log,
        "DLROVER_SERVING_ROLE": "router",
        "DLROVER_SERVING_RESPAWNED": "",
        "DLROVER_MASTER_ADDR": "",
    })
    state = {"proc": None, "respawns": 0, "stopping": False,
             "port": 0}

    def _spawn_router(respawned: bool):
        env = dict(router_env)
        if respawned:
            env["DLROVER_SERVING_RESPAWNED"] = "1"
        try:
            os.remove(router_port_file)
        except OSError:
            pass
        state["proc"] = subprocess.Popen(  # noqa: S603
            [
                sys.executable, "-m", "dlrover_tpu_torch.serving.router",
                "--journal-dir", journal_dir,
                # respawns rebind the SAME port so every client's
                # retry envelope reconnects instead of failing over
                "--port", str(state["port"]),
                "--port-file", router_port_file,
                "--stop-file", router_stop,
                "--heartbeat-timeout", str(heartbeat_timeout_s),
                "--min-available", "1",
                "--stats-every", "0.4",
            ],
            env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def _wait_router_port(timeout_s: float = 20.0) -> int:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                with open(router_port_file) as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                time.sleep(0.05)
        raise TimeoutError("router never wrote its port file")

    def _supervise_router():
        while not state["stopping"]:
            proc = state["proc"]
            if proc is None:
                return
            rc = proc.wait()
            if state["stopping"] or rc == 0:
                return
            if state["respawns"] >= max_router_respawns:
                logger.warning(
                    "router died rc=%s with no respawn budget", rc
                )
                return
            state["respawns"] += 1
            logger.warning(
                "router died rc=%s; respawning (%d/%d)",
                rc, state["respawns"], max_router_respawns,
            )
            _spawn_router(respawned=True)

    rc = 0
    pool = None
    ctl = None
    pool_logs: List[str] = []
    with _patched_env({
        EVENT_LOG_ENV: event_log,
        "DLROVER_MASTER_ADDR": "",
    }):
        try:
            # -- publisher state (in-process; never a kill target) --
            rows, dim = 4000, 16
            rng = np.random.default_rng(scenario.seed)
            table = KvVariable(
                dim, initial_capacity=rows * 2, name="emb"
            )
            table.enable_dirty_tracking()
            table.insert(
                np.arange(rows, dtype=np.int64),
                rng.normal(size=(rows, dim)).astype(np.float32),
            )
            adapter = SparseStateAdapter(digest=True).register_table(
                table
            )
            pub = EmbeddingPublisher(
                adapter, serving_dir,
                compact_every=int(opts.get("compact_every", 3)),
            )
            pub.publish(step=0)

            _spawn_router(respawned=False)
            state["port"] = _wait_router_port()
            supervisor = threading.Thread(
                target=_supervise_router, daemon=True,
                name="router-sup",
            )
            supervisor.start()
            router_addr = f"127.0.0.1:{state['port']}"

            pool = ReplicaPool(
                serving_dir, os.path.join(workdir, "pool"),
                router_addr=router_addr, size=pool_size,
                heartbeat_s=heartbeat_s,
                lookup_floor_ms=lookup_floor_ms,
                stats_every_s=0.5, max_respawns=1,
                extra_env={_chaos.CHAOS_ENV: spec_path},
            )
            pool_logs = pool.event_logs()
            pool.wait_ports(30.0)

            # patient control client: rides out the router respawn
            ctl = MessageClient(
                router_addr, node_id=-3, node_type="fleet-runner",
                timeout=15.0, retries=8, backoff_base=0.1,
                backoff_max=1.0, resync_timeout=0.0,
            )

            def _table_view():
                resp = ctl.get(RoutingTableRequest())
                live = [
                    m for m in resp.members.values()
                    if not m.get("removed")
                ]
                return resp, live

            deadline = time.time() + 20.0
            while time.time() < deadline:
                _, live = _table_view()
                if len(live) >= pool_size and all(
                    int(m.get("generation", -1)) >= 0 for m in live
                ):
                    break
                time.sleep(0.1)

            load = LookupLoadHarness(
                router_addr, streams=load_streams, batch=128,
                key_space=rows, timeout_s=30.0, retries=8,
                seed=scenario.seed,
            )
            load.start()
            try:
                for g in range(1, generations + 1):
                    touched = rng.choice(
                        rows, size=256, replace=False
                    ).astype(np.int64)
                    table.scatter_add(
                        touched,
                        (rng.normal(size=(len(touched), dim)) * 0.01)
                        .astype(np.float32),
                    )
                    pub.publish(step=g)
                    time.sleep(publish_every_s)

                # convergence: the whole pool (incl. the respawned
                # member) admitted at the final committed generation
                target = committed_generation(serving_dir)
                deadline = time.time() + converge_timeout_s
                while time.time() < deadline:
                    resp, live = _table_view()
                    if resp.generation_floor >= target and live and \
                            all(
                                int(m.get("generation", -1)) >= target
                                for m in live
                            ):
                        break
                    time.sleep(0.2)
                # one more beat of routed traffic at the converged
                # floor so post-respawn windows carry real counts
                time.sleep(0.6)
            finally:
                load.stop()

            summary = load.summary()
            emit_event(
                "serving_lookup_stats",
                count=int(summary["lookups"]),
                p50_ms=summary.get("p50_ms", 0.0),
                p99_ms=summary.get("p99_ms", 0.0),
                qps=summary.get("qps", 0.0),
                window_s=summary.get("wall_s", 0.0),
                generation=int(summary["max_generation"]),
                replica="load",
                failed=int(summary["failed"]),
                streams=int(summary["streams"]),
            )
            resp, _ = _table_view()
            with open(live_json, "w") as f:
                json.dump({
                    "members": list(resp.members.values()),
                    "generation_floor": int(resp.generation_floor),
                    "journal_seq": int(resp.journal_seq),
                }, f, indent=2)
        except Exception:  # noqa: BLE001 - report carries the verdict
            logger.exception("serving-fleet run failed")
            rc = 1
        finally:
            if ctl is not None:
                ctl.close()
            if pool is not None:
                pool.stop()
            state["stopping"] = True
            with open(router_stop, "w") as f:
                f.write("stop")
            proc = state["proc"]
            if proc is not None:
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    try:
                        proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()

    report = _build_report(
        scenario, rc, workdir, event_log,
        extra_sources=[router_log] + pool_logs,
    )
    checks = (
        invariants if invariants is not None
        else invariants_for_scenario(
            scenario.name, generations, 2, workdir
        )
    )
    return check_invariants(report, checks)


# -- multi-agent runners -------------------------------------------------------


def _pkg_env(base: Dict[str, str]) -> Dict[str, str]:
    """``base`` with the port's package root on ``PYTHONPATH``, so the
    subprocesses import it wherever the caller runs from."""
    import dlrover_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(dlrover_tpu_torch.__file__))
    prev = base.get("PYTHONPATH", "")
    if pkg_root not in prev.split(os.pathsep):
        base["PYTHONPATH"] = (
            f"{pkg_root}{os.pathsep}{prev}" if prev else pkg_root
        )
    return base


def _start_master(base_env, workdir, port, nnodes, min_nodes=0,
                  restart_count=0) -> subprocess.Popen:
    """The job's journal-backed master as a subprocess on ``port``; a
    respawn (``restart_count`` > 0) replays the same journal."""
    from dlrover_tpu_torch.common.comm import addr_connected

    env = dict(
        base_env,
        DLROVER_MASTER_JOURNAL_DIR=os.path.join(workdir, "master_journal"),
        DLROVER_RESTART_COUNT=str(restart_count),
    )
    argv = [sys.executable, "-m", "dlrover_tpu_torch.master.main",
            "--port", str(port), "--node_num", str(nnodes)]
    if min_nodes:
        argv += ["--min_nodes", str(min_nodes)]
    master = subprocess.Popen(argv, env=env)  # noqa: S603
    deadline = time.time() + 30
    while not addr_connected(f"127.0.0.1:{port}"):
        if master.poll() is not None or time.time() > deadline:
            master.kill()
            raise RuntimeError("multinode master failed to start")
        time.sleep(0.2)
    return master


def _stop_master(master: subprocess.Popen):
    if master.poll() is None:
        master.terminate()
        try:
            master.wait(timeout=10)
        except subprocess.TimeoutExpired:
            master.kill()
            master.wait()


def default_multinode_invariants(
    nnodes: int, total_steps: int, workdir: str,
    faulted_rank: Optional[int] = None,
) -> List[Invariant]:
    """Per-node completion for every rank; when one rank carries the
    fault, additionally pin the blast radius: injections confined to
    it and no restart of the healthy ranks."""
    checks: List[Invariant] = [
        NodeCompletedSteps(rank, total_steps) for rank in range(nnodes)
    ]
    if faulted_rank is not None:
        checks.append(InjectionsOnlyOnNode(faulted_rank))
        checks.extend(
            NoRestartForNode(rank)
            for rank in range(nnodes) if rank != faulted_rank
        )
    checks.append(NoOrphanProcesses(marker=workdir))
    return checks


def run_scenario_multinode(
    scenario,
    workdir: str,
    nnodes: int = 2,
    total_steps: Optional[int] = None,
    ckpt_every: Optional[int] = None,
    max_restarts: int = 2,
    monitor_interval: float = 0.3,
    warm_restart: bool = False,
    invariants: Optional[List[Invariant]] = None,
    faulted_rank: Optional[int] = None,
    timeout: float = 240.0,
) -> ChaosRunReport:
    """Drive ``nnodes`` REAL agent processes (each a full
    ``python -m dlrover_tpu_torch.run`` supervision tree with its own
    trainer, one box) against one shared, journal-backed master
    subprocess.  Every process arms the same scenario via
    ``DLROVER_CHAOS``; rules target a subset with ``env_equals:
    {"DLROVER_NODE_RANK": ...}``.  One event log collects the whole
    job (the master's, plus a log a node folded in through the
    aggregate glob), and the invariants decide from it alone."""
    from dlrover_tpu_torch.common.comm import find_free_port

    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    if total_steps is None:
        total_steps = int(opts.get("total_steps", 10))
    if ckpt_every is None:
        ckpt_every = int(opts.get("ckpt_every", 2))
    step_sleep = float(opts.get("step_sleep", 0.0))
    warm_restart = warm_restart or bool(opts.get("warm_restart"))
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    script = os.path.join(workdir, "chaos_train.py")
    with open(script, "w") as f:
        f.write(CHAOS_TRAIN_SCRIPT)
    event_log = os.path.join(workdir, "events.jsonl")
    agent_event_glob = os.path.join(workdir, "events_node*.jsonl")
    base_env = _pkg_env(dict(
        os.environ,
        **{
            _chaos.CHAOS_ENV: spec_path,
            EVENT_LOG_ENV: event_log,
            EVENTS_AGGREGATE_ENV: agent_event_glob,
            TOTAL_STEPS_ENV: str(total_steps),
            CKPT_EVERY_ENV: str(ckpt_every),
        },
    ))
    if step_sleep:
        base_env[STEP_SLEEP_ENV] = str(step_sleep)
    base_env.update(opts.get("extra_env", {}))
    port = find_free_port()
    addr = f"127.0.0.1:{port}"
    master = _start_master(base_env, workdir, port, nnodes)
    agents: List[subprocess.Popen] = []
    logs: List = []
    rc = 0
    try:
        for rank in range(nnodes):
            env = dict(
                base_env,
                DLROVER_MASTER_ADDR=addr,
                **{EVENT_LOG_ENV: os.path.join(
                    workdir, f"events_node{rank}.jsonl")},
                DLROVER_NODE_RANK=str(rank),
                DLROVER_NODE_ID=str(rank),
                DLROVER_SHARED_DIR=os.path.join(workdir, f"sock{rank}"),
                DLROVER_METRICS_FILE=os.path.join(
                    workdir, f"metrics_{rank}.json"),
            )
            out = open(os.path.join(workdir, f"agent{rank}.log"), "w")
            logs.append(out)
            argv = [
                sys.executable, "-m", "dlrover_tpu_torch.run",
                "--nnodes", str(nnodes),
                "--nproc_per_node", "1",
                f"--max_restarts={max_restarts}",
                f"--monitor_interval={monitor_interval}",
                "--node_rank", str(rank),
            ]
            if warm_restart:
                argv.append("--warm-restart")
            argv += [script, os.path.join(workdir, f"ckpt{rank}")]
            agents.append(subprocess.Popen(  # noqa: S603
                argv, env=env, stdout=out, stderr=subprocess.STDOUT,
            ))
        deadline = time.time() + timeout
        for p in agents:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = rc or 124
            rc = rc or (p.returncode or 0)
    finally:
        for p in agents:
            if p.poll() is None:
                p.kill()
                p.wait()
        _stop_master(master)
        for out in logs:
            out.close()

    report = _build_report(scenario, rc, workdir, event_log,
                           extra_sources=[agent_event_glob])
    checks = (
        invariants if invariants is not None
        else default_multinode_invariants(
            nnodes, total_steps, workdir, faulted_rank=faulted_rank)
    )
    return check_invariants(report, checks)


def elastic_resize_invariants(
    nnodes: int, total_steps: int, disk_every: int, workdir: str,
) -> List[Invariant]:
    """The elastic-resize acceptance set: the completed world really
    changed N -> N-1 -> N, the cross-world restores came RESHARDED
    from the committed storage tier, every reported loss matches the
    uninterrupted control, per-restart step loss is bounded by the
    durable interval, the final step commits, the resize phase
    breakdown is on the timeline, and the goodput loss is booked under
    the resize cause, and the lead rank's sharded dataset stays
    exactly-once."""
    return [
        WorldSizeTrajectory([nnodes, nnodes - 1, nnodes]),
        EventRecorded("resize_decision", min_count=2),
        RestoredFromTier("storage"),
        LossTrajectoryMatches(resize_reference_losses(total_steps)),
        BoundedStepLossPerRestart(interval=disk_every),
        NoDuplicateShards(dataset_size=total_steps),
        FinalStepCommitted(),
        ResizePhasesOnTimeline(min_resizes=2),
        GoodputLossAttributed(
            min_attributed_frac=0.5, expect_cause=flight.CAUSE_RESIZE,
        ),
        # overlapping incarnations (old world draining while the new
        # world rendezvouses) must still each close their books
        GoodputConservation(),
        NoOrphanProcesses(marker=workdir),
    ]


def sparse_resize_invariants(
    nnodes: int, total_steps: int, disk_every: int, workdir: str,
) -> List[Invariant]:
    """The sparse elastic-resize acceptance set (reference
    ``harness.py:3534``): everything the dense resize proves about the
    world trajectory, the storage-tier reshard and the loss control,
    PLUS exactly-once redistribution of the hash-table rows across both
    world changes (kv digests additive across disjoint shards)."""
    return [
        WorldSizeTrajectory([nnodes, nnodes - 1, nnodes]),
        EventRecorded("resize_decision", min_count=2),
        RestoredFromTier("storage"),
        LossTrajectoryMatches(resize_reference_losses(total_steps)),
        BoundedStepLossPerRestart(interval=disk_every),
        KvReshardExactlyOnce(min_reshards=2),
        FinalStepCommitted(),
        GoodputConservation(),
        NoOrphanProcesses(marker=workdir),
    ]


def run_elastic_resize_scenario(
    scenario,
    workdir: str,
    nnodes: int = 2,
    min_nodes: int = 1,
    kill_rank: Optional[int] = None,
    total_steps: Optional[int] = None,
    disk_every: Optional[int] = None,
    max_restarts: int = 3,
    monitor_interval: float = 0.3,
    invariants: Optional[List[Invariant]] = None,
    rejoin_after_steps: int = 2,
    timeout: float = 240.0,
    respawn_master: bool = False,
) -> ChaosRunReport:
    """Drive the elastic world-resize churn: ``nnodes`` real launcher
    agents against a ``min_nodes``-floored master, ALL sharing one
    checkpoint directory (the shared filesystem that makes cross-node
    shard redistribution possible).  The scenario's ``kill_node`` rule
    takes one agent's whole supervision tree down mid-run; the master
    shrinks the world and the survivor reshards-restores.  Once the
    shrunken world has made ``rejoin_after_steps`` steps, the harness
    plays the cluster scheduler and starts a REPLACEMENT agent for the
    lost rank (fresh shm namespace, a new host, and
    ``DLROVER_AGENT_RESPAWNED=1`` so seeded rules never re-fire), which
    grows the world back.  With ``respawn_master`` the harness first
    SIGKILLs the master and respawns it on the same port and journal
    (``report.master_respawned_at``), so the grown world rendezvouses
    on the respawned master.  Invariants then decide everything from
    the telemetry event log."""
    from dlrover_tpu_torch.common.comm import find_free_port

    scenario = load_scenario(scenario)
    opts = RUN_OPTIONS.get(scenario.name, {})
    if total_steps is None:
        total_steps = int(opts.get("total_steps", 24))
    if disk_every is None:
        disk_every = int(opts.get("disk_every", 3))
    step_sleep = float(opts.get("step_sleep", 0.0))
    if kill_rank is None:
        kill_rank = nnodes - 1
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "chaos_scenario.json")
    with open(spec_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=2)
    script = os.path.join(workdir, "resize_train.py")
    with open(script, "w") as f:
        f.write(TRAIN_SCRIPTS[opts.get("train_script", "resize")])
    event_log = os.path.join(workdir, "events.jsonl")
    agent_event_glob = os.path.join(workdir, "events_node*.jsonl")
    ckpt_dir = os.path.join(workdir, "ckpt")  # SHARED across nodes
    base_env = _pkg_env(dict(
        os.environ,
        **{
            _chaos.CHAOS_ENV: spec_path,
            EVENT_LOG_ENV: event_log,
            EVENTS_AGGREGATE_ENV: agent_event_glob,
            TOTAL_STEPS_ENV: str(total_steps),
            DISK_EVERY_ENV: str(disk_every),
        },
    ))
    if step_sleep:
        base_env[STEP_SLEEP_ENV] = str(step_sleep)
    if opts.get("shard_dataset"):
        # the lead rank feeds one sample per shard, one shard per step
        base_env[SHARD_DATASET_ENV] = str(total_steps)
    shrunk_sleep = float(opts.get("shrunk_step_sleep", 0.0))
    if shrunk_sleep:
        base_env["DLROVER_CHAOS_NNODES"] = str(nnodes)
        base_env["DLROVER_CHAOS_SHRUNK_STEP_SLEEP"] = str(shrunk_sleep)
    base_env.update(opts.get("extra_env", {}))
    port = find_free_port()
    addr = f"127.0.0.1:{port}"
    master = _start_master(base_env, workdir, port, nnodes,
                           min_nodes=min_nodes)

    def agent_env(rank: int, respawn: bool) -> Dict[str, str]:
        # a respawned rank is a REPLACEMENT host: a fresh IPC/shm
        # namespace and the respawn marker protecting it from seeded
        # rules
        suffix = "b" if respawn else ""
        env = dict(
            base_env,
            DLROVER_MASTER_ADDR=addr,
            **{EVENT_LOG_ENV: os.path.join(
                workdir, f"events_node{rank}.jsonl")},
            DLROVER_NODE_RANK=str(rank),
            DLROVER_NODE_ID=str(rank),
            DLROVER_SHARED_DIR=os.path.join(workdir, f"sock{rank}{suffix}"),
            DLROVER_METRICS_FILE=os.path.join(
                workdir, f"metrics_{rank}{suffix}.json"),
        )
        if respawn:
            env["DLROVER_AGENT_RESPAWNED"] = "1"
        return env

    def spawn_agent(rank: int, respawn: bool, logs: List):
        out = open(os.path.join(
            workdir, f"agent{rank}{'_respawn' if respawn else ''}.log"),
            "w")
        logs.append(out)
        argv = [
            sys.executable, "-m", "dlrover_tpu_torch.run",
            "--nnodes", f"{min_nodes}:{nnodes}",
            "--nproc_per_node", "1",
            f"--max_restarts={max_restarts}",
            f"--monitor_interval={monitor_interval}",
            "--node_rank", str(rank),
            script, ckpt_dir,
        ]
        return subprocess.Popen(  # noqa: S603
            argv, env=agent_env(rank, respawn),
            stdout=out, stderr=subprocess.STDOUT,
        )

    def shrunken_world_stepping() -> bool:
        """The respawn trigger, from the event log alone: the world
        reconverged at nnodes-1 AND made rejoin_after_steps steps since
        (replacement capacity arriving mid-recovery would race the
        shrink and prove nothing)."""
        try:
            ev = collect_events([event_log, agent_event_glob])
        except Exception:  # noqa: BLE001 - torn mid-write reads retry
            return False
        round_ts = None
        for e in ev:
            if (
                e.get("type") == "rendezvous_complete"
                and e.get("rdzv") == "elastic-training"
                and len(e.get("nodes") or []) == nnodes - 1
            ):
                round_ts = e["ts"]
                break
        if round_ts is None:
            return False
        later = [e for e in ev
                 if e.get("type") == "train_step" and e["ts"] > round_ts]
        return len(later) >= rejoin_after_steps

    agents: Dict[int, subprocess.Popen] = {}
    logs: List = []
    rc = 0
    respawned = False
    master_respawned_at = None
    try:
        for rank in range(nnodes):
            agents[rank] = spawn_agent(rank, respawn=False, logs=logs)
        deadline = time.time() + timeout
        while time.time() < deadline:
            states = {r: p.poll() for r, p in agents.items()}
            if not respawned and states.get(kill_rank) is not None:
                if shrunken_world_stepping():
                    if respawn_master:
                        # the master dies between the shrink and the
                        # grow; the grown world must rendezvous on its
                        # respawn (same port, same journal)
                        master.send_signal(signal.SIGKILL)
                        master.wait()
                        master_respawned_at = time.time()
                        master = _start_master(
                            base_env, workdir, port, nnodes,
                            min_nodes=min_nodes, restart_count=1)
                    logger.info(
                        "shrunken world is stepping; respawning "
                        "replacement agent for rank %s", kill_rank,
                    )
                    agents[kill_rank] = spawn_agent(
                        kill_rank, respawn=True, logs=logs)
                    respawned = True
            elif all(st is not None for st in states.values()):
                if respawned or states.get(kill_rank) is None:
                    break
            time.sleep(0.3)
        else:
            rc = 124  # deadline: kill whatever is left
        for p in agents.values():
            if p.poll() is None and rc == 124:
                p.kill()
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = rc or 124
        if not respawned:
            rc = rc or 125  # the churn never completed its arc
        for p in agents.values():
            # the killed rank's FIRST incarnation legitimately dies
            # non-zero; every final incarnation must succeed
            rc = rc or (p.returncode or 0)
    finally:
        for p in agents.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        _stop_master(master)
        for out in logs:
            out.close()

    report = _build_report(scenario, rc, workdir, event_log,
                           extra_sources=[agent_event_glob])
    report.master_respawned_at = master_respawned_at
    default_set = (
        sparse_resize_invariants
        if opts.get("train_script") == "sparse_resize"
        else elastic_resize_invariants
    )
    checks = (
        invariants if invariants is not None
        else default_set(nnodes, total_steps, disk_every, workdir)
    )
    return check_invariants(report, checks)
