"""Registry of every known training-event type and its fields.

Copy of ``dlrover_tpu/telemetry/schema.py`` (the port imports nothing of the JAX
package).

Four PRs of instrumentation made the JSONL event log the substrate
that chaos invariants, the timeline assembler and the goodput
diagnosis all decide from — which means a silently forked schema
(a renamed field, an unregistered type) breaks *verification*, not
just dashboards.  This module is the single source of truth:

- :data:`EVENT_SCHEMAS` lists every event type with its required and
  optional fields;
- :func:`validate_event` checks one recorded event dict;
- :func:`validate_call` checks one ``emit_event`` call site (the AST
  scanner in :mod:`dlrover_tpu_torch.telemetry.check_events` feeds it).

New instrumentation MUST register its event type here; the tier-1
schema checker fails otherwise.
"""

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence

# envelope stamped by TrainingEventExporter.emit on every record
COMMON_FIELDS: FrozenSet[str] = frozenset(
    {"schema", "ts", "pid", "source", "type"}
)


@dataclass(frozen=True)
class EventSchema:
    type: str
    required: FrozenSet[str]
    optional: FrozenSet[str] = frozenset()
    # events whose payload is an open phase/stat dict (e.g. the
    # checkpoint engine's per-stage timings) accept extra fields
    allow_extra: bool = False

    @property
    def known(self) -> FrozenSet[str]:
        return self.required | self.optional | COMMON_FIELDS


def _s(
    type_: str,
    required: Sequence[str],
    optional: Sequence[str] = (),
    allow_extra: bool = False,
) -> EventSchema:
    return EventSchema(
        type_, frozenset(required), frozenset(optional), allow_extra
    )


EVENT_SCHEMAS: Dict[str, EventSchema] = {
    s.type: s
    for s in (
        # -- telemetry core ------------------------------------------
        _s("span", [
            "name", "trace_id", "span_id", "parent_id",
            "duration_s", "status", "attributes",
        ]),
        # -- master lifecycle ----------------------------------------
        _s("master_start", ["job", "port", "node_num", "metrics_port"]),
        _s("master_exit", [
            "job", "rc", "exit_reason", "global_step", "goodput",
            "recoveries",
        ]),
        _s("master_recovered",
           ["job", "incarnation", "recoveries", "rdzv_round"],
           ["entries", "applied", "requeued", "snapshot", "truncated",
            "from_mirror"]),
        _s("master_respawn", ["port", "respawn", "rc"]),
        _s("journal_replay", [
            "dir", "entries", "snapshot_seq", "last_seq", "truncated",
        ]),
        # -- rendezvous / sharding -----------------------------------
        _s("rendezvous_complete", ["rdzv", "round", "nodes", "wait_s"]),
        _s("shard_dispatch",
           ["dataset", "task_id", "worker", "start", "end"]),
        _s("shard_ack",
           ["dataset", "task_id", "success", "start", "end", "worker"]),
        # -- session resync (master crash recovery) ------------------
        _s("agent_resync", [
            "node_id", "node_rank", "restart_count", "last_step",
            "last_acked_dataset", "last_acked_task",
        ]),
        _s("master_resync", [
            "node_id", "incarnation", "recoveries", "rdzv_round",
            "master_changed", "last_step",
        ]),
        # -- trainer -------------------------------------------------
        # loss rides along when the step loop reported it: the
        # elastic-resize loss-trajectory invariant compares same-step
        # losses across incarnations/world sizes from the log alone
        _s("train_step", ["step", "restart_count", "node_rank"],
           ["loss"]),
        _s("loss_spike", ["step", "loss", "ema", "factor"]),
        # per-step phase breakdown from the always-on profiler
        # (open dict: data_wait / h2d / compute / checkpoint /
        # report / other_s / total_s, arbitrary user phases allowed)
        _s("step_phases", ["step", "node_rank"], allow_extra=True),
        # one completed PPO iteration of the elastic RL loop: the
        # measured phase seconds (rollout / score / gae / train) give
        # the timeline its RL phase slices, so recovery losses book
        # against real iteration anatomy instead of a flat gap
        _s("rl_iteration", ["iteration", "restart_count", "node_rank"],
           ["leases", "rollout_s", "score_s", "gae_s", "train_s",
            "actor_loss", "critic_loss"]),
        # -- checkpoint (open phase dicts: stage timings vary) -------
        # paged shm tier (DLROVER_SHM_PAGED): paged=True saves carry
        # kind (base/delta), the published generation, pages_written,
        # bytes moved vs bytes_skipped (copy-skip) vs bytes_total,
        # kv_bytes (the sparse page blob), and the compare/kv/publish
        # stage seconds next to the flat path's fetch/memcpy ones
        _s("checkpoint_shm_save", ["step", "rank"],
           ["paged", "kind", "generation", "pages_written",
            "bytes", "bytes_skipped", "bytes_total", "kv_bytes",
            "fetch_s", "compare_s", "memcpy_s", "kv_s", "publish_s",
            "lock_wait_s", "total_s"],
           allow_extra=True),
        _s("checkpoint_restore", ["step", "tier", "rank"],
           allow_extra=True),
        _s("checkpoint_persist", ["step", "ok", "seconds"]),
        _s("checkpoint_commit", ["step"]),
        # sparse (KvVariable) state riding the flash checkpoint:
        # stage=export on every save, stage=restore on every import;
        # resharded restores carry exactly-once accounting
        # (rows = imported subset, total_rows = distinct union across
        # the old world) and per-table content digests when
        # DLROVER_KV_DIGEST is armed (order-independent, additive
        # across disjoint shards — the chaos invariants' raw material)
        _s("kv_checkpoint",
           ["stage", "rows", "bytes"],
           ["step", "rank", "tier", "seconds", "tables",
            "spilled_rows", "spill_disabled", "lost_rows",
            "resharded", "from_world", "world_size", "total_rows",
            "digests",
            # dirty-row delta exports (serving plane): delta=True
            # marks an export of only the rows touched since the
            # last cleared delta (dead_rows = eviction tombstones,
            # table_rows = logical table size for the delta ratio)
            "delta", "dead_rows", "table_rows",
            # streaming reshard (bounded-memory cross-world
            # restore): streamed=True, chunks = windows applied,
            # window_rows = the configured window
            "streamed", "chunks", "window_rows",
            # delta flash checkpoints (hot save path): kind =
            # base/delta for the CHECKPOINT consumer, with the
            # chain link steps a restore replays
            "kind", "consumer", "base_step", "parent_step",
            "chain_len"]),
        # one window of a streaming reshard applied: rows = input
        # rows partitioned in this window, owned = the subset this
        # rank imported; the mid-reshard kill scenario counts these
        # to prove the replayed reshard re-ran from the top
        _s("kv_reshard_chunk",
           ["table", "chunk", "rows", "owned", "rank"],
           ["step"]),
        # -- serving plane (train-to-serve publication) --------------
        # one committed generation published by the trainer: kind =
        # base (full snapshot) or delta (dirty rows + tombstones);
        # emitted AFTER the tracker advance, so per-generation
        # exactly-once publication is countable from the log; tables
        # carries the per-table content digests the ingest must match
        _s("serving_publish",
           ["generation", "kind", "rows", "bytes", "seconds"],
           ["step", "dead_rows", "delta_ratio", "tables"]),
        # one generation applied on a replica, emitted only after the
        # FULL apply under the swap lock — its digests (restated from
        # the verified manifest) tie it to the matching publish: a
        # torn or uncommitted generation can never produce this event
        _s("serving_ingest",
           ["generation", "kind", "rows", "seconds"],
           ["step", "dead_rows", "bytes", "freshness_s", "respawned",
            "tables"]),
        # train-commit -> servable latency of the generation now
        # being served, after each catch-up
        _s("serving_freshness",
           ["generation", "freshness_s"],
           ["step", "lag_generations", "respawned"]),
        # periodic lookup-traffic sample from the replica process:
        # latency percentiles + throughput under (possibly) live
        # ingest, tagged with the served generation
        # ``replica`` is the reporting side: a pool member's id, or
        # "load" for the fleet harness's client-side aggregate (which
        # adds ``failed``/``streams`` — the zero-client-visible-
        # failure half of the fleet chaos verdict)
        _s("serving_lookup_stats",
           ["count", "p50_ms", "p99_ms", "qps", "window_s"],
           ["rows", "generation", "replica", "failed", "streams"]),
        # -- serving fleet (replica pool + lookup router) ------------
        # one routed-traffic window from the lookup router: outcome
        # counts (ok / rerouted / stale / failed — the zero-failure
        # and zero-stale invariants count these), shared-estimator
        # p50/p99 over the window's bucket deltas, pool composition
        # and the newest admitted generation (the freshness floor)
        _s("serving_route",
           ["count", "qps", "window_s", "generation_floor", "ok",
            "rerouted", "stale", "failed", "members_up"],
           ["p50_ms", "p99_ms", "members_draining",
            "members_suspect", "hedged"]),
        # routing-table state transition for one pool member: state =
        # joined / admitted / draining / suspect / lost / recovered /
        # removed; emitted on CHANGE only (heartbeats are silent), so
        # shed/admit latency and membership history read from the log
        _s("replica_status",
           ["replica_id", "generation", "state"],
           ["addr", "draining", "respawned", "target_generation"]),
        # -- agent ---------------------------------------------------
        # reason: failure / membership / hang / resize — what drove
        # this restart (resize restarts are planned drains)
        _s("worker_restart", ["node_rank", "restart_count"],
           ["reason"]),
        # restore prefetch hint: agent paged the shm snapshot in
        # while the replacement trainer was importing
        _s("shm_prefetch", ["bytes", "seconds"],
           ["segments", "restart_count"]),
        # measured death->first-step budget, one event per phase
        # (spawn / import / restore / aot / retrace / first_step) —
        # the trainer-side RecoveryProfiler emits them and the
        # timeline derives the recovery breakdown slices.  `aot` is
        # the AOT executable cache resolve: deserialize+link on a
        # HIT (retrace collapses to 0), entry write on a MISS
        _s("recovery_phase", ["phase", "seconds", "restart_count"],
           ["node_rank"]),
        # persistent-compile-cache witness around the first
        # post-restore step: hit = no new cache entries over a warm
        # dir (the retrace-elimination invariant's raw material);
        # status distinguishes aot-hit / xla-cache-hit / cold and
        # aot_entries counts the serialized-executable half
        _s("compile_cache", ["hit", "restart_count"],
           ["entries_before", "entries_after", "retrace_s", "dir",
            "node_rank", "status", "aot_entries",
            # port only: the nvcc seconds of the bracketed first step
            # (a cold witness's build)
            "build_s"]),
        # AOT executable cache resolve: hit = the compiled step was
        # DESERIALIZED (no trace); a miss carries the measured
        # trace_s and whether the entry was written so incarnation
        # N+1 hits; wait_s = what the critical path stalled when the
        # resolve ran on the overlap thread; overlapped_restore =
        # the async restore was still reading when it finished
        _s("aot_cache", ["hit", "restart_count"],
           ["resolution", "key", "dir", "wrote", "preloaded",
            "seconds",
            "load_s", "trace_s", "save_s", "wait_s", "entries",
            "reason", "overlapped_restore", "node_rank", "fast",
            "read_s", "unpickle_s", "deserialize_s",
            "deserialize_cpu_s",
            # port only: the kernel libraries the entry lists, and
            # whether every one was loaded before the resolve (by the
            # forkserver template, inherited over the fork)
            "libraries", "libraries_preloaded"]),
        # master journal mirrored to the checkpoint storage tier
        # (async group commit): how far the mirror lagged when a
        # batch flushed — the host-portable control plane's witness
        _s("journal_mirror_flush", ["records", "lag_s"],
           ["dir"]),
        _s("warm_fork_fallback", [
            "node_rank", "local_rank", "restart_count", "reason",
        ]),
        # the port's probe adds its own numbers as optional fields
        # (agent/node_check.py): the reference's event has the first
        # three
        _s("node_check", ["round", "elapsed_s", "world_size"],
           ["matmul_s", "matmul_size", "matmul_flops", "collective_s"]),
        # -- diagnosis / chaos ---------------------------------------
        _s("diagnosis_verdict",
           ["hung", "action", "culprit_node", "reason"],
           # actionable-verdict fields: classification,
           # measured stall/excess durations (the timeline's real
           # claim windows) and the evidence excerpt
           ["verdict", "stall_s", "duration_s", "evidence"]),
        # agent watchdog hang flight data: measured stall + captured
        # stacks + /proc state of the worker tree
        _s("hang_evidence",
           ["node_rank", "stall_s", "last_step"],
           ["stacks", "workers"]),
        # control-plane SLO breach onset (per-verb RPC latency
        # quantile over its declared bound)
        _s("rpc_slo_breach",
           ["verb", "quantile", "threshold_s", "observed_s"],
           ["count"]),
        _s("chaos_inject", [
            "scenario", "seed", "seq", "point", "rule", "action",
            "step", "node_rank",
        ]),
        # -- elastic world-resize ------------------------------------
        # the coordinator's journaled decision (target world size,
        # why, what it decided from); detected_ts = the lost node's
        # last sign of life, so the timeline's decide phase covers
        # the real outage
        _s("resize_decision",
           ["target", "from_world", "reason", "round"],
           ["detected_ts"]),
        # master-observed resize phase completions (rendezvous /
        # first_step); drain and reshard-restore are derived on the
        # assembled timeline from worker_restart/checkpoint_restore
        _s("resize_phase", ["phase", "seconds", "target"]),
        # -- flight recorder -----------------------------------------
        _s("goodput_attribution", [
            "window_start", "window_end", "window_s", "training_s",
            "loss_s", "goodput", "buckets",
        ]),
        # periodic goodput-ledger summary published by the master's
        # ledger service (per-category seconds live in the open dict)
        _s("goodput_ledger",
           ["goodput", "attributed_pct", "incarnations", "window_s"],
           ["top_loss_cause", "wall_s", "totals"]),
        # ledger-derived goodput vs the SpeedMonitor's step-gap ratio
        # drifted past the cross-check tolerance (1%)
        _s("goodput_divergence", ["ledger", "monitor", "divergence"]),
        # event-log rotation could not take the advisory lock and fell
        # back to best-effort rotation (possible concurrent rotator)
        _s("telemetry_rotate_contended", ["path"]),
        # -- fleet observatory ---------------------------------------
        # periodic control-plane scoreboard sample under synthetic
        # fleet load: windowed per-verb latency view + fan-in gauges
        # (open dict: the verbs payload varies with the traffic mix)
        _s("fleet_report", ["agents", "rps", "window_s"],
           allow_extra=True),
        # SLO-green capacity search result: the max agent count one
        # master sustained with every windowed rule green
        _s("fleet_capacity",
           ["max_sustained_agents"],
           ["rps_at_capacity", "levels", "search_s",
            "first_breach_agents"]),
        # -- port only -----------------------------------------------
        # the elastic resize loop's gloo group, emitted once per
        # incarnation by the torch twin of the resize train script
        # (chaos/scenarios.py RESIZE_TRAIN_SCRIPT): the reference's
        # GSPMD loop forms no process group, so its schema lacks the
        # type; it witnesses which rendezvous address a round handed
        # out after a master respawn (ROADMAP C 3)
        _s("process_group",
           ["world_size", "rank", "coordinator", "node_rank",
            "restart_count"]),
    )
}


def validate_event(record: Dict) -> List[str]:
    """Problems with one recorded event dict (empty = valid)."""
    problems: List[str] = []
    etype = record.get("type")
    if not isinstance(etype, str) or not etype:
        return ["event record has no 'type'"]
    schema = EVENT_SCHEMAS.get(etype)
    if schema is None:
        return [f"unregistered event type {etype!r}"]
    missing = schema.required - set(record)
    if missing:
        problems.append(
            f"{etype}: missing required field(s) {sorted(missing)}"
        )
    if not schema.allow_extra:
        extra = set(record) - schema.known
        if extra:
            problems.append(
                f"{etype}: unregistered field(s) {sorted(extra)}"
            )
    return problems


def validate_call(
    event_type: str,
    kwarg_names: Sequence[str],
    has_dynamic: bool = False,
    where: str = "",
) -> List[str]:
    """Problems with one ``emit_event(type, ...)`` call site.

    ``has_dynamic`` marks a ``**kwargs`` expansion at the site: the
    literal keywords are still checked against the registry, but
    required-field completeness cannot be decided statically and is
    left to the recorded-log check."""
    loc = f" at {where}" if where else ""
    schema = EVENT_SCHEMAS.get(event_type)
    if schema is None:
        return [f"unregistered event type {event_type!r}{loc}"]
    problems: List[str] = []
    names = set(kwarg_names)
    if not schema.allow_extra:
        drift = names - schema.required - schema.optional
        if drift:
            problems.append(
                f"{event_type}: unregistered field(s) "
                f"{sorted(drift)}{loc}"
            )
    if not has_dynamic:
        missing = schema.required - names
        if missing:
            problems.append(
                f"{event_type}: call omits required field(s) "
                f"{sorted(missing)}{loc}"
            )
    return problems
