"""Per-job master objects.

Copy of ``dlrover_tpu/master/master.py`` (the port imports nothing of
the JAX package).

Role of ``dlrover/python/master/local_master.py`` +
``dist_master.py``: owns every master subcomponent (job manager, both
rendezvous managers, task manager, speed monitor, KV store, request
server) and a main loop that polls for exit/hang conditions every 30 s
(reference ``dist_master.py:211``).  ``LocalJobMaster`` is what
``tpurun`` spawns on node rank 0 when no external master exists; the
scheduler-backed distributed flavour adds node watching/scaling on top
(see :mod:`dlrover_tpu_torch.master.node_manager`).
"""

import os
import threading
import time
import uuid
from typing import Optional

from dlrover_tpu_torch.common.comm import MessageServer, find_free_port
from dlrover_tpu_torch.common.constants import (
    ErrorMonitorConstants,
    JobExitReason,
    MasterAction,
    RendezvousName,
)
from dlrover_tpu_torch.common.env_utils import _get_float as _env_float
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.diagnosis import DiagnosisManager
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.journal import JOURNAL_DIR_ENV, StateJournal
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.recovery import capture_snapshot, restore_master
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager
from dlrover_tpu_torch.telemetry.events import emit_event, set_event_source
from dlrover_tpu_torch.telemetry.exporter import (
    METRICS_AGGREGATE_ENV,
    METRICS_PORT_ENV,
    PrometheusEndpoint,
)
from dlrover_tpu_torch.telemetry.gcp_monitoring import (
    maybe_from_env as gcp_from_env,
)
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.telemetry.otlp import maybe_from_env as otlp_from_env
from dlrover_tpu_torch.telemetry.slo import SloChecker

_RECOVERIES_TOTAL = get_registry().counter(
    "dlrover_master_recoveries_total",
    "Master crash recoveries (journal replays into a respawned "
    "master)",
)
_BRAIN_INGESTS_TOTAL = get_registry().counter(
    "dlrover_brain_ingests_total",
    "Automatic event-log ingests into the Brain datastore from the "
    "master run loop",
)

# Brain auto-feed: DLROVER_BRAIN_DB points the master at a sqlite
# Brain datastore — every ingest interval the run loop ships the
# job's event logs (goodput attribution + diagnosis verdicts) plus a
# live throughput snapshot into it, making the Brain a standing
# optimizer fed continuously instead of a per-job afterthought.
# DLROVER_BRAIN_RESIZE additionally wires the Brain's throughput
# heuristic into the ResizeCoordinator as a decision source.
BRAIN_DB_ENV = "DLROVER_BRAIN_DB"
BRAIN_INGEST_INTERVAL_ENV = "DLROVER_BRAIN_INGEST_INTERVAL_S"
BRAIN_RESIZE_ENV = "DLROVER_BRAIN_RESIZE"
GOODPUT_LEDGER_INTERVAL_ENV = "DLROVER_GOODPUT_LEDGER_INTERVAL_S"


class JobMaster:
    def __init__(
        self,
        port: int = 0,
        node_num: int = 1,
        job_name: str = "local-job",
        coordinator_port: int = 0,
        job_manager: Optional[JobManager] = None,
        journal_dir: Optional[str] = None,
        min_node_num: Optional[int] = None,
        node_unit: int = 1,
    ):
        self.job_name = job_name
        self.node_num = node_num
        # elastic floor: min_node_num < node_num arms the resize
        # coordinator — the job survives capacity loss by training
        # smaller instead of waiting for a replacement (env
        # DLROVER_MIN_NODES when not passed)
        if min_node_num is None:
            try:
                min_node_num = int(
                    os.getenv("DLROVER_MIN_NODES", "") or node_num
                )
            except ValueError:
                min_node_num = node_num
        self.min_node_num = max(1, min(min_node_num, node_num))
        self.node_unit = max(1, node_unit)
        # a fresh id per master PROCESS: agents compare it across
        # session resyncs to detect that a recovery happened
        self.incarnation = uuid.uuid4().hex[:12]
        self.recoveries = 0
        set_event_source("master")
        self.speed_monitor = SpeedMonitor()
        self.diagnosis_manager = DiagnosisManager()
        self._last_straggler_warned = -1
        # hang-verdict restart budget per culprit node: beyond it the
        # hang escalates to the job-abort path (a node that hangs
        # every incarnation is broken, not unlucky)
        self._hang_restarts: dict = {}
        # consecutive hung polls with NO identified culprit: the
        # silence rule can fire a beat before the agents' stack
        # evidence arrives, and aborting the whole job in that beat
        # would waste the targeted-restart machinery — give the
        # evidence a few polls to land before escalating
        self._culpritless_hangs = 0
        # control-plane latency SLOs evaluated every poll over the
        # per-verb dlrover_rpc_seconds histograms; breaches surface
        # as gauges on /metrics + rpc_slo_breach events in the
        # incident report
        self.slo_checker = SloChecker()
        # platform-backed masters inject a DistributedJobManager
        # (node watching/scaling); local mode uses the plain one
        self.job_manager = job_manager or JobManager()
        self.aux_services = []  # started in prepare(), stopped in stop()
        self.task_manager = TaskManager()
        self.kv_store = KVStoreService()
        self.elastic_rdzv = ElasticTrainingRendezvousManager()
        self.network_rdzv = NetworkCheckRendezvousManager()
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING: self.elastic_rdzv,
            RendezvousName.NETWORK_CHECK: self.network_rdzv,
        }
        coordinator_port = coordinator_port or find_free_port()
        for mngr in self.rdzv_managers.values():
            mngr.update_rdzv_params(
                min_nodes=self.min_node_num, max_nodes=node_num,
                node_unit=self.node_unit,
            )
            mngr.set_coordinator_port(coordinator_port)
        # node-event callbacks (reference: event_callback.py objects)
        from dlrover_tpu_torch.master.event_callback import (
            AllReduceNodeHandlingCallback,
            TaskRescheduleCallback,
        )

        self.job_manager.add_event_callback(
            TaskRescheduleCallback(self.task_manager)
        )
        self.job_manager.add_event_callback(
            AllReduceNodeHandlingCallback(
                self.elastic_rdzv, self.speed_monitor
            )
        )
        self.servicer = MasterServicer(
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            speed_monitor=self.speed_monitor,
        )
        # elastic world-resize: decides a new target from alive-node
        # counts / operator requests and drains survivors over the
        # heartbeat-action channel (journal attached below so a crash
        # mid-resize replays the decision)
        from dlrover_tpu_torch.master.auto_scaler import ResizeCoordinator

        self.resize_coordinator = ResizeCoordinator(
            self.elastic_rdzv,
            self.job_manager,
            self.speed_monitor,
            self.servicer,
            min_nodes=self.min_node_num,
            max_nodes=node_num,
            node_unit=self.node_unit,
        )
        self.servicer.resize_coordinator = self.resize_coordinator
        # -- Brain auto-feed (standing cluster optimizer) --------------
        self.brain_store = None
        self.brain = None
        self._brain_ingest_interval = _env_float(
            BRAIN_INGEST_INTERVAL_ENV, 30.0
        )
        self._last_brain_ingest = 0.0
        brain_db = os.getenv(BRAIN_DB_ENV, "")
        if brain_db:
            try:
                from dlrover_tpu_torch.brain.datastore import (
                    SqliteJobMetricsStore,
                )
                from dlrover_tpu_torch.brain.service import BrainService

                self.brain_store = SqliteJobMetricsStore(brain_db)
                self.brain = BrainService(
                    self.brain_store, job_name=self.job_name
                )
                if os.getenv(BRAIN_RESIZE_ENV, "").strip().lower() in (
                    "1", "true", "yes", "on"
                ):
                    self.resize_coordinator.set_brain(self.brain)
                logger.info(
                    "brain datastore %s armed (ingest every %.0fs%s)",
                    brain_db, self._brain_ingest_interval,
                    ", resize decision source on"
                    if self.resize_coordinator._brain is not None
                    else "",
                )
            except Exception:  # noqa: BLE001 - an optimizer feed
                logger.exception(  # must never kill the master
                    "brain datastore %s unusable; auto-ingest off",
                    brain_db,
                )
                self.brain_store = None
                self.brain = None
        # -- goodput ledger (causal wall-clock attribution) ------------
        self.goodput_ledger = None
        ledger_interval = _env_float(
            GOODPUT_LEDGER_INTERVAL_ENV, 30.0
        )
        if ledger_interval > 0:
            try:
                from dlrover_tpu_torch.master.goodput_ledger import (
                    GoodputLedgerService,
                )

                self.goodput_ledger = GoodputLedgerService(
                    speed_monitor=self.speed_monitor,
                    interval=ledger_interval,
                )
            except Exception:  # noqa: BLE001 - accounting must
                logger.exception(  # never kill the master
                    "goodput ledger service unavailable"
                )
        # -- crash recovery: state journal + replay --------------------
        self.journal: Optional[StateJournal] = None
        jdir = journal_dir or os.getenv(JOURNAL_DIR_ENV, "")
        if jdir:
            self.journal = StateJournal(jdir)
            replayed = self.journal.recovered
            if replayed.has_state:
                stats = restore_master(self, replayed)
                self.recoveries += 1
                _RECOVERIES_TOTAL.inc()
                emit_event(
                    "master_recovered",
                    job=self.job_name,
                    incarnation=self.incarnation,
                    recoveries=self.recoveries,
                    rdzv_round=self.elastic_rdzv.current_round(),
                    # a fresh local dir seeded from the storage-tier
                    # mirror = the different-host respawn path; the
                    # chaos invariant reads this field
                    from_mirror=self.journal.seeded_from_mirror,
                    **stats,
                )
                logger.warning(
                    "master recovered from journal %s%s: %s entries "
                    "(%s re-queued shard leases), rdzv round %s, "
                    "recovery #%s",
                    jdir,
                    " (seeded from mirror)"
                    if self.journal.seeded_from_mirror else "",
                    stats["entries"], stats["requeued"],
                    self.elastic_rdzv.current_round(),
                    self.recoveries,
                )
            # attach AFTER replay so replayed mutations don't
            # re-journal, then fold everything into a fresh snapshot
            self.task_manager.journal = self.journal
            self.job_manager.journal = self.journal
            self.servicer.journal = self.journal
            self.resize_coordinator.journal = self.journal
            for mngr in self.rdzv_managers.values():
                mngr.on_round_complete = self._journal_rdzv_round
            # check RESULTS are journaled too, not just membership —
            # a mid-check master crash must not lose reports that
            # already arrived (ROADMAP master fault-tolerance
            # follow-on)
            self.network_rdzv.on_status_report = (
                self._journal_netcheck_status
            )
            self._snapshot_journal()
        self.servicer.incarnation = self.incarnation
        self.servicer.recoveries = self.recoveries
        self._server = MessageServer(port, self.servicer)
        self.port = self._server.port
        # one scrape of the master covers the whole job's
        # control-plane view; DLROVER_METRICS_PORT enables it
        # ("0" = ephemeral port, read back from .metrics_port)
        self.metrics_endpoint: Optional[PrometheusEndpoint] = None
        self.metrics_port = 0
        metrics_port = os.getenv(METRICS_PORT_ENV)
        if metrics_port is not None:
            try:
                self.metrics_endpoint = PrometheusEndpoint(
                    port=int(metrics_port),
                    # fold agent textfile dumps into every scrape so
                    # one master scrape covers worker-side metrics
                    aggregate_glob=os.getenv(
                        METRICS_AGGREGATE_ENV, ""
                    ),
                )
                self.aux_services.append(self.metrics_endpoint)
            except ValueError:
                logger.warning(
                    "invalid %s=%r; metrics endpoint disabled",
                    METRICS_PORT_ENV, metrics_port,
                )
        # OTLP push export (spans + metrics) to a collector when
        # DLROVER_OTLP_ENDPOINT is set — same aux-service lifecycle
        # as the scrape endpoint, zero instrumentation-site changes
        otlp = otlp_from_env(service_name="dlrover_tpu_torch.master")
        if otlp is not None:
            self.aux_services.append(otlp)
        # GCP-native sink behind the same interfaces (Cloud
        # Monitoring metrics + Cloud Trace spans) when
        # DLROVER_GCP_PROJECT is set; can run alongside OTLP
        gcp = gcp_from_env()
        if gcp is not None:
            self.aux_services.append(gcp)
        self._stop = threading.Event()
        self._exit_code = 0
        self._run_thread: Optional[threading.Thread] = None

    def _snapshot_journal(self):
        """Fold current state into a snapshot.  The seq is read
        BEFORE capture: a mutation journaled while the capture walks
        the managers keeps its record through the rotation and is
        re-applied (idempotently) at replay — raced mutations may be
        double-applied, never lost."""
        seq = self.journal.last_seq
        self.journal.snapshot(capture_snapshot(self), seq=seq)

    def _journal_rdzv_round(self, name, round_, participants):
        if self.journal is not None:
            self.journal.append(
                "rdzv",
                {
                    "name": name,
                    "round": round_,
                    "participants": participants,
                },
            )

    def _journal_netcheck_status(
        self, node_id, normal, elapsed, round_
    ):
        if self.journal is not None:
            self.journal.append(
                "netcheck_status",
                {
                    "node_id": node_id,
                    "normal": normal,
                    "elapsed": elapsed,
                    "round": round_,
                },
            )

    def maybe_brain_ingest(self, now: Optional[float] = None) -> bool:
        """Feed the Brain datastore on a cadence: ship the job's
        event logs through :func:`cluster_monitor.ingest_job_events`
        (goodput attribution + diagnosis verdicts) and persist a live
        (workers, samples/sec) throughput snapshot — the raw material
        of the Brain's worker-plan heuristic.  Called from the run
        loop every poll (previously ``ingest_job_events`` existed but
        nothing ever called it automatically); safe to call from any
        single thread.  Returns True when an ingest ran."""
        if self.brain_store is None:
            return False
        now = now or time.time()
        if now - self._last_brain_ingest < self._brain_ingest_interval:
            return False
        self._last_brain_ingest = now
        from dlrover_tpu_torch.brain import cluster_monitor as _cm
        from dlrover_tpu_torch.telemetry import timeline as _timeline

        try:
            _cm.record_throughput_snapshot(
                self.brain_store,
                self.job_name,
                workers=self.elastic_rdzv.latest_world_size(),
                samples_per_sec=(
                    self.speed_monitor.samples_per_second()
                    or self.speed_monitor.running_speed()
                ),
                global_step=self.speed_monitor.completed_global_step,
                timestamp=now,
            )
            _cm.ingest_job_events(
                self.brain_store,
                self.job_name,
                _timeline.default_sources(),
            )
            _BRAIN_INGESTS_TOTAL.inc()
            return True
        except Exception:  # noqa: BLE001 - the optimizer feed must
            logger.exception("brain ingest failed")  # not kill us
            return False

    def maybe_goodput_ledger(
        self, now: Optional[float] = None, force: bool = False
    ) -> bool:
        """Throttled goodput-ledger tick: re-assemble the attribution
        from the event logs, publish the category counters, and
        re-derive ``SpeedMonitor.goodput()``.  Accounting must never
        kill the master."""
        if self.goodput_ledger is None:
            return False
        try:
            if force:
                return self.goodput_ledger.tick(now)
            return self.goodput_ledger.maybe_tick(now)
        except Exception:  # noqa: BLE001
            logger.exception("goodput ledger tick failed")
            return False

    def update_rdzv_params(
        self, min_nodes: int, max_nodes: int, node_unit: int = 1
    ):
        for mngr in self.rdzv_managers.values():
            mngr.update_rdzv_params(
                min_nodes=min_nodes, max_nodes=max_nodes, node_unit=node_unit
            )
        self.resize_coordinator.min_nodes = max(1, min_nodes)
        self.resize_coordinator.max_nodes = max(min_nodes, max_nodes)
        self.resize_coordinator.node_unit = max(1, node_unit)

    def prepare(self):
        self.task_manager.start()
        if hasattr(self.job_manager, "start"):
            self.job_manager.start()  # distributed: watcher + pods
        self.job_manager.start_heartbeat_monitor()
        for svc in self.aux_services:
            svc.start()
        if self.metrics_endpoint is not None:
            self.metrics_port = self.metrics_endpoint.port
        self._server.start()
        emit_event(
            "master_start", job=self.job_name, port=self.port,
            node_num=self.node_num, metrics_port=self.metrics_port,
        )
        logger.info(
            "master %s serving on port %s for %d node(s)",
            self.job_name,
            self.port,
            self.node_num,
        )

    def _poll_ticks(self, period: float):
        """One tick every ``period`` seconds until the master stops.
        The wait on the stop event wakes at least once a second: waits
        of the whole period (30 s by default) left a supervisor's
        SIGTERM unanswered past its 10 s grace on a loaded host."""
        deadline = time.monotonic() + period
        while not self._stop.wait(
                min(1.0, max(0.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                deadline = time.monotonic() + period
                yield

    def run(self) -> int:
        """Main poll loop (reference ``dist_master.py:211``)."""
        ctx = Context.instance()
        try:
            if self.job_manager.job_exit_reason:
                # a journaled terminal decision from the previous
                # incarnation: honor it instead of resurrecting the job
                logger.info(
                    "journaled job exit decision honored: %s",
                    self.job_manager.job_exit_reason,
                )
                if self.job_manager.job_exit_reason != (
                    JobExitReason.SUCCEEDED
                ):
                    self._exit_code = 1
                return self._exit_code
            for _ in self._poll_ticks(ctx.seconds_to_check_hang):
                if (
                    self.journal is not None
                    and self.journal.entries_since_snapshot
                    >= self.journal.snapshot_every
                ):
                    self._snapshot_journal()
                if self.servicer.exit_requested:
                    logger.info(
                        "job exit requested: %s", self.servicer.exit_requested
                    )
                    break
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self.job_manager.job_exit_reason = (
                            JobExitReason.SUCCEEDED
                        )
                    else:
                        self.job_manager.job_exit_reason = (
                            JobExitReason.CODE_ERROR
                        )
                        self._exit_code = 1
                    break
                # control-plane SLOs: hold the per-verb RPC latency
                # histograms to their declared bounds every poll
                try:
                    self.slo_checker.check()
                except Exception:  # noqa: BLE001 - policing must
                    logger.exception("SLO check failed")  # not kill
                # elastic world-resize: capacity changes (node loss,
                # rejoin, operator request) converge the job to a new
                # world size instead of stalling it on the old one
                try:
                    self.resize_coordinator.poll()
                except Exception:  # noqa: BLE001 - a resize bug must
                    logger.exception("resize poll failed")  # not kill
                # standing-optimizer feed: event logs + throughput
                # snapshots into the Brain datastore on a cadence
                self.maybe_brain_ingest()
                # goodput ledger: causal wall-clock attribution from
                # the event logs, on its own cadence
                self.maybe_goodput_ledger()
                # inference-chain diagnosis over the agents' reported
                # evidence (stacks, hang flight data, per-node step
                # times, step-phase breakdowns) — the hang verdict
                # replaces the blunt last-step check with a reasoned
                # one (culprit + action + measured durations), and
                # straggler/data-starved conclusions are surfaced
                # even while steps still complete
                for rec in self.servicer.drain_diagnosis_records():
                    self.diagnosis_manager.collect(rec)
                verdict = self.diagnosis_manager.diagnose(
                    self.speed_monitor,
                    hang_timeout=ctx.hang_timeout,
                    straggler_ratio=ctx.straggler_factor,
                    job_manager=self.job_manager,
                )
                if verdict.hung:
                    if not self._handle_hang(verdict):
                        break
                else:
                    self._culpritless_hangs = 0
                if (verdict.action
                        == ErrorMonitorConstants.ACTION_ISOLATE
                        and verdict.culprit_node
                        != self._last_straggler_warned):
                    # once per distinct culprit, not once per poll
                    self._last_straggler_warned = (
                        verdict.culprit_node
                    )
                    logger.warning(
                        "straggler diagnosis: %s (isolation happens "
                        "through the next rendezvous round's "
                        "straggler rule)", verdict.reason,
                    )
                if self.task_manager.finished():
                    # workers still RUNNING are finishing their final
                    # saves / exit handshakes: exiting the control
                    # plane now strands them on a dead master (their
                    # RPCs park for a respawn that never comes) — so
                    # the dataset's completion only ends the job once
                    # no worker is left running
                    from dlrover_tpu_torch.common.constants import (
                        NodeStatus as _NS,
                        NodeType as _NT,
                    )

                    running = [
                        n for n in
                        self.job_manager.all_nodes().values()
                        if n.type == _NT.WORKER
                        and n.status == _NS.RUNNING
                    ]
                    if not running:
                        logger.info("all dataset tasks completed")
                        break
        finally:
            self.stop()
            # short jobs may never cross the ledger cadence: force a
            # final assembly so master_exit stamps the end-of-job
            # attribution, not a mid-recovery snapshot
            self.maybe_goodput_ledger(force=True)
            emit_event(
                "master_exit",
                job=self.job_name,
                rc=self._exit_code,
                exit_reason=(
                    self.job_manager.job_exit_reason
                    or self.servicer.exit_requested
                ),
                global_step=self.speed_monitor.completed_global_step,
                goodput=round(self.speed_monitor.goodput(), 4),
                recoveries=self.recoveries,
            )
        return self._exit_code

    def _handle_hang(self, verdict) -> bool:
        """Act on a hung verdict.  Returns True when the job should
        keep running (culprit-only restart requested), False when the
        hang escalates to a job abort.

        The restart rides the existing relaunch machinery: the
        master queues ``restart_workers`` on the culprit's next
        heartbeat ack and the agent supervising the hung trainer
        executes it — healthy nodes never restart.  The silence
        clock and the culprit's evidence are reset so the fresh
        incarnation gets a full hang window before it can be
        re-convicted; a node that exhausts its restart budget
        escalates to the abort path."""
        ctx = Context.instance()
        culprit = verdict.culprit_node
        budget = ctx.relaunch_on_worker_failure
        if culprit < 0 and self._culpritless_hangs < 3:
            self._culpritless_hangs += 1
            logger.warning(
                "training hung but no culprit identified yet "
                "(%s/3); waiting one poll for agent hang evidence",
                self._culpritless_hangs,
            )
            return True
        if culprit >= 0 and self._hang_restarts.get(
            culprit, 0
        ) < budget:
            self._culpritless_hangs = 0
            self._hang_restarts[culprit] = (
                self._hang_restarts.get(culprit, 0) + 1
            )
            logger.error(
                "training hung (%s); restarting culprit node %s "
                "only (hang restart %s/%s, stall %.1fs)",
                verdict.reason, culprit,
                self._hang_restarts[culprit], budget,
                verdict.stall_s,
            )
            self.servicer.request_node_action(
                culprit, MasterAction.RESTART_WORKERS
            )
            # fresh windows: the recovering trainer must not be
            # re-diagnosed from pre-restart silence/evidence, and the
            # recovery itself (heartbeat pickup + respawn + restore +
            # retrace) needs a grace period a small hang_timeout
            # cannot provide — a cold restart alone can exceed it
            self.speed_monitor.note_recovery_action()
            self.diagnosis_manager.clear_node(culprit)
            grace = _env_float(
                "DLROVER_HANG_RESTART_GRACE_S",
                max(60.0, ctx.hang_timeout),
            )
            self.diagnosis_manager.suppress_hang(grace)
            return True
        logger.error(
            "training hung with %s; stopping job (%s)",
            "no identified culprit" if culprit < 0
            else f"node {culprit}'s restart budget exhausted",
            verdict.reason,
        )
        self.job_manager.job_exit_reason = JobExitReason.HANG_ERROR
        self._exit_code = 1
        return False

    def run_in_thread(self):
        self._run_thread = threading.Thread(
            target=self.run, name="master-run", daemon=True
        )
        self._run_thread.start()

    def stop(self):
        self._stop.set()
        for svc in self.aux_services:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001
                logger.exception("stopping %s failed", svc)
        self.task_manager.stop()
        self.job_manager.stop()
        self._server.stop()
        if self.brain_store is not None:
            try:
                self.brain_store.close()
            except Exception:  # noqa: BLE001
                logger.exception("brain store close failed")
            self.brain_store = None
            self.brain = None
        if self.journal is not None:
            # graceful shutdown: fold the tail into a snapshot so a
            # planned restart replays one file, then detach
            try:
                self._snapshot_journal()
            except Exception:  # noqa: BLE001
                logger.exception("final journal snapshot failed")
            self.journal.close()
            self.task_manager.journal = None
            self.job_manager.journal = None
            self.servicer.journal = None
            self.journal = None


# Back-compat aliases matching the reference's two flavours.
LocalJobMaster = JobMaster
