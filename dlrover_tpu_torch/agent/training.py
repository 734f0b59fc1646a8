"""Elastic training agent: master-driven rendezvous, worker process
supervision, restart-on-membership-change, failure reporting.

Reference: ``dlrover/python/elastic_agent/torch/training.py``
(``ElasticTrainingAgent:362``, ``_invoke_run:580``,
``_membership_changed:711``, ``MasterRendezvousHandler:179``,
``NodeCheckElasticAgent:864``).  The torch-elastic machinery is
replaced by direct process supervision: after each master rendezvous
the agent exports the process group's coordinates (coordinator
address, process_id, num_processes; the training process hands them to
``torch.distributed`` through
:func:`~dlrover_tpu_torch.trainer.elastic_trainer.init_torch_distributed`)
and spawns the training processes; a monitor loop restarts them on
failure or when the master reports waiting nodes (membership change).
The save-checkpoint-at-breakpoint hook fires before any restart so the
shared-memory checkpoint is persisted even when the trainer died.

Copy of ``dlrover_tpu/agent/training.py``.  The agent never touches
CUDA: only its workers do.  The reference exports the JAX persistent
compile-cache env to every worker and to the warm template
(``_compile_cache_env``), always; the port's cache holds its kernel
libraries (:mod:`dlrover_tpu_torch.common.compile_cache`) and is armed
only when the operator sets ``DLROVER_COMPILE_CACHE_DIR`` (otherwise the
kernels keep building into the package tree), so the agent creates its
``kernels/`` and ``aot/`` directories then and the env reaches every
worker with the rest of the agent's.  The worker's ``PYTHONPATH``
carries the port's package root.
"""

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.agent.diagnosis import DiagnosisMonitor, HangWatchdog
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import (
    HeartbeatReporter,
    ResourceMonitor,
    TrainingMonitor,
)
from dlrover_tpu_torch.agent.node_check import run_node_check_in_child
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.constants import (
    MasterAction,
    NetworkCheckConstant,
    NodeEnv,
    NodeExitReason,
    NodeStatus,
    RendezvousConstant,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing as trace
from dlrover_tpu_torch.telemetry.events import (
    EVENT_SOURCE_ENV,
    emit_event,
    set_event_source,
)
from dlrover_tpu_torch.telemetry.exporter import (
    METRICS_TEXTFILE_ENV,
    TextfileDumper,
)
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.telemetry.otlp import maybe_from_env as otlp_from_env

_REG = get_registry()
_RDZV_SECONDS = _REG.histogram(
    "dlrover_agent_rdzv_seconds",
    "Agent-side join-to-world rendezvous latency",
)
_RESTARTS_TOTAL = _REG.counter(
    "dlrover_agent_worker_restarts_total",
    "Worker restart rounds this agent performed",
)


class WorkerState(Enum):
    INIT = "init"
    HEALTHY = "healthy"
    FAILED = "failed"
    SUCCEEDED = "succeeded"


@dataclass
class WorkerSpec:
    """What to run and how elastic it is (reference: torch WorkerSpec +
    ElasticLaunchConfig, elastic_run.py:295)."""

    entrypoint: List[str] = field(default_factory=list)
    nproc_per_node: int = 1
    max_restarts: int = 3
    monitor_interval: float = 2.0
    min_nodes: int = 1
    max_nodes: int = 1
    node_unit: int = 1
    rdzv_timeout: float = RendezvousConstant.DEFAULT_TIMEOUT
    network_check: bool = False
    env: Dict[str, str] = field(default_factory=dict)
    # fork workers from a warm pre-imported template instead of a cold
    # ``python script.py`` — cuts restart latency by the interpreter +
    # torch import cost, the dominant goodput loss under churn
    # (see agent/forkserver.py)
    warm_restart: bool = False
    # recovery boost: RESPAWNED (restart_count > 0) warm-forked
    # workers start at this scheduling priority for recovery_boost_s
    # seconds, so restore + retrace is never starved by host load —
    # an unbounded recovery under a load spike is what pushes
    # goodput below target.  0 disables; needs privileges for
    # negative values (silently unboosted otherwise).
    recovery_nice: int = -10
    recovery_boost_s: float = 20.0


@dataclass
class RendezvousOutcome:
    round: int = 0
    world: Dict[int, int] = field(default_factory=dict)
    coordinator: str = ""

    @property
    def num_nodes(self) -> int:
        return len(self.world)

    @property
    def world_size(self) -> int:
        return sum(self.world.values())

    def base_rank(self, node_rank: int) -> int:
        """The world dict's iteration order IS the global rank order
        (the master emits it topology-sorted; pickle preserves it)."""
        base = 0
        for rank, size in self.world.items():
            if rank == node_rank:
                return base
            base += size
        return base


class MasterRendezvousHandler:
    """Join the master rendezvous and poll for the completed world
    (reference: MasterRendezvousHandler.next_rendezvous,
    training.py:250)."""

    def __init__(
        self,
        name: str,
        node_rank: int,
        local_world_size: int,
        client: Optional[MasterClient] = None,
        timeout: float = RendezvousConstant.DEFAULT_TIMEOUT,
    ):
        self._name = name
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._client = client or MasterClient.singleton()
        self._timeout = timeout

    def next_rendezvous(self) -> RendezvousOutcome:
        # the span context rides the join RPC frame, so the master's
        # handler-side ``rdzv.join`` span records this span as parent
        # — the cross-process link tests assert from the event log
        with trace.span(
            "rdzv.join", rdzv=self._name, node_rank=self._node_rank
        ) as join_span:
            rdzv_round = self._client.join_rendezvous(
                self._node_rank, self._local_world_size, self._name
            )
            start = time.time()
            while True:
                round_, _group, world, coordinator = (
                    self._client.get_comm_world(
                        self._name, self._node_rank
                    )
                )
                if world:
                    if self._node_rank not in world:
                        raise RuntimeError(
                            f"node {self._node_rank} excluded from "
                            f"rendezvous round {round_} world "
                            f"{sorted(world)}"
                        )
                    logger.info(
                        "rendezvous %s round %s complete: %s nodes, "
                        "coordinator %s",
                        self._name, round_, len(world), coordinator,
                    )
                    wait_s = time.time() - start
                    _RDZV_SECONDS.observe(wait_s, rdzv=self._name)
                    join_span.set_attribute("round", round_)
                    join_span.set_attribute("nodes", len(world))
                    return RendezvousOutcome(
                        round=round_, world=world,
                        coordinator=coordinator,
                    )
                if time.time() - start > self._timeout:
                    raise TimeoutError(
                        f"rendezvous {self._name} round {rdzv_round} "
                        f"timed out after {self._timeout}s"
                    )
                time.sleep(RendezvousConstant.JOIN_INTERVAL)


class ElasticTrainingAgent:
    """Supervises the local training processes of one node."""

    def __init__(
        self,
        spec: WorkerSpec,
        client: Optional[MasterClient] = None,
        node_rank: Optional[int] = None,
        start_monitors: bool = True,
        # hook run before any restart/exit so shm checkpoints persist
        # (reference: _save_ckpt_to_storage at training.py:665)
        save_ckpt_hook: Optional[Callable[[], None]] = None,
    ):
        self._spec = spec
        self._client = client or MasterClient.singleton()
        self._node_rank = (
            node_rank if node_rank is not None else env_utils.get_node_rank()
        )
        # _restart_count is the incarnation id (every restart bumps
        # it — events/env depend on it); _budget_restarts counts only
        # UNPLANNED restarts (worker failures, hang convictions)
        # against max_restarts — a planned drain (resize, membership
        # re-form) must not eat the failure budget
        self._restart_count = 0
        self._budget_restarts = 0
        # wall clock at which THIS restart round's death was
        # witnessed: exported as DLROVER_RECOVERY_T0 so the respawned
        # trainer's RecoveryProfiler measures the real spawn phase
        self._recovery_t0: float = 0.0
        # previous round's overlapped breakpoint save, joined before
        # the next round may start another
        self._save_thread = None
        self._procs: List[subprocess.Popen] = []
        self._rdzv = MasterRendezvousHandler(
            RendezvousName.ELASTIC_TRAINING,
            self._node_rank,
            spec.nproc_per_node,
            client=self._client,
            timeout=spec.rdzv_timeout,
        )
        self._save_ckpt_hook = save_ckpt_hook
        self._forkserver = None
        if spec.warm_restart:
            from dlrover_tpu_torch.agent.forkserver import WorkerForkServer

            # the directories exist before the template preloads from
            # them and before the first incarnation writes its entry
            self._compile_cache_env()
            self._forkserver = WorkerForkServer()
            # start importing NOW so the template is warm before the
            # first restart needs it
            self._forkserver._ensure_template()
        self._monitors = []
        self._heartbeat: Optional[HeartbeatReporter] = None
        self._hang_watchdog: Optional[HangWatchdog] = None
        if start_monitors:
            # report cadence: 15 s suits production; the chaos/bench
            # harnesses shorten it so the master's speed/goodput
            # accounting has a real gap distribution on minute-scale
            # mini-jobs
            try:
                report_interval = float(
                    os.environ.get(
                        "DLROVER_MONITOR_REPORT_INTERVAL", "15"
                    )
                )
            except ValueError:
                report_interval = 15.0
            self._heartbeat = HeartbeatReporter(
                interval=report_interval, client=self._client
            )
            # live pids of the supervised worker tree for the stack
            # collector and the hang watchdog's /proc capture
            worker_pids = lambda: [  # noqa: E731
                p.pid for p in self._procs if p.poll() is None
            ]
            self._monitors = [
                ResourceMonitor(
                    interval=report_interval, client=self._client
                ),
                TrainingMonitor(
                    TrainingMonitor.default_metrics_path(),
                    interval=report_interval,
                    client=self._client,
                ),
                self._heartbeat,
                # evidence loop: stacks / chip metrics / step times /
                # step-phase breakdowns to the master's diagnosis chain
                DiagnosisMonitor(
                    interval=max(report_interval * 4, 4.0),
                    client=self._client,
                    worker_pids_fn=worker_pids,
                ),
                # hang flight data: no-step-progress past the
                # threshold captures stacks + /proc state and ships
                # them (DLROVER_HANG_THRESHOLD_S tunes the window)
                HangWatchdog(
                    worker_pids_fn=worker_pids,
                    client=self._client,
                ),
            ]
            self._hang_watchdog = self._monitors[-1]
            from dlrover_tpu_torch.agent.preemption import (
                PreemptionMonitor,
                monitor_enabled,
            )

            if monitor_enabled():
                self._monitors.append(
                    PreemptionMonitor(self._on_preemption_notice)
                )

    # -- worker process management ----------------------------------------

    @staticmethod
    def _compile_cache_env() -> Dict[str, str]:
        """The armed compile cache's env (empty when the operator armed
        none), with its ``kernels/`` and ``aot/`` directories created
        here so the first incarnation's build and entry write never race
        the mkdir."""
        from dlrover_tpu_torch.common import compile_cache
        from dlrover_tpu_torch.common.aot_cache import aot_cache_dir

        cache = compile_cache.active_cache_dir()
        if not cache:
            return {}
        try:
            os.makedirs(compile_cache.kernel_dir(cache), exist_ok=True)
            os.makedirs(aot_cache_dir(), exist_ok=True)
        except OSError:
            pass
        return compile_cache.cache_env(cache)

    def _worker_env(
        self, outcome: RendezvousOutcome, local_rank: int
    ) -> Dict[str, str]:
        base_rank = outcome.base_rank(self._node_rank)
        env = dict(os.environ)
        env.update(self._compile_cache_env())
        env.update(self._spec.env)
        # make the framework importable in workers even when not
        # pip-installed (script-mode sys.path only has the script dir)
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(dlrover_tpu_torch.__file__))
        pythonpath = env.get("PYTHONPATH", "")
        if pkg_root not in pythonpath.split(os.pathsep):
            env["PYTHONPATH"] = (
                f"{pkg_root}{os.pathsep}{pythonpath}" if pythonpath
                else pkg_root
            )
        # the wall clock at which THIS round's death was witnessed:
        # the respawned trainer's RecoveryProfiler anchors its spawn
        # phase on it, so the measured budget covers the whole
        # death->first-step chain, not just what the trainer can see
        if self._recovery_t0 > 0:
            env["DLROVER_RECOVERY_T0"] = f"{self._recovery_t0:.6f}"
        else:
            env.pop("DLROVER_RECOVERY_T0", None)
        # tag the worker's training events even when the entrypoint
        # never touches telemetry itself
        env.setdefault(EVENT_SOURCE_ENV, "trainer")
        env.update(
            {
                NodeEnv.COORDINATOR_ADDR: outcome.coordinator,
                NodeEnv.PROCESS_ID: str(base_rank + local_rank),
                NodeEnv.NUM_PROCESSES: str(outcome.world_size),
                NodeEnv.LOCAL_RANK: str(local_rank),
                NodeEnv.LOCAL_WORLD_SIZE: str(self._spec.nproc_per_node),
                NodeEnv.RANK: str(base_rank + local_rank),
                NodeEnv.WORLD_SIZE: str(outcome.world_size),
                NodeEnv.NODE_RANK: str(self._node_rank),
                NodeEnv.NODE_NUM: str(outcome.num_nodes),
                NodeEnv.RESTART_COUNT: str(self._restart_count),
                NodeEnv.MASTER_ADDR: self._client.master_addr,
            }
        )
        return env

    def _forked_argv(self) -> Optional[List[str]]:
        """Entrypoint argv for a template fork: the interpreter is
        already running, so drop a leading ``python``.  Returns None
        when the entrypoint cannot run via ``runpy.run_path`` —
        interpreter flags or ``-m module`` forms — in which case the
        caller falls back to a cold spawn rather than handing ``-m``
        to runpy as a file path."""
        argv = list(self._spec.entrypoint)
        if argv and os.path.basename(argv[0]).startswith("python"):
            argv = argv[1:]
        if not argv or argv[0].startswith("-"):
            return None
        return argv

    def _start_workers(self, outcome: RendezvousOutcome):
        self._procs = []
        forked_argv = (
            self._forked_argv() if self._forkserver is not None
            else None
        )
        if self._forkserver is not None and forked_argv is None:
            logger.warning(
                "warm_restart: entrypoint %s is not a plain script "
                "(interpreter flags / -m); using cold spawns",
                self._spec.entrypoint,
            )
        boost = None
        if self._restart_count > 0 and self._spec.recovery_nice:
            boost = {
                "nice": self._spec.recovery_nice,
                "seconds": self._spec.recovery_boost_s,
            }
        for local_rank in range(self._spec.nproc_per_node):
            env = self._worker_env(outcome, local_rank)
            if forked_argv is not None:
                try:
                    proc = self._forkserver.spawn(
                        forked_argv, env, nice_boost=boost
                    )
                except RuntimeError as e:
                    # watchdog: a wedged or dead template must not
                    # turn one kill into an unbounded recovery — fall
                    # back to cold spawns for the REST OF THIS ROUND
                    # (a rebuilt template would likely wedge the same
                    # way and burn another full timeout per rank);
                    # the next round's spawn rebuilds the template
                    logger.warning(
                        "warm fork failed (%s); cold-spawning "
                        "rank %d and the remaining ranks this "
                        "round", e, local_rank,
                    )
                    emit_event(
                        "warm_fork_fallback",
                        node_rank=self._node_rank,
                        local_rank=local_rank,
                        restart_count=self._restart_count,
                        reason=str(e),
                    )
                    self._forkserver.close()
                    forked_argv = None
                    proc = subprocess.Popen(  # noqa: S603
                        self._spec.entrypoint, env=env
                    )
            else:
                proc = subprocess.Popen(  # noqa: S603 - entrypoint
                    self._spec.entrypoint, env=env
                )
            self._procs.append(proc)
        logger.info(
            "started %s worker process(es)%s: %s",
            len(self._procs),
            " (warm fork)" if forked_argv is not None else "",
            self._spec.entrypoint,
        )

    def _stop_workers(self, timeout: float = 30.0):
        for p in self._procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + timeout
        for p in self._procs:
            remaining = max(0.1, deadline - time.time())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._procs = []

    def _monitor_workers(self) -> Tuple[WorkerState, Dict[int, int]]:
        """One poll of worker liveness -> (state, {local_rank: code})."""
        codes: Dict[int, int] = {}
        for local_rank, p in enumerate(self._procs):
            rc = p.poll()
            if rc is not None:
                codes[local_rank] = rc
        if not codes:
            return WorkerState.HEALTHY, codes
        if all(c == 0 for c in codes.values()) and len(codes) == len(
            self._procs
        ):
            return WorkerState.SUCCEEDED, codes
        if any(c != 0 for c in codes.values()):
            return WorkerState.FAILED, codes
        return WorkerState.HEALTHY, codes  # some exited 0, rest running

    def _membership_changed(self) -> bool:
        """True when the master has nodes waiting to join/leave and the
        world should be re-formed (reference: training.py:711).

        ``DLROVER_MEMBERSHIP_SELF_RESTART=0`` disables this agent-side
        fallback: when the master's resize coordinator is armed it
        owns ALL world changes (journaled decision + drained
        survivors), and N agents each self-restarting on the same
        waiting signal would thunder-herd the re-form."""
        if os.getenv(
            "DLROVER_MEMBERSHIP_SELF_RESTART", "1"
        ).strip().lower() in ("0", "false", "no", "off"):
            return False
        try:
            waiting = self._client.num_nodes_waiting(
                RendezvousName.ELASTIC_TRAINING
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("num_nodes_waiting failed: %s", e)
            return False
        if waiting <= 0:
            return False
        # node_unit rounding: only restart when at least one full unit
        # of nodes can join (reference: _membership_changed,
        # training.py:711 restarts at node-unit granularity)
        return waiting >= self._spec.node_unit

    def _save_ckpt_at_breakpoint(self):
        if self._save_ckpt_hook is not None:
            try:
                self._save_ckpt_hook()
            except Exception as e:  # noqa: BLE001
                logger.error("breakpoint checkpoint save failed: %s", e)

    def _on_preemption_notice(self):
        """Advance warning from the metadata server (~30 s before the
        VM dies).  The checkpoint save starts IMMEDIATELY — the
        master report runs in a side thread so its retrying RPC
        (seconds of backoff when the master is unreachable) can never
        eat the preemption window the save needs.  The master's
        DistributedJobManager routes the report through the relaunch
        path, so replacement placement starts without waiting for
        the pod watcher to see the VM die."""
        import threading

        def report():
            try:
                # single-shot: the watcher path is the durable fallback
                # if this report is lost; a retried send could deliver
                # the same preemption twice (ADVICE r2)
                self._client.report_node_event_once(
                    event_type="preemption_notice",
                    status=NodeStatus.FAILED,
                    exit_reason=NodeExitReason.PREEMPTED,
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "preemption report to master failed: %s", e
                )

        threading.Thread(
            target=report, daemon=True, name="preemption-report"
        ).start()
        # an overlapped persist from an earlier restart must not race
        # this save of the same shards
        self._join_save_thread()
        self._save_ckpt_at_breakpoint()

    # -- health check -------------------------------------------------------

    def node_health_check(self) -> bool:
        """Run the network-check rendezvous rounds; raise if this node
        is diagnosed faulty (reference: node_health_check,
        training.py:1073)."""
        for round_id in range(NetworkCheckConstant.MAX_CHECK_ROUNDS):
            handler = MasterRendezvousHandler(
                RendezvousName.NETWORK_CHECK,
                self._node_rank,
                self._spec.nproc_per_node,
                client=self._client,
                timeout=NetworkCheckConstant.CHECK_TIMEOUT,
            )
            outcome = handler.next_rendezvous()
            normal, elapsed = True, 0.0
            try:
                # in a child process: the agent never holds the card
                elapsed = run_node_check_in_child(
                    client=self._client,
                    world_size=outcome.num_nodes,
                    round_id=outcome.round,
                )
            except Exception as e:  # noqa: BLE001
                logger.error("node check failed: %s", e)
                normal = False
            self._client.report_network_status(
                self._node_rank, normal, elapsed
            )
            result = self._client.check_fault_node()
            if self._node_rank in result.fault_nodes:
                raise RuntimeError(
                    f"node {self._node_rank} diagnosed faulty: "
                    f"{result.reason}"
                )
            if result.normal:
                return True
        return True

    # -- main loop -----------------------------------------------------------

    def run(self) -> int:
        set_event_source("agent")
        # no stable scrape address under churn: agents export via a
        # textfile dump when one is configured (node-exporter style)
        textfile = os.getenv(METRICS_TEXTFILE_ENV, "")
        dumper = TextfileDumper(textfile) if textfile else None
        if dumper is not None:
            dumper.start()
        # push the agent's spans/metrics to an OTLP collector when
        # configured (agents have no stable scrape address under churn)
        otlp = otlp_from_env(service_name="dlrover_tpu_torch.agent")
        if otlp is not None:
            otlp.start()
        # GCP-native sink behind the same interfaces
        from dlrover_tpu_torch.telemetry.gcp_monitoring import (
            maybe_from_env as gcp_from_env,
        )

        gcp = gcp_from_env()
        if gcp is not None:
            gcp.start()
        for m in self._monitors:
            m.start()
        try:
            return self._invoke_run()
        finally:
            # an overlapped breakpoint persist must finish before the
            # saver (and its shm handlers) are torn down
            self._join_save_thread()
            for m in self._monitors:
                m.stop()
            if dumper is not None:
                dumper.stop()
            if otlp is not None:
                otlp.stop()
            if gcp is not None:
                gcp.stop()
            if self._forkserver is not None:
                self._forkserver.close()

    def _initialize_workers(self):
        if self._spec.network_check:
            self.node_health_check()
        outcome = self._rdzv.next_rendezvous()
        self._start_workers(outcome)

    def _join_save_thread(self, timeout: float = 600.0):
        """Wait for the previous round's overlapped breakpoint save —
        called before starting another, and on every exit path, so an
        in-flight persist can never race process teardown or a second
        save of the same shards."""
        t = self._save_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._save_thread = None

    def _restart_workers(self, reason: str = "failure"):
        # the death was witnessed by the poll that got us here: this
        # timestamp anchors the replacement trainer's recovery-phase
        # budget (exported as DLROVER_RECOVERY_T0)
        self._recovery_t0 = time.time()
        self._restart_count += 1
        if reason in ("failure", "hang"):
            self._budget_restarts += 1
        logger.info(
            "restarting workers (restart %s, reason %s)",
            self._restart_count, reason,
        )
        _RESTARTS_TOTAL.inc()
        emit_event(
            "worker_restart",
            node_rank=self._node_rank,
            restart_count=self._restart_count,
            reason=reason,
        )
        # restore prefetch hint (ROADMAP 3b): page the shm checkpoint
        # segments in THE MOMENT the death is witnessed — the touches
        # overlap the breakpoint save, the worker stop AND the
        # replacement's import, instead of starting after the stop
        # completed as they used to.
        self._prefetch_shm_for_restore()
        import threading

        # a previous round's overlapped persist must be done before
        # EITHER branch saves the same shards again
        self._join_save_thread()
        if reason in ("failure", "hang"):
            # the respawned trainer restores from the SHM snapshot;
            # the storage persist is pure durability (it protects
            # against this agent dying too) and has no business on
            # the death->first-step critical path — run it overlapped
            # with the stop + rendezvous + spawn.  The shard lock
            # keeps it consistent against any concurrent reader.
            self._save_thread = threading.Thread(
                target=self._save_ckpt_at_breakpoint,
                daemon=True,
                name="breakpoint-save",
            )
            self._save_thread.start()
        else:
            # planned drains (resize / membership): the re-formed
            # world may RESHARD from the storage tier, so the persist
            # must be durable before the new world restores — keep it
            # on the critical path
            self._save_ckpt_at_breakpoint()
        if reason == "resize":
            # drain fast: the old world is DEAD (its collective
            # partners changed), so a trainer wedged in a doomed
            # collective gets a short SIGTERM grace, not the full
            # stop window — XLA's preemption notifier swallows
            # SIGTERM, so the escalation to SIGKILL is the path that
            # actually ends it, and every second here is resize
            # downtime.  The breakpoint save above already persisted
            # the shm snapshot, so the kill loses nothing.
            self._stop_workers(
                timeout=env_utils._get_float(
                    "DLROVER_RESIZE_STOP_TIMEOUT_S", 5.0
                )
            )
        else:
            self._stop_workers()
        self._initialize_workers()
        if self._hang_watchdog is not None:
            # the recovery window (respawn + restore + retrace) must
            # not read as a stall of the fresh incarnation
            self._hang_watchdog.reset()

    def _prefetch_shm_for_restore(self):
        import threading

        from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

        threading.Thread(
            target=AsyncCheckpointSaver.prefetch_shm_snapshots,
            kwargs={"restart_count": self._restart_count},
            daemon=True,
            name="shm-prefetch",
        ).start()

    def _observed_step(self) -> Optional[int]:
        """Worker step this agent last saw in the trainer-written
        metrics record — chaos-hook context only (None outside an
        armed scenario: the production monitor poll must not pay a
        file read for an unarmed hook)."""
        if not _chaos.chaos_enabled():
            return None
        from dlrover_tpu_torch.agent.monitor import read_metrics_record

        record = read_metrics_record(
            TrainingMonitor.default_metrics_path()
        ) or {}
        try:
            step = int(record.get("global_step", -1))
        except (TypeError, ValueError):
            return None
        return step if step >= 0 else None

    def _pop_master_action(self) -> str:
        """Consume the action the master piggybacked on the last
        heartbeat ack (the diagnosis chain's culprit-only relaunch
        rides this channel: the master cannot reach into another
        host's process tree, but the agent supervising the hung
        trainer can)."""
        hb = self._heartbeat
        if hb is None:
            return ""
        action, hb.last_action = hb.last_action, ""
        return action

    def _invoke_run(self) -> int:
        """Reference: _invoke_run (training.py:580)."""
        self._initialize_workers()
        while True:
            time.sleep(self._spec.monitor_interval)
            # chaos hook: a kill_worker rule signals one of the
            # supervised processes here, and THIS VERY POLL observes
            # the death — the recovery path under test is the real
            # monitor/restart machinery, not a shortcut.  The step
            # this agent last saw in the trainer's metrics record
            # rides in ctx so after_step rules ("kill node N once it
            # trained past step K") trigger on real progress instead
            # of wall clock, however slow the job's startup is.
            _chaos.fire(
                "agent.monitor",
                procs=self._procs,
                restart_count=self._restart_count,
                step=self._observed_step(),
            )
            action = self._pop_master_action()
            if action == MasterAction.RESTART_WORKERS:
                # the master diagnosed THIS node as the hang culprit:
                # restart only our workers (checkpoint breakpoint save
                # included); healthy peers never see a restart
                logger.warning(
                    "master requested a worker restart (hang "
                    "diagnosis); restarting local workers"
                )
                if self._budget_restarts >= self._spec.max_restarts:
                    logger.error(
                        "max restarts (%s) exhausted; cannot honor "
                        "master restart request",
                        self._spec.max_restarts,
                    )
                    self._join_save_thread()
                    self._save_ckpt_at_breakpoint()
                    self._stop_workers()
                    self._client.ready_to_exit("failed")
                    return 1
                self._restart_workers(reason="hang")
                continue
            if action == MasterAction.RESIZE:
                # elastic world-resize: the master decided a new
                # target world size (capacity loss/gain or operator
                # request).  A PLANNED drain, not a failure: restart
                # the local workers into the re-formed world without
                # burning the failure-restart budget — the breakpoint
                # save persists the shm snapshot first, and the new
                # incarnation restores RESHARDED onto the new mesh.
                logger.warning(
                    "master requested a world resize; draining local "
                    "workers and re-joining the rendezvous"
                )
                self._restart_workers(reason="resize")
                continue
            state, codes = self._monitor_workers()
            if state == WorkerState.SUCCEEDED:
                logger.info("all workers finished successfully")
                self._client.ready_to_exit("succeeded")
                return 0
            if state == WorkerState.FAILED:
                failed = {r: c for r, c in codes.items() if c != 0}
                logger.error("worker failure(s): %s", failed)
                self._client.report_failure(
                    error_data=f"exitcodes={failed}",
                    level=TrainingExceptionLevel.PROCESS_ERROR,
                    restart_count=self._restart_count,
                    node_rank=self._node_rank,
                )
                if self._budget_restarts >= self._spec.max_restarts:
                    logger.error(
                        "max restarts (%s) exhausted; giving up",
                        self._spec.max_restarts,
                    )
                    self._join_save_thread()
                    self._save_ckpt_at_breakpoint()
                    self._stop_workers()
                    self._client.ready_to_exit("failed")
                    return 1
                self._restart_workers(reason="failure")
            elif self._membership_changed():
                logger.info("membership changed; re-rendezvous")
                self._restart_workers(reason="membership")

    def stop(self):
        self._join_save_thread()
        self._stop_workers()
        if self._forkserver is not None:
            self._forkserver.close()


def launch_agent(
    spec: WorkerSpec,
    client: Optional[MasterClient] = None,
    save_ckpt_hook: Optional[Callable[[], None]] = None,
) -> int:
    """Build and run the agent (reference: launch_agent, training.py:734)."""
    agent = ElasticTrainingAgent(
        spec, client=client, save_ckpt_hook=save_ckpt_hook
    )
    return agent.run()
