"""``python -m dlrover_tpu_torch.run`` — the elastic launcher CLI.

Reference: ``dlrover/trainer/torch/elastic_run.py`` (``dlrover-run``, a
torchrun superset: parse_args:125, run:342,
_launch_dlrover_local_master:237).  The launcher supervises one node's
training processes: on node rank 0 with no external master it spawns a
local master subprocess (``python -m dlrover_tpu_torch.master.main``),
then runs the elastic agent which joins the master rendezvous, exports
the process group's coordinates (for ``torch.distributed``) and
spawns/monitors the training script.

Copy of ``dlrover_tpu/run.py`` (``tpurun``).  The launcher, the agent
and the master never touch CUDA; only the training processes do, one
per GPU (``cuda:LOCAL_RANK``).  ``--nproc_per_node=auto`` (or
``--auto-config``) starts one training process for each of the node's
NVIDIA cards, counted without loading torch; where the reference's
JAX process drives every chip of its host, a torch process drives
one.

Usage::

    python -m dlrover_tpu_torch.run --nproc_per_node=1 --max_restarts=2 \
        train.py ...
    python -m dlrover_tpu_torch.run --warm-restart train.py ...
    python -m dlrover_tpu_torch.run --nproc_per_node=auto train.py ...
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training import WorkerSpec, launch_agent
from dlrover_tpu_torch.common.comm import addr_connected, find_free_port
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.journal import JOURNAL_DIR_ENV
from dlrover_tpu_torch.telemetry.events import emit_event

# how many times the launcher respawns a locally-spawned master that died
# (each respawn replays the state journal and resumes the job)
MASTER_MAX_RESTARTS_ENV = "DLROVER_MASTER_MAX_RESTARTS"

# host-portability drill (the chaos scenario
# ``master_respawn_other_host``): each respawn of the local master gets a
# fresh, empty journal dir, as a replacement host would, so it recovers
# from the storage-tier journal mirror alone
MASTER_FRESH_JOURNAL_ENV = "DLROVER_MASTER_RESPAWN_FRESH_JOURNAL"


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":")
        return int(lo), int(hi)
    n = int(value)
    return n, n


def _nproc(value: str) -> int:
    return 0 if value == "auto" else int(value)


def count_local_gpus() -> int:
    """The node's NVIDIA cards, without loading torch (whose CUDA build
    maps libcuda at import): the entries of
    ``/proc/driver/nvidia/gpus``, or ``nvidia-smi -L`` where that
    directory is absent; 0 when neither sees a card."""
    proc = "/proc/driver/nvidia/gpus"
    try:
        return len(os.listdir(proc))
    except OSError:
        pass
    try:
        out = subprocess.run(  # noqa: S603, S607 - fixed argv
            ["nvidia-smi", "-L"], capture_output=True, text=True,
            timeout=30, check=False,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.run",
        description="elastic GPU training launcher",
    )
    parser.add_argument(
        "--nnodes", type=str, default="1",
        help="number of nodes, or MIN:MAX for elastic jobs",
    )
    parser.add_argument(
        "--nproc_per_node", type=_nproc, default=1,
        help="training processes per node ('auto' or 0: one per GPU)",
    )
    parser.add_argument(
        "--auto-config", action="store_true", dest="auto_config",
        help="derive nproc_per_node from the local accelerator "
        "runtime (reference: dlrover-run --auto-config)",
    )
    parser.add_argument("--node_rank", type=int, default=None)
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument(
        "--node_unit", type=int, default=1,
        help="world size changes in multiples of this many nodes",
    )
    parser.add_argument(
        "--network-check", action="store_true", dest="network_check",
        help="run chip/fabric health checks before training: a bf16 "
        "GEMM chain on each local GPU and an all-reduce probe",
    )
    parser.add_argument(
        "--master_addr", type=str, default="",
        help="job master host:port; spawned locally if empty on rank 0",
    )
    parser.add_argument("--monitor_interval", type=float, default=2.0)
    parser.add_argument(
        "--warm-restart", action="store_true", dest="warm_restart",
        help="fork restarted workers from a pre-imported template "
        "process (cuts restart latency by the interpreter+torch import "
        "cost; see agent/forkserver.py)",
    )
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _launch_local_master(
    max_nodes: int,
    port: int = 0,
    journal_dir: str = "",
    restart_count: int = 0,
    min_nodes: int = 0,
    node_unit: int = 1,
) -> Tuple[subprocess.Popen, str]:
    """Spawn ``python -m dlrover_tpu_torch.master.main`` for single-node /
    test jobs (reference: _launch_dlrover_local_master,
    elastic_run.py:237).  ``journal_dir`` arms crash recovery: a
    respawned master pointed at the same directory replays the state
    journal; ``restart_count`` tells the new incarnation (and its
    chaos rules) that it IS a respawn.  ``min_nodes < max_nodes``
    (from ``--nnodes MIN:MAX``) arms the master's elastic resize
    coordinator."""
    port = port or find_free_port()
    env = dict(os.environ)
    # ``-m`` needs the package importable whatever the working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = env.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in paths:
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in paths if p])
    if journal_dir:
        env[JOURNAL_DIR_ENV] = journal_dir
    env[NodeEnv.RESTART_COUNT] = str(restart_count)
    argv = [
        sys.executable, "-m", "dlrover_tpu_torch.master.main",
        "--port", str(port),
        "--node_num", str(max_nodes),
    ]
    if min_nodes:
        argv += ["--min_nodes", str(min_nodes)]
    if node_unit > 1:
        argv += ["--node_unit", str(node_unit)]
    proc = subprocess.Popen(argv, env=env)  # noqa: S603
    addr = f"127.0.0.1:{port}"
    deadline = time.time() + 30
    while time.time() < deadline:
        if addr_connected(addr):
            return proc, addr
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        time.sleep(0.3)
    proc.kill()
    raise RuntimeError("local master did not become reachable")


class _MasterSupervisor:
    """Watchdog over a locally-spawned master: respawns it on the
    SAME port with the SAME journal dir when it dies, so the new
    incarnation replays the journal and every parked client's
    re-resolve loop finds the master back at the unchanged address.
    The respawn budget bounds crash loops (a master that dies at
    replay every time must eventually fail the job)."""

    def __init__(self, proc: subprocess.Popen, addr: str,
                 max_nodes: int, journal_dir: str,
                 min_nodes: int = 0, node_unit: int = 1):
        self.proc = proc
        self.addr = addr
        self._port = int(addr.rsplit(":", 1)[1])
        self._max_nodes = max_nodes
        self._min_nodes = min_nodes
        self._node_unit = node_unit
        self._journal_dir = journal_dir
        self._fresh_journal_dirs: List[str] = []
        self._max_restarts = int(
            os.environ.get(MASTER_MAX_RESTARTS_ENV, "3") or 3
        )
        self.restarts = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name="master-watchdog", daemon=True
        )
        self._thread.start()

    def _watch(self):
        while not self._stop.wait(0.5):
            rc = self.proc.poll()
            if rc is None:
                continue
            if self.restarts >= self._max_restarts:
                logger.error(
                    "local master died (rc=%s) and the respawn "
                    "budget (%d) is exhausted; agents will fail "
                    "their resync windows", rc, self._max_restarts,
                )
                return
            self.restarts += 1
            logger.warning(
                "local master died (rc=%s); respawning on port %s "
                "with journal %s (respawn %d/%d)",
                rc, self._port, self._journal_dir,
                self.restarts, self._max_restarts,
            )
            emit_event(
                "master_respawn",
                port=self._port,
                respawn=self.restarts,
                rc=rc,
            )
            if self._stop.is_set():
                # the job is shutting down: a respawn now would leak
                # a master nobody will ever terminate
                return
            journal_dir = self._journal_dir
            if os.environ.get(
                MASTER_FRESH_JOURNAL_ENV, ""
            ).strip().lower() in ("1", "true", "yes", "on"):
                # host-portability drill: the respawn gets an EMPTY
                # journal dir (as a replacement host would), so the
                # only path back to the job's state is seeding from
                # the storage-tier mirror
                journal_dir = tempfile.mkdtemp(
                    prefix="dlrover_mjournal_fresh_"
                )
                self._fresh_journal_dirs.append(journal_dir)
                logger.warning(
                    "respawning master with a FRESH journal dir %s "
                    "(recovery must seed from the mirror)",
                    journal_dir,
                )
            try:
                self.proc, _ = _launch_local_master(
                    self._max_nodes,
                    port=self._port,
                    journal_dir=journal_dir,
                    restart_count=self.restarts,
                    min_nodes=self._min_nodes,
                    node_unit=self._node_unit,
                )
            except RuntimeError as e:
                logger.error("master respawn failed: %s", e)
                return

    def shutdown(self):
        """Stop watching, then terminate whatever incarnation is
        current (SIGTERM first: the master folds its journal into a
        final snapshot and emits master_exit).  The join outlasts a
        worst-case in-flight respawn (startup wait is 30 s) so the
        terminate below always targets the LIVE incarnation."""
        self._stop.set()
        self._thread.join(timeout=35.0)
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            # reap it: right after the SIGKILL the process may not have
            # exited yet, and poll() would still read it as running
            self.proc.kill()
            self.proc.wait()
        for d in self._fresh_journal_dirs:
            shutil.rmtree(d, ignore_errors=True)


def apply_auto_config(args):
    """Fill nproc_per_node from the machine (reference:
    ``dlrover-run --auto-config``, elastic_run.py:125): one training
    process for each NVIDIA card of the node (:func:`count_local_gpus`),
    one when the node has none (a CPU run)."""
    if not (args.auto_config or args.nproc_per_node <= 0):
        return args
    args.nproc_per_node = max(1, count_local_gpus())
    logger.info(
        "auto-config: nproc_per_node=%s", args.nproc_per_node
    )
    return args


def run(args) -> int:
    args = apply_auto_config(args)
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    node_rank = (
        args.node_rank
        if args.node_rank is not None
        else int(os.getenv(NodeEnv.NODE_RANK, "0"))
    )
    master_addr = args.master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
    supervisor: Optional[_MasterSupervisor] = None
    journal_dir_created = ""
    if not master_addr:
        if node_rank != 0:
            raise RuntimeError(
                "--master_addr (or DLROVER_MASTER_ADDR) is required on "
                "non-zero node ranks"
            )
        # crash recovery is on by default for the local master: a
        # fresh per-run journal dir unless the caller pinned one (a
        # PINNED dir may carry a previous run's state on purpose —
        # that is the recover-across-launcher-invocations workflow)
        journal_dir = os.getenv(JOURNAL_DIR_ENV, "")
        if not journal_dir:
            journal_dir = tempfile.mkdtemp(prefix="dlrover_mjournal_")
            journal_dir_created = journal_dir
        elastic_min = min_nodes if min_nodes < max_nodes else 0
        master_proc, master_addr = _launch_local_master(
            max_nodes, journal_dir=journal_dir,
            min_nodes=elastic_min, node_unit=args.node_unit,
        )
        supervisor = _MasterSupervisor(
            master_proc, master_addr, max_nodes, journal_dir,
            min_nodes=elastic_min, node_unit=args.node_unit,
        )
        logger.info(
            "launched local master at %s (journal %s)",
            master_addr, journal_dir,
        )

    # remember the ambient value: when WE spawned the local master its
    # address must not outlive it in this process's env, or the next
    # in-process run (tests, the chaos harness) inherits a dead master
    # and skips launching its own
    prev_master_addr = os.environ.get(NodeEnv.MASTER_ADDR)
    os.environ[NodeEnv.MASTER_ADDR] = master_addr
    os.environ.setdefault(NodeEnv.NODE_ID, str(node_rank))
    os.environ.setdefault(NodeEnv.NODE_RANK, str(node_rank))
    MasterClient.reset()

    entrypoint = [sys.executable, args.training_script]
    entrypoint += list(args.training_script_args)
    spec = WorkerSpec(
        entrypoint=entrypoint,
        nproc_per_node=args.nproc_per_node,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_unit=args.node_unit,
        network_check=args.network_check,
        warm_restart=args.warm_restart,
    )

    # Breakpoint-checkpoint hook: persist any shm checkpoint before a
    # restart (wired to the agent-side saver when one is registered).
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    saver_hook = AsyncCheckpointSaver.save_shm_to_storage
    AsyncCheckpointSaver.start_async_saving_ckpt()

    try:
        return launch_agent(spec, save_ckpt_hook=saver_hook)
    finally:
        AsyncCheckpointSaver.stop_all()
        if supervisor is not None:
            # the local master dies with this run: restore the env so
            # a later run in this process cannot aim at its corpse
            if prev_master_addr is None:
                os.environ.pop(NodeEnv.MASTER_ADDR, None)
            else:
                os.environ[NodeEnv.MASTER_ADDR] = prev_master_addr
            supervisor.shutdown()
            if journal_dir_created:
                # per-run journal: nothing outlives the run it served
                import shutil

                shutil.rmtree(journal_dir_created, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
