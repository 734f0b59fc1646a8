"""Master entry point: ``python -m dlrover_tpu_torch.master.main``.

Copy of ``dlrover_tpu/master/main.py`` (the port imports nothing of
the JAX package).

Role of ``dlrover/python/master/main.py``: parse args, build the
master for the target platform, serve until the job exits.
"""

import argparse
import os
import signal
import sys

from dlrover_tpu_torch.common.constants import DefaultPorts
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.journal import (
    JOURNAL_DIR_ENV,
    JOURNAL_MIRROR_DIR_ENV,
)
from dlrover_tpu_torch.master.master import JobMaster


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="dlrover_tpu job master")
    parser.add_argument("--port", type=int, default=DefaultPorts.MASTER)
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument(
        "--min_nodes", type=int, default=0,
        help="elastic floor: the job keeps training as long as this "
        "many nodes survive (0 = node_num, i.e. fixed world; also "
        "via DLROVER_MIN_NODES).  min_nodes < node_num arms the "
        "resize coordinator",
    )
    parser.add_argument(
        "--node_unit", type=int, default=1,
        help="world size changes in multiples of this many nodes",
    )
    parser.add_argument("--job_name", type=str, default="local-job")
    parser.add_argument(
        "--platform",
        type=str,
        default="local",
        choices=["local", "kubernetes", "ray"],
    )
    parser.add_argument(
        "--journal_dir",
        type=str,
        default=os.getenv(JOURNAL_DIR_ENV, ""),
        help="crash-recovery state journal directory; a respawned "
        "master pointed at the same directory replays it and resumes "
        f"the job (also via {JOURNAL_DIR_ENV})",
    )
    parser.add_argument(
        "--journal_mirror_dir",
        type=str,
        default=os.getenv(JOURNAL_MIRROR_DIR_ENV, ""),
        help="async group-commit journal replica on the checkpoint "
        "storage tier; a master respawned on a DIFFERENT host with a "
        "fresh --journal_dir seeds it from this mirror (also via "
        f"{JOURNAL_MIRROR_DIR_ENV})",
    )
    return parser.parse_args(argv)


def _host_ip() -> str:
    """Pod-reachable address of this host (no DNS dependence — a UDP
    connect never sends packets but resolves the egress interface)."""
    import socket

    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(1.0)
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def create_master(args) -> JobMaster:
    """Compose the master for the target platform (reference:
    dist_master.py:86 owning job manager + watchers + auto-scaler).

    ``kubernetes``: DistributedJobManager over PodScaler/PodWatcher,
    plus the AllreduceAutoScaler and the ScalePlan CR watcher that
    executes externally written plans (k8s_watcher.py:267 parity).
    """
    if args.platform != "kubernetes":
        return JobMaster(
            port=args.port, node_num=args.node_num,
            job_name=args.job_name,
            journal_dir=args.journal_dir or None,
            min_node_num=args.min_nodes or None,
            node_unit=args.node_unit,
        )
    from dlrover_tpu_torch.master.auto_scaler import AllreduceAutoScaler
    from dlrover_tpu_torch.master.node_manager import DistributedJobManager
    from dlrover_tpu_torch.master.resource_optimizer import LocalOptimizer
    from dlrover_tpu_torch.master.scaler import PodScaler
    from dlrover_tpu_torch.master.watcher import PodWatcher, ScalePlanWatcher
    from dlrover_tpu_torch.scheduler.job_args import new_job_args
    from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

    client = K8sClient.singleton()
    job_args = new_job_args(
        platform="kubernetes", job_name=args.job_name,
        num_workers=args.node_num,
    )
    scaler = PodScaler(args.job_name, client, master_addr="")
    job_manager = DistributedJobManager(job_args, scaler)
    job_manager._watcher = PodWatcher(
        args.job_name, client, job_manager.process_event
    )
    master = JobMaster(
        port=args.port, node_num=args.node_num,
        job_name=args.job_name, job_manager=job_manager,
    )
    # worker pods reach the master at this host's bound port
    scaler._master_addr = f"{_host_ip()}:{master.port}"
    master.aux_services.append(
        ScalePlanWatcher(args.job_name, client, job_manager)
    )
    master.aux_services.append(
        AllreduceAutoScaler(
            job_manager, master.speed_monitor,
            optimizer=LocalOptimizer(), min_nodes=1,
            max_nodes=args.node_num,
        )
    )
    return master


def run(args) -> int:
    if args.journal_mirror_dir:
        # the journal reads the mirror dir from env at construction;
        # exporting the flag covers every platform's create path
        os.environ[JOURNAL_MIRROR_DIR_ENV] = args.journal_mirror_dir
    master = create_master(args)

    def _graceful_exit(signum, _frame):
        # a supervisor's SIGTERM is a planned shutdown: wake the run
        # loop so it snapshots the journal and emits master_exit
        # (goodput, final step) instead of dying mid-state
        logger.info("signal %s: stopping master", signum)
        master._stop.set()

    try:
        signal.signal(signal.SIGTERM, _graceful_exit)
    except ValueError:  # pragma: no cover - non-main thread (tests)
        pass
    master.prepare()
    return master.run()


def main(argv=None) -> int:
    args = parse_args(argv)
    logger.info("starting master with %s", vars(args))
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
