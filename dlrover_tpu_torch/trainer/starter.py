"""Platform worker starter: env contract -> launcher invocation.

Copy of ``dlrover_tpu/trainer/starter.py`` (reference:
``dlrover/trainer/platform/starter.py:94`` +
``worker/tf_kubernetes_worker.py`` / ``tf_ray_worker.py``: scheduled
containers/actors boot through one entry that reads the platform's
env contract and launches the elastic agent).  It turns the
``NodeEnv`` variables the scaler injected into a command line of the
port's launcher, ``python -m dlrover_tpu_torch.run``, so a pod/actor
spec only needs ``python -m dlrover_tpu_torch.trainer.starter --
<train.py> [args...]``.  Like the launcher, it loads no torch.
"""

import argparse
import os
import sys
from typing import List, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger


def build_run_argv(
    script_and_args: List[str],
    env: Optional[dict] = None,
) -> List[str]:
    """Env contract -> launcher argv (testable seam)."""
    env = env if env is not None else dict(os.environ)
    argv: List[str] = []
    node_num = env.get(NodeEnv.NODE_NUM, "1")
    min_nodes = env.get("DLROVER_MIN_NODES", node_num)
    max_nodes = env.get("DLROVER_MAX_NODES", node_num)
    argv += ["--nnodes", f"{min_nodes}:{max_nodes}"]
    argv += [
        "--nproc_per_node",
        env.get(NodeEnv.LOCAL_WORLD_SIZE, "1"),
    ]
    node_rank = env.get(NodeEnv.NODE_RANK, "")
    if node_rank:
        argv += ["--node_rank", node_rank]
    if env.get("DLROVER_NETWORK_CHECK", "") in ("1", "true"):
        argv += ["--network-check"]
    argv += script_and_args
    return argv


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="dlrover_tpu_torch platform worker starter"
    )
    parser.add_argument("script_and_args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)
    rest = list(ns.script_and_args)
    if rest and rest[0] == "--":  # only the leading separator
        rest = rest[1:]
    if not rest:
        parser.error("training script required after --")
    master_addr = os.getenv(NodeEnv.MASTER_ADDR, "")
    logger.info(
        "starter: node %s of job %s (master %s)",
        os.getenv(NodeEnv.NODE_RANK, "?"),
        os.getenv(NodeEnv.JOB_NAME, "?"),
        master_addr or "<local>",
    )
    from dlrover_tpu_torch.run import main as run_main

    return run_main(build_run_argv(rest))


if __name__ == "__main__":
    sys.exit(main())
