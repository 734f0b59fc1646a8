"""``python -m dlrover_tpu_torch.chaos`` — scenario runner CLI.

Runs a built-in or file-provided scenario through the mini-cluster
harness and prints the fault timeline + invariant report; exit code 0
iff the job finished AND every invariant held.

Examples::

    python -m dlrover_tpu_torch.chaos --list
    python -m dlrover_tpu_torch.chaos --scenario kill_worker_midstep --seed 7
    python -m dlrover_tpu_torch.chaos --spec my_scenario.yaml --steps 20

Copy of ``dlrover_tpu/chaos/__main__.py``, for the scenarios the port
has (the single-node harness, ``chaos/scenarios.py``).  The
multi-agent runner (``--nnodes`` > 1) comes with slice 4.2 of the port,
the serving runners with slice 9.
"""

import argparse
import json
import sys
import tempfile
from typing import List, Optional

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.chaos.schedule import load_scenario


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.chaos",
        description="deterministic fault-injection scenario runner",
    )
    src = parser.add_mutually_exclusive_group()
    src.add_argument(
        "--scenario", type=str, default="",
        help="built-in scenario name (see --list)",
    )
    src.add_argument(
        "--spec", type=str, default="",
        help="scenario YAML/JSON file (or inline JSON)",
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="override the scenario seed",
    )
    parser.add_argument(
        "--workdir", type=str, default="",
        help="run directory (default: fresh temp dir)",
    )
    parser.add_argument(
        "--steps", type=int, default=None,
        help="step budget (default: the scenario's RUN_OPTIONS "
        "entry, else 10)",
    )
    parser.add_argument("--ckpt-every", type=int, default=None)
    parser.add_argument("--max-restarts", type=int, default=2)
    parser.add_argument(
        "--nnodes", type=int, default=1,
        help=">1 runs the multi-agent harness (one journal-backed "
        "master + N launcher processes), which comes with slice 4.2 "
        "of the port",
    )
    parser.add_argument(
        "--warm-restart", action="store_true",
        help="fork restarted workers from the warm template",
    )
    parser.add_argument(
        "--list", action="store_true", dest="list_scenarios",
        help="list built-in scenarios and exit",
    )
    parser.add_argument(
        "--show", action="store_true",
        help="print the resolved scenario spec and exit",
    )
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.list_scenarios:
        for name in sorted(scenarios.SCENARIOS):
            doc = (scenarios.SCENARIOS[name].__doc__ or "").strip()
            print(f"{name}: {doc.splitlines()[0] if doc else ''}")
        return 0
    if args.spec:
        scenario = load_scenario(args.spec)
        if args.seed is not None:
            scenario.seed = args.seed
    else:
        name = args.scenario or "kill_worker_midstep"
        scenario = scenarios.build(name, seed=args.seed)
    if args.show:
        print(json.dumps(scenario.to_dict(), indent=2))
        return 0
    workdir = args.workdir or tempfile.mkdtemp(prefix="dlrover_chaos_")
    print(
        f"running scenario {scenario.name!r} (seed {scenario.seed}) "
        f"in {workdir}"
    )
    if args.nnodes > 1:
        raise NotImplementedError(
            "the multi-agent chaos harness (--nnodes > 1) comes with "
            "slice 4.2 of the port"
        )
    report = harness.run_scenario(
        scenario,
        workdir=workdir,
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        max_restarts=args.max_restarts,
        warm_restart=args.warm_restart,
    )
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
