"""Subprocess host for a pack of synthetic agents.

In-process agent threads are fine for a smoke test, but at hundreds
of agents they fight the MASTER for the GIL — the scoreboard ends up
measuring the harness, not the control plane.  Pack mode moves the
agents out: the runner spawns a few of these processes, each hosting
``--count`` agent threads, and reads their op/error accounting from
the atomically-rewritten ``--stats`` JSON file.  A pack runs until
SIGTERM/SIGINT (or until orphaned) and drains its agents cleanly.

Runnable standalone against any master::

    python -m dlrover_tpu_torch.fleet.agent_pack \
        --addr 127.0.0.1:12345 --start-id 0 --count 50 \
        --stats /tmp/pack0.json

Copy of ``dlrover_tpu/fleet/agent_pack.py`` (the port imports nothing of
the JAX package); host code, as in the reference.
"""

import argparse
import json
import os
import signal
import sys
import threading
import time

from dlrover_tpu_torch.fleet.synthetic_agent import (
    AgentProfile,
    SyntheticAgent,
)


def _write_stats(path: str, agents, ready: bool):
    ops = {}
    errors = {}
    resyncs = 0
    for a in agents:
        for verb, c in a.stats.ops.items():
            ops[verb] = ops.get(verb, 0) + c
        for verb, c in a.stats.errors.items():
            errors[verb] = errors.get(verb, 0) + c
        resyncs += a.stats.resyncs
    doc = {
        "agents": len(agents),
        "ready": ready,
        "ops": ops,
        "errors": errors,
        "resyncs": resyncs,
        "pid": os.getpid(),
        "ts": time.time(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="host a pack of synthetic fleet agents"
    )
    parser.add_argument("--addr", required=True)
    parser.add_argument("--start-id", type=int, required=True)
    parser.add_argument("--count", type=int, required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument(
        "--profile", default="{}",
        help="AgentProfile fields as JSON",
    )
    parser.add_argument("--stagger-s", type=float, default=0.005)
    parser.add_argument(
        "--stats-interval-s", type=float, default=0.5
    )
    args = parser.parse_args(argv)

    profile = AgentProfile(**json.loads(args.profile))
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())

    agents = []
    for i in range(args.count):
        agent = SyntheticAgent(
            args.addr, node_id=args.start_id + i, profile=profile
        )
        agent.start()
        agents.append(agent)
        if args.stagger_s > 0:
            time.sleep(args.stagger_s)
    _write_stats(args.stats, agents, ready=True)

    while not stop.wait(args.stats_interval_s):
        if os.getppid() == 1:
            break  # orphaned: the runner died without cleanup
        try:
            _write_stats(args.stats, agents, ready=True)
        except OSError:
            pass
    for agent in agents:
        agent._stop.set()
    for agent in agents:
        agent.stop(join_timeout=2.0)
    try:
        _write_stats(args.stats, agents, ready=False)
    except OSError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
