"""Node health-check payload: per-chip compute benchmark + fabric
probe.

Reference: ``dlrover/trainer/torch/node_check/{utils,nvidia_gpu}.py``
(matmul + 2^24-float allreduce per round, ``utils.py:57-105``) driven
by ``NodeCheckElasticAgent`` (``elastic_agent/torch/training.py:864``).
On TPU the per-chip probe is a jitted bf16 matmul on every local
device (exercises MXU + HBM); the fabric probe is a timed
psum + ring-ppermute collective over every visible device — riding
ICI within a slice, DCN across slices.  A KV-store barrier against
the master synchronizes rounds and catches dead peers (its wait time
is excluded from the reported number so a slow peer cannot mask
itself).  Elapsed time feeds the master's
NetworkCheckRendezvousManager, which isolates fault nodes and
stragglers (>2x median, rdzv_manager.py:550) over two pairwise
regrouping rounds.

Fault injection: ``MOCK_ERR_RANK`` makes the matching node rank raise
(mirrors ``node_check/utils.py:49 mock_error()``);
``MOCK_STRAGGLER_RANK``/``MOCK_STRAGGLER_DELAY`` make a rank slow —
the chaos experiment of ``docs/tech_report/fault_tolerance_exps.md``.

Copy of ``dlrover_tpu/agent/node_check.py``.  On the GPU the per-chip
probe is a chain of bf16 GEMMs on each local card, timed with CUDA
events; the fabric probe and the bandwidth report are a timed
all-reduce and a ring exchange (``send``/``recv`` to the neighbour)
over the default ``torch.distributed`` process group — NCCL on the
cards, gloo on the CPU — and return None on a world of one, as the
reference's do on one device.  The agent runs the check in a child
process (:func:`run_node_check_in_child`), so the agent itself never
loads torch or holds a card.  That child has no process group of its
own: it probes a group of the host's GPUs, one process on each
(:func:`local_collective_probe`), as the reference's psum covers every
local chip; on a host with one GPU there is nothing to probe (None).
"""

import os
import time
from typing import Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing as trace
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_CHECK_SECONDS = _REG.histogram(
    "dlrover_node_check_seconds",
    "Per-node health-check work time (barrier waits excluded)",
)
_BARRIER_SECONDS = _REG.histogram(
    "dlrover_node_check_barrier_seconds",
    "Node-check barrier wait (dead/slow-peer indicator)",
)


def mock_error():
    """Raise if this node rank is marked faulty (test fault injection)."""
    err_rank = os.getenv(NodeEnv.MOCK_ERR_RANK, "")
    if err_rank and int(err_rank) == int(os.getenv(NodeEnv.NODE_RANK, "0")):
        raise RuntimeError(f"mock error on rank {err_rank}")


def mock_straggle():
    """Sleep if this node rank is marked slow (straggler injection)."""
    slow_rank = os.getenv("MOCK_STRAGGLER_RANK", "")
    if slow_rank and int(slow_rank) == int(
        os.getenv(NodeEnv.NODE_RANK, "0")
    ):
        delay = float(os.getenv("MOCK_STRAGGLER_DELAY", "3.0"))
        logger.info("injected straggle: sleeping %.1fs", delay)
        time.sleep(delay)


def _local_devices(device=None) -> list:
    """Every local GPU, or the one ``device`` named."""
    import torch

    if device is not None:
        return [torch.device(device)]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the node check probes the GPUs unless "
            "device='cpu' is passed explicitly"
        )
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def matmul_flops(size: int = 1024, rounds: int = 8) -> int:
    """FLOPs of one device's :func:`bm_chip_matmul` chain: ``rounds``
    rounds of 4 products of two ``size``-square matrices."""
    return rounds * 4 * 2 * size ** 3


def bm_chip_matmul(size: int = 1024, rounds: int = 8,
                   device=None) -> float:
    """Time a bf16 matmul chain on every local GPU (or on ``device``).

    A straggling or faulty card shows up as a slow or failing device;
    the bf16 products run on the tensor cores (``torch.matmul``: the
    reference computes them with jnp, outside any Pallas kernel), timed
    between CUDA events after one untimed warm-up chain, so this
    measures the card, not Python.  Returns the seconds summed over the
    devices; FLOPs per device: :func:`matmul_flops`.
    """
    import torch

    elapsed = 0.0
    for dev in _local_devices(device):
        x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)

        def chain(a):
            for _ in range(4):
                a = a @ a / size
            return a

        chain(x)  # cuBLAS handle and workspace outside the timer
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(rounds):
                    x = chain(x)
                end.record()
                end.synchronize()
                elapsed += start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(rounds):
                x = chain(x)
            elapsed += time.perf_counter() - t0
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"matmul probe on {dev}: non-finite result")
    return elapsed


def _group():
    """``(world size, rank, device)`` of the default process group,
    or None where there is none."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return dist.get_world_size(), dist.get_rank(), device


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bm_collective_probe(
    payload_floats: int = 1 << 22, rounds: int = 2,
) -> Optional[float]:
    """Timed all-reduce + ring exchange over the default process group
    (NCCL on the cards, gloo on the CPU).

    The honest fabric probe (reference: ``bm_allreduce``/
    ``bm_allgather``, node_check/utils.py:57-105; the JAX package's
    psum + ring ppermute over its mesh): the payload crosses NVLink
    and the network, so a degraded link or card inflates this node's
    elapsed time.  Each round all-reduces the block, then sends it to
    the next rank and receives the previous one's.  Returns None with
    fewer than two ranks (no group to probe; the master-mediated
    barrier in ``run_node_check`` still provides cross-node liveness).
    """
    import torch
    import torch.distributed as dist

    group = _group()
    if group is None or group[0] < 2:
        return None
    n, rank, device = group
    per = max(128, payload_floats // n)

    def step(block):
        dist.all_reduce(block)  # allreduce
        out = torch.empty_like(block)
        for req in dist.batch_isend_irecv([  # neighbour links
            dist.P2POp(dist.isend, block, (rank + 1) % n),
            dist.P2POp(dist.irecv, out, (rank - 1) % n),
        ]):
            req.wait()
        return out

    out = step(torch.ones(per, dtype=torch.float32, device=device))
    _sync(device)
    start = time.perf_counter()
    for _ in range(rounds):
        out = step(out / n)
    _sync(device)
    elapsed = time.perf_counter() - start
    logger.info(
        "collective probe: %d ranks, %d floats, %d rounds in %.3fs",
        n, per * n, rounds, elapsed,
    )
    return elapsed


def local_collective_probe(
    devices, payload_floats: int = 1 << 22, rounds: int = 2,
) -> Optional[float]:
    """:func:`bm_collective_probe` over a group of this host's
    ``devices``, one spawned process on each (NCCL on cards, gloo on
    the CPU), for a caller that has no process group: the reference's
    psum over every local chip.  Returns rank 0's seconds, or None
    with fewer than two devices."""
    import torch.multiprocessing as mp

    from dlrover_tpu_torch.common.comm import find_free_port

    if len(devices) < 2:
        return None
    results = mp.get_context("spawn").SimpleQueue()
    mp.spawn(
        _probe_rank, nprocs=len(devices), join=True,
        args=(list(devices), find_free_port("127.0.0.1"), payload_floats,
              rounds, results),
    )
    return results.get()


def _probe_rank(rank, devices, port, payload_floats, rounds, results):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    backend = "gloo"
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=len(devices), timeout=timedelta(seconds=120),
    )
    try:
        elapsed = bm_collective_probe(payload_floats, rounds)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        results.put(elapsed)


def comm_perf_check(
    payload_floats: int = 1 << 24, rounds: int = 4,
) -> Optional[dict]:
    """Fabric bandwidth report: algbw/busbw of a timed all-reduce over
    the default process group (reference: ``comm_perf_check`` +
    ``bm_allreduce``'s busbw accounting, node_check/utils.py:57-105 —
    busbw = algbw * 2(n-1)/n for a ring allreduce).  None with fewer
    than two ranks."""
    import torch
    import torch.distributed as dist

    group = _group()
    if group is None or group[0] < 2:
        return None
    n, _rank, device = group
    per = max(128, payload_floats // n)
    out = torch.ones(per, dtype=torch.float32, device=device)
    dist.all_reduce(out)
    out /= n
    _sync(device)
    start = time.perf_counter()
    for _ in range(rounds):
        dist.all_reduce(out)
        out /= n
    _sync(device)
    elapsed = (time.perf_counter() - start) / rounds
    # per-rank message size is what bandwidth math divides by (each
    # rank reduces its own `per`-float block), matching the reference
    # busbw convention (utils.py bm_allreduce)
    message_bytes = per * 4
    algbw = message_bytes / max(elapsed, 1e-9)
    busbw = algbw * 2 * (n - 1) / n
    report = {
        "devices": n,
        "payload_bytes": message_bytes,
        "allreduce_s": round(elapsed, 6),
        "algbw_gbps": round(algbw / 1e9, 3),
        "busbw_gbps": round(busbw / 1e9, 3),
    }
    logger.info("comm perf: %s", report)
    return report


def bm_sync_barrier(
    client: MasterClient, round_id: int, world_size: int,
    timeout: float = 300.0,
) -> float:
    """All-nodes barrier through the master KV store.

    A liveness/sync gate, not a performance number: it synchronizes
    check rounds across nodes and raises when a peer never arrives
    (dead node -> this node reports abnormal).  Its wait time is
    deliberately NOT part of the reported elapsed — a slow peer would
    inflate every healthy node's number and mask the actual straggler.
    """
    key = f"node_check_barrier_{round_id}"
    start = time.perf_counter()
    client.kv_store_add(key, 1)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if client.kv_store_add(key, 0) >= world_size:
            wait = time.perf_counter() - start
            _BARRIER_SECONDS.observe(wait)
            return wait
        time.sleep(0.1)
    raise TimeoutError(f"node-check barrier round {round_id} timed out")


def run_node_check(
    client: Optional[MasterClient] = None,
    matmul_size: int = 1024,
    world_size: int = 1,
    round_id: int = 0,
    device=None,
) -> float:
    """Full check: fault injection hook, chip matmul, sync probe.

    Returns elapsed seconds; raises on chip failure so the caller
    reports abnormal status.  The matmul probe runs on every local GPU,
    or on ``device`` where one is named.
    """
    client = client or MasterClient.singleton()
    node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
    with trace.span(
        "node_check", round=round_id, node_rank=node_rank
    ) as check_span:
        return _run_node_check(
            client, matmul_size, world_size, round_id, check_span, device
        )


def _run_node_check(
    client, matmul_size, world_size, round_id, check_span, device=None
) -> float:
    mock_error()
    if world_size > 1:
        # ENTRY barrier: align the start of the timed work phase so a
        # peer that arrives late (slow boot, slow previous round)
        # cannot leak into other nodes' work numbers
        wait = bm_sync_barrier(
            client, f"{round_id}_entry", world_size
        )
        logger.info("entry barrier wait %.3fs (not counted)", wait)
    devices = _local_devices(device)
    # per-node WORK timer (the reference reports per-node work time,
    # node_check/utils.py:25-46): injected or real chip slowness lands
    # in THIS node's number only
    work_start = time.perf_counter()
    mock_straggle()
    matmul_s = bm_chip_matmul(size=matmul_size, device=device)
    elapsed = time.perf_counter() - work_start
    # fabric probe over the default process group — with a live
    # torch.distributed group this crosses hosts (NVLink/network) —
    # or, without one, over a group of this host's devices.  Timed
    # SEPARATELY from the work phase: a global collective completes at
    # the pace of its slowest participant, so folding it into elapsed
    # would inflate every healthy node's number and mask attribution.
    if _group() is not None:
        collective_s = bm_collective_probe()
    else:
        collective_s = local_collective_probe(devices)
    if world_size > 1:
        # EXIT barrier: synchronizes the round across nodes and fails
        # when a peer is dead
        wait = bm_sync_barrier(client, round_id, world_size)
        logger.info("exit barrier wait %.3fs (not counted)", wait)
    _CHECK_SECONDS.observe(elapsed)
    check_span.set_attribute("elapsed_s", round(elapsed, 4))
    # the probes' own numbers ride along (the reference's event has
    # the first three fields)
    emit_event(
        "node_check", round=round_id,
        elapsed_s=round(elapsed, 4), world_size=world_size,
        matmul_s=matmul_s, matmul_size=matmul_size,
        matmul_flops=matmul_flops(matmul_size),
        collective_s=collective_s,
    )
    logger.info("node check elapsed %.3fs", elapsed)
    return elapsed


def run_node_check_in_child(
    client: MasterClient,
    world_size: int = 1,
    round_id: int = 0,
    matmul_size: int = 1024,
    timeout: float = 600.0,
) -> float:
    """:func:`run_node_check` in a child process
    (``python -m dlrover_tpu_torch.agent.node_check``), its barriers
    against ``client``'s master: the agent loads no torch and never
    holds the card, so the probes run where a CUDA context can end
    with them (the reference runs them in the agent, on the TPU's
    runtime).  Returns the child's elapsed seconds; raises when the
    check failed there."""
    import json
    import subprocess
    import sys

    import dlrover_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(dlrover_tpu_torch.__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
    )
    argv = [sys.executable, "-m", "dlrover_tpu_torch.agent.node_check",
            client.master_addr, str(client.node_id), str(world_size),
            str(round_id), str(matmul_size)]
    proc = subprocess.run(
        argv, env=env, capture_output=True, text=True, timeout=timeout,
        check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"node check child exited {proc.returncode}: "
            f"{proc.stderr.strip()[-2000:]}"
        )
    return float(json.loads(proc.stdout.strip().splitlines()[-1])["elapsed"])


def _child_main(argv) -> int:
    import json

    # torch's import stays out of the timed work phase
    import torch  # noqa: F401

    from dlrover_tpu_torch.telemetry.events import set_event_source

    set_event_source("agent")
    addr, node_id, world_size, round_id, matmul_size = argv
    client = MasterClient(addr, node_id=int(node_id), node_type="worker")
    try:
        elapsed = run_node_check(
            client=client, matmul_size=int(matmul_size),
            world_size=int(world_size), round_id=int(round_id),
        )
    finally:
        client.close()
    print(json.dumps({"elapsed": elapsed}), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_child_main(sys.argv[1:]))
