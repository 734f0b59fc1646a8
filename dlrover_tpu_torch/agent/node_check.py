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

Copy of ``dlrover_tpu/agent/node_check.py``: the fault injection
(``mock_error``, ``mock_straggle``), the master-KV barrier
(``bm_sync_barrier``) and the check's driver (``run_node_check``).
The probes that run on the accelerator — the per-chip matmul, the
collective probe and the fabric bandwidth report — come with slice 8
of the port (a bf16 GEMM on each GPU and an NCCL all-reduce) and raise
``NotImplementedError`` until then, so a network-check rendezvous
reports the node abnormal instead of passing it unprobed.
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

_PROBE_SLICE = (
    "the node check's {} comes with slice 8 of the port (NCCL and "
    "GEMM probes on the GPU)"
)

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


def bm_chip_matmul(size: int = 1024, rounds: int = 8) -> float:
    """Time a bf16 matmul chain on every local device (reference:
    a jitted bf16 chain on each TPU chip's MXU)."""
    raise NotImplementedError(_PROBE_SLICE.format("per-chip matmul probe"))


def bm_collective_probe(
    payload_floats: int = 1 << 22, rounds: int = 2,
) -> Optional[float]:
    """Timed all-reduce + ring exchange over every visible device
    (reference: psum + ppermute over the TPU mesh)."""
    raise NotImplementedError(_PROBE_SLICE.format("collective probe"))


def comm_perf_check(
    payload_floats: int = 1 << 24, rounds: int = 4,
) -> Optional[dict]:
    """Fabric bandwidth report (algbw/busbw of a timed all-reduce)."""
    raise NotImplementedError(
        _PROBE_SLICE.format("fabric bandwidth report")
    )


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
) -> float:
    """Full check: fault injection hook, chip matmul, sync probe.

    Returns elapsed seconds; raises on chip failure so the caller
    reports abnormal status.
    """
    client = client or MasterClient.singleton()
    node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
    with trace.span(
        "node_check", round=round_id, node_rank=node_rank
    ) as check_span:
        return _run_node_check(
            client, matmul_size, world_size, round_id, check_span
        )


def _run_node_check(
    client, matmul_size, world_size, round_id, check_span
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
    # per-node WORK timer (the reference reports per-node work time,
    # node_check/utils.py:25-46): injected or real chip slowness lands
    # in THIS node's number only
    work_start = time.perf_counter()
    mock_straggle()
    bm_chip_matmul(size=matmul_size)
    elapsed = time.perf_counter() - work_start
    # fabric probe over every visible device — with a live
    # torch.distributed group this crosses hosts (NVLink/network).  Timed
    # SEPARATELY from the work phase: a global collective completes at
    # the pace of its slowest participant, so folding it into elapsed
    # would inflate every healthy node's number and mask attribution.
    bm_collective_probe()
    if world_size > 1:
        # EXIT barrier: synchronizes the round across nodes and fails
        # when a peer is dead
        wait = bm_sync_barrier(client, round_id, world_size)
        logger.info("exit barrier wait %.3fs (not counted)", wait)
    _CHECK_SECONDS.observe(elapsed)
    check_span.set_attribute("elapsed_s", round(elapsed, 4))
    emit_event(
        "node_check", round=round_id,
        elapsed_s=round(elapsed, 4), world_size=world_size,
    )
    logger.info("node check elapsed %.3fs", elapsed)
    return elapsed
