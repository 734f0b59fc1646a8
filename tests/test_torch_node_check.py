"""Twins of ``tests/test_node_check.py`` for the port's node check.

The probes that run on the accelerator (the collective probe, the
per-chip matmul, the fabric bandwidth report) come with slice 8 of the
port and raise ``NotImplementedError`` naming it; the first two twins
pin that, and that ``run_node_check`` stops there (so a network-check
rendezvous reports the node abnormal instead of passing it unprobed).
The third twin keeps the reference's multi-process straggler
isolation with what the port's check already has: the injected
straggle timed as each node's work between the master-KV barriers,
reported to the port's master, whose >2x-median rule must isolate the
slow rank alone.  Every check is exact.
"""

import os
import subprocess
import sys

import pytest

from dlrover_tpu_torch.agent.node_check import (
    bm_chip_matmul,
    bm_collective_probe,
    comm_perf_check,
    run_node_check,
)
from dlrover_tpu_torch.master.master import JobMaster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_collective_probe_comes_with_slice_8():
    with pytest.raises(NotImplementedError, match="slice 8"):
        bm_collective_probe(payload_floats=1 << 16, rounds=2)
    with pytest.raises(NotImplementedError, match="slice 8"):
        comm_perf_check()


def test_single_node_check_stops_at_the_chip_probe(monkeypatch):
    """One node: no barrier, the chip probe raises naming slice 8."""
    monkeypatch.setenv("DLROVER_NODE_RANK", "0")
    with pytest.raises(NotImplementedError, match="slice 8"):
        bm_chip_matmul(size=64, rounds=1)
    with pytest.raises(NotImplementedError, match="slice 8"):
        run_node_check(client=object(), world_size=1, round_id=0)


CHILD = r"""
import os, sys, time
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.node_check import (
    bm_sync_barrier, mock_straggle, run_node_check,
)
from dlrover_tpu_torch.common.constants import RendezvousName

rank = int(os.environ["DLROVER_NODE_RANK"])
client = MasterClient(sys.argv[1], node_id=rank, node_type="worker")
client.join_rendezvous(rank, 1, RendezvousName.NETWORK_CHECK)
deadline = time.time() + 60
while time.time() < deadline:
    _, _, world, _ = client.get_comm_world(
        RendezvousName.NETWORK_CHECK, rank
    )
    if len(world) >= 3:
        break
    time.sleep(0.2)
try:
    run_node_check(client=client, world_size=3, round_id=0)
    sys.exit("run_node_check passed a node it did not probe")
except NotImplementedError as e:
    assert "slice 8" in str(e), e
# the work phase the port already has, between its barriers
bm_sync_barrier(client, "1_entry", 3)
start = time.perf_counter()
mock_straggle()
elapsed = time.perf_counter() - start
bm_sync_barrier(client, 1, 3)
client.report_network_status(rank, True, elapsed)
print(f"rank {rank} elapsed {elapsed:.3f}", flush=True)
"""


def test_injected_straggler_isolated_via_check_timings(tmp_path):
    master = JobMaster(port=0, node_num=3, job_name="ncheck")
    master.network_rdzv.update_rdzv_params(min_nodes=3, max_nodes=3)
    master.prepare()
    try:
        addr = f"127.0.0.1:{master.port}"
        procs = []
        for rank in range(3):
            env = dict(
                os.environ,
                DLROVER_NODE_RANK=str(rank),
                PYTHONPATH=ROOT,
                MOCK_STRAGGLER_RANK="1",
                MOCK_STRAGGLER_DELAY="2.0",
                DLROVER_SHARED_DIR=str(tmp_path / "sockets"),
            )
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, addr],
                env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        for p in procs:
            out, _ = p.communicate(timeout=150)
            assert p.returncode == 0, out
        stragglers, median = master.network_rdzv.detect_stragglers()
        assert stragglers == [1], (stragglers, median)
    finally:
        master.stop()
