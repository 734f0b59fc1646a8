"""Twins of ``tests/test_node_check.py`` for the port's node check.

The probes run for real: the collective probe and the bandwidth report
on a 2-rank gloo group (two processes on this box; NCCL on the cards),
``None`` on a world of one as the reference's on one device; the
single-node check runs its bf16 GEMM chain on the CPU when told to;
without a group the fabric probe spawns one over the host's devices
(two gloo ranks here); ``python -m dlrover_tpu_torch.run
--network-check`` reports a node without a GPU faulty and never
trains, and on the cards (marked ``cuda``) passes the node after
probing each GPU and, with two or more, all of them together;
and the reference's multi-process straggler isolation: three nodes run
``run_node_check`` (GEMM probe on the CPU) between the master-KV
barriers, report to the port's master, whose >2x-median rule must
isolate the injected slow rank alone.  The bandwidth report keeps the
reference's formula (busbw = algbw * 2(n-1)/n, on the per-rank message)
and its keys, held against the JAX package's report at the same world
and payload.  Every check is exact.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from dlrover_tpu_torch.agent.node_check import (
    bm_collective_probe,
    comm_perf_check,
    local_collective_probe,
    run_node_check,
)
from dlrover_tpu_torch.common.comm import find_free_port
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.telemetry.events import read_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GLOO_CHILD = r"""
import json, sys
import torch.distributed as dist
from dlrover_tpu_torch.agent.node_check import (
    bm_collective_probe, comm_perf_check,
)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
probe = bm_collective_probe(payload_floats=1 << 16, rounds=2)
report = comm_perf_check(payload_floats=1 << 16, rounds=2)
dist.destroy_process_group()
print(json.dumps({"probe": probe, "report": report}), flush=True)
"""


def _gloo_world(world: int):
    port = str(find_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_CHILD, str(r), str(world), port],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_collective_probe_comes_with_slice_8():
    """The fabric probes (a deferral until slice 8.1): a timed
    all-reduce + ring exchange and the bandwidth report over a 2-rank
    gloo group; no group, no probe."""
    assert bm_collective_probe(payload_floats=1 << 16) is None
    assert comm_perf_check(payload_floats=1 << 16) is None
    for out in _gloo_world(2):
        assert out["probe"] is not None and out["probe"] > 0
        rep = out["report"]
        assert rep["devices"] == 2
        assert rep["payload_bytes"] == (1 << 16) // 2 * 4
        assert rep["allreduce_s"] > 0
        assert rep["busbw_gbps"] == pytest.approx(
            rep["algbw_gbps"] * 2 * (2 - 1) / 2, abs=1e-3)


def test_comm_report_matches_the_jax_report(monkeypatch):
    """The same keys, world and per-rank payload as the JAX package's
    ``comm_perf_check`` over two of its devices (times differ)."""
    import jax

    from dlrover_tpu.agent import node_check as jax_check

    two = jax.devices()[:2]
    if len(two) < 2:
        pytest.skip("the JAX side needs two devices")
    monkeypatch.setattr(jax, "devices", lambda: two)
    want = jax_check.comm_perf_check(payload_floats=1 << 16, rounds=2)
    got = _gloo_world(2)[0]["report"]
    assert set(got) == set(want)
    assert (got["devices"], got["payload_bytes"]) == (
        want["devices"], want["payload_bytes"])


def test_single_node_check_stops_at_the_chip_probe(monkeypatch, tmp_path):
    """One node, no barrier: the check runs the GEMM chain on the
    device it is told (the CPU here), the collective probe finds no
    group, and the ``node_check`` event carries the probes' numbers."""
    from dlrover_tpu_torch.telemetry.events import read_events

    events = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("DLROVER_NODE_RANK", "0")
    monkeypatch.setenv("DLROVER_EVENT_LOG", events)
    elapsed = run_node_check(client=object(), world_size=1, round_id=0,
                             matmul_size=64, device="cpu")
    assert elapsed > 0
    ev = [e for e in read_events(events) if e.get("type") == "node_check"]
    assert len(ev) == 1 and ev[0]["matmul_s"] > 0
    assert ev[0]["collective_s"] is None
    assert ev[0]["matmul_flops"] == 8 * 4 * 2 * 64 ** 3


def test_local_collective_probe_groups_the_hosts_devices():
    """No process group: the probe spawns one over the devices it is
    given, one rank each (gloo for two CPU ranks here, NCCL over the
    GPUs in the node check), and reports rank 0's time; one device,
    nothing to probe."""
    cpu = torch.device("cpu")
    assert local_collective_probe([cpu], payload_floats=1 << 16) is None
    elapsed = local_collective_probe([cpu, cpu], payload_floats=1 << 16)
    assert elapsed is not None and elapsed > 0


TRAIN = r"""
import os
open(os.environ["TRAINED"], "w").write("trained")
"""


def _launch_network_check(tmp_path, env=()):
    """``python -m dlrover_tpu_torch.run --network-check`` over a script
    that only marks that it ran: ``(rc, trained, events, output)``."""
    script = tmp_path / "train.py"
    script.write_text(TRAIN)
    events = tmp_path / "events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run", "--network-check",
         str(script)],
        env=dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path),
                 TRAINED=str(tmp_path / "trained"),
                 DLROVER_EVENT_LOG=str(events),
                 DLROVER_SHARED_DIR=str(tmp_path / "sockets"), **dict(env)),
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    return (proc.returncode, (tmp_path / "trained").exists(),
            read_events(str(events)), proc.stdout + proc.stderr)


def test_network_check_fails_a_node_without_a_gpu(tmp_path):
    """No card visible: the check's GEMM probe raises, the node is
    diagnosed faulty and the launcher exits without training (no CPU
    stands in for the GPUs)."""
    rc, trained, events, out = _launch_network_check(
        tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert rc != 0 and not trained, out[-3000:]
    assert "diagnosed faulty" in out
    spans = [e for e in events if e.get("type") == "span"
             and e.get("name") == "node_check"]
    assert spans and spans[0]["status"] == "error"
    assert "no CUDA device" in spans[0]["attributes"]["error"]
    assert not [e for e in events if e.get("type") == "node_check"]


@pytest.mark.cuda
def test_network_check_probes_every_local_gpu(tmp_path):
    """On the cards: one round, the node normal, the GEMM chain timed on
    every GPU, the fabric probe over a group of all of them (None on a
    host with one GPU, as the reference's on one chip), then the
    training script runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, trained, events, out = _launch_network_check(tmp_path)
    assert rc == 0 and trained, out[-3000:]
    checks = [e for e in events if e.get("type") == "node_check"]
    assert len(checks) == 1 and checks[0]["matmul_s"] > 0, checks
    print(f"network check on {torch.cuda.device_count()} GPUs: "
          f"{json.dumps(checks[0])}")
    if torch.cuda.device_count() < 2:
        assert checks[0]["collective_s"] is None
    else:
        assert checks[0]["collective_s"] > 0


CHILD = r"""
import os, sys, time
import torch  # as the agent's check child: the import is not timed
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.node_check import run_node_check
from dlrover_tpu_torch.common.constants import RendezvousName

rank = int(os.environ["DLROVER_NODE_RANK"])
client = MasterClient(sys.argv[1], node_id=rank, node_type="worker")
client.join_rendezvous(rank, 1, RendezvousName.NETWORK_CHECK)
# wait for the full world so every node's timer starts together
deadline = time.time() + 60
while time.time() < deadline:
    _, _, world, _ = client.get_comm_world(
        RendezvousName.NETWORK_CHECK, rank
    )
    if len(world) >= 3:
        break
    time.sleep(0.2)
normal, elapsed = True, 0.0
try:
    elapsed = run_node_check(
        client=client, world_size=3, round_id=0, matmul_size=128,
        device="cpu",
    )
except Exception as e:
    print("check failed:", e, flush=True)
    normal = False
client.report_network_status(rank, normal, elapsed)
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
