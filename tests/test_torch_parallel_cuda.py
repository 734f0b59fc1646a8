"""Sequence and expert parallelism over NCCL on several GPUs (``cuda``).

Run on a host with 2-4 GPUs:

    python3 -m pytest -q -m cuda -s tests/test_torch_parallel_cuda.py

No JAX here: the references are the port's own whole-sequence kernels
and its one-GPU run.  Each test spawns one process per GPU of this file
(``--worker``; NCCL over ``tcp://127.0.0.1:<free port>``):

- the ring (``ring_attention``, B1-B3 per block) and Ulysses with the
  flash kernels inside, causal, bf16, at Llama-3-8B's attention shape
  (32 q heads over 8 kv heads, d 128) with 8192 tokens a rank, at 2 and
  4 GPUs: rank 0 gathers O, dQ, dK and dV and holds them against the
  whole sequence through B1-B3 on its own GPU by ||got - want|| /
  ||want|| within 8 bf16 unit roundoffs (``chip_smoke.py`` phase 13a's
  limit); the ring's forward and backward are timed beside the whole
  sequence's;
- Mixtral-8x7B at full width cut to 2 layers (batch 8 x 1024, the
  reference's strategy plus flash) at expert 4 on four GPUs against
  expert 1 on rank 0's GPU alone, the same batch, 3 steps of AdamW:
  the first loss within 1e-3 relative, the others within 1e-2.
"""

import json
import os
import sys
import time

import pytest

import torch

SEQ_PER_RANK, HEADS, KV_HEADS, HEAD_DIM = 8192, 32, 8, 128
REL_NORM = 8 * 2.0 ** -8
MIXTRAL_STEPS = 3


def _needs(world):
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs: the CUDA kernels run only there")
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} GPUs, the host has "
                    f"{torch.cuda.device_count()}")


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _time(attend, dout, barrier) -> dict:
    """Host-clock ms of the forward, and of forward plus backward, the
    mean of 3 after one warm-up, the GPUs synchronised."""
    ms = {}
    for name, fn in (("fwd", attend),
                     ("fwd_bwd", lambda: attend().backward(dout))):
        fn()
        torch.cuda.synchronize()
        barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    return ms


def _attention_worker(rank, world, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.ops.flash_attention import flash_attention
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sequence import (
        ring_attention,
        ulysses_attention,
    )

    mesh = build_mesh(MeshConfig(data=1, sequence=world))
    s = SEQ_PER_RANK * world
    gen = torch.Generator(device="cuda").manual_seed(5)
    full = [torch.randn(1, s, h, HEAD_DIM, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for h in (HEADS, KV_HEADS, KV_HEADS, HEADS)]
    lo = rank * SEQ_PER_RANK
    results = {}
    for impl in ("ring", "ulysses_flash"):
        q, k, v = (x[:, lo:lo + SEQ_PER_RANK].clone().requires_grad_()
                   for x in full[:3])
        dout = full[3][:, lo:lo + SEQ_PER_RANK]

        def attend(q, k, v):
            if impl == "ring":
                return ring_attention(q, k, v, mesh)
            group = HEADS // KV_HEADS  # Ulysses takes the repeated k, v
            return ulysses_attention(
                flash_attention, q, k.repeat_interleave(group, dim=2),
                v.repeat_interleave(group, dim=2), mesh)

        out = attend(q, k, v)
        out.backward(dout)
        got = {}
        for name, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.detach().contiguous())
            got[name] = torch.cat(parts, dim=1)
        results[impl] = {"got": got, "ms": _time(
            lambda: attend(q, k, v), dout, dist.barrier)}
    if rank == 0:
        q, k, v = (x.clone().requires_grad_() for x in full[:3])
        out = flash_attention(q, k, v)
        out.backward(full[3])
        want = {"out": out.detach(), "dq": q.grad.clone(),
                "dk": k.grad.clone(), "dv": v.grad.clone()}
        report = {impl: {"rel": {n: _rel(r["got"][n], want[n])
                                 for n in want},
                         "ms": r["ms"]} for impl, r in results.items()}
        report["whole_ms"] = _time(lambda: flash_attention(q, k, v),
                                   full[3], lambda: None)
        report["card"] = torch.cuda.get_device_name(0)
        with open(out_path, "w") as f:
            json.dump(report, f)


def _mixtral_worker(rank, world, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.examples import train_mixtral as tm
    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.mixtral_8x7b(num_layers=2)
    b, s = tm.batch_shape(False)
    flash = [("module_replace", {"attention": "flash"})]
    # the reference's plan at an expert axis over every card
    plan = Strategy(opts=[
        ("mixed_parallel", {"expert": world, "data": -1}),
        ("amp_native", {}), ("checkpoint", {}), *flash])
    run = tm.train(cfg, b, s, MIXTRAL_STEPS, plan=plan, log_every=0)
    report = {"expert4": run["losses"], "mesh": run["mesh"],
              "expert4_s": run["seconds"]}
    del run
    torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        # expert 1: rank 0's GPU alone, with no process group
        one = tm.train(cfg, b, s, MIXTRAL_STEPS,
                       plan=tm.strategy(cfg.moe_experts, 1, flash),
                       log_every=0)
        report.update({"expert1": one["losses"], "expert1_s": one["seconds"],
                       "card": torch.cuda.get_device_name(0)})
        with open(out_path, "w") as f:
            json.dump(report, f)


def _spawn(kind, world, tmp_path, timeout):
    import subprocess

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import free_port

    out_path = str(tmp_path / f"{kind}_{world}.json")
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", kind,
         str(rank), str(world), str(port), out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(out_path) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_ring_and_ulysses_match_the_whole_sequence(world, tmp_path):
    _needs(world)
    report = _spawn("attention", world, tmp_path, 600)
    print(f"sequence parallel over {world} GPUs, {SEQ_PER_RANK} tokens a "
          f"rank: {json.dumps(report)}")
    for impl in ("ring", "ulysses_flash"):
        for name, rel in report[impl]["rel"].items():
            assert rel <= REL_NORM, (impl, name, rel)


@pytest.mark.cuda
def test_mixtral_expert4_matches_expert1(tmp_path):
    _needs(4)
    report = _spawn("mixtral", 4, tmp_path, 1200)
    print(f"Mixtral-8x7B 2 layers, expert 4 against expert 1: "
          f"{json.dumps(report)}")
    assert report["mesh"]["expert"] == 4
    e4, e1 = report["expert4"], report["expert1"]
    assert abs(e4[0] - e1[0]) <= 1e-3 * abs(e1[0]), (e4, e1)
    for a, b in zip(e4[1:], e1[1:]):
        assert abs(a - b) <= 1e-2 * abs(b), (e4, e1)
    assert e4[-1] < e4[0]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        import torch.distributed as dist

        kind = sys.argv[2]
        rank, world, port = (int(a) for a in sys.argv[3:6])
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                device_id=torch.device("cuda", rank))
        worker = {"attention": _attention_worker,
                  "mixtral": _mixtral_worker}[kind]
        worker(rank, world, sys.argv[6])
        if dist.is_initialized():
            dist.destroy_process_group()
