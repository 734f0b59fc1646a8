"""The port's sequence parallelism against the JAX package's.

Twins of ``tests/test_sequence_parallel.py``: Ulysses and the ring
against full attention (causal and not), their gradients, and the ring
on a sequence four times the shard.  The reference runs on its 4-way
``sequence`` mesh of the 8 virtual CPU devices; the port's collective
versions run on gloo at world 4 (``sequence`` = 4) in *one* spawn of
this file (``--worker``) whose results every test asserts on, from the
same numpy inputs.  The port's ring runs the flash kernels' plain
versions block by block on the CPU (B1-B3 on the card).

One more test needs no process group: the ring's per-block functions
drive all four shards in one process (``ring_forward_shards``,
``ring_backward_shards``), with GQA (4 q heads over 2 kv heads), held
against the reference's ``ring_attention`` (k and v repeated, as its
models do) forward and backward, causal and not.

Tolerances: fp32 outputs at atol 1e-5 / rtol 1e-5 as the reference's
own tests, gradients at 1e-4 as there.
"""

import os
import pickle
import sys

import numpy as np
import pytest
from torch_gloo import spawn

WORLD = 4

# (name, b, s, h, d, seed): the reference's shapes and seeds
CASES = {
    "ulysses": (2, 64, 4, 16, 0),
    "ring": (2, 64, 4, 16, 1),
    "ring_noncausal": (2, 64, 4, 16, 2),
    "ring_grad": (2, 32, 2, 8, 3),
    "ulysses_grad": (2, 32, 4, 8, 4),
    "ring_long": (2, 512, 2, 16, 5),
}


def _qkv(b, s, h, d, seed, kv_heads=None):
    rng = np.random.default_rng(seed)
    kvh = kv_heads or h
    return tuple((rng.standard_normal(shape) * 0.5).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


def _worker(rank, world, port, in_path, out_path):
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.models.gpt import xla_causal_attention
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sequence import (
        ring_attention,
        ulysses_attention,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = build_mesh(MeshConfig(data=1, sequence=world), device_type="cpu")
    sp = mesh.shape["sequence"]
    r = mesh.coordinate()["sequence"]

    def shard(x):
        s = x.shape[1] // sp
        return torch.from_numpy(x[:, r * s:(r + 1) * s].copy())

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(sp)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group("sequence"))
        return torch.cat(parts, dim=1).numpy()

    def attend(name, q, k, v):
        if name.startswith("ulysses"):
            return ulysses_attention(xla_causal_attention, q, k, v, mesh,
                                     dtype=torch.float32)
        return ring_attention(q, k, v, mesh, causal=name != "ring_noncausal")

    results = {}
    for name, (b, s, h, d, seed) in CASES.items():
        q, k, v = (shard(x).requires_grad_() for x in _qkv(b, s, h, d, seed))
        out = attend(name, q, k, v)
        res = {"out": gather(out.detach())}
        if name.endswith("_grad"):
            (out ** 2).sum().backward()
            res["grads"] = [gather(x.grad) for x in (q, k, v)]
        results[name] = res
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


@pytest.fixture(scope="module")
def port_runs():
    """Rank 0's results of the one gloo spawn of world 4."""
    return spawn({}, os.path.abspath(__file__), WORLD)


@pytest.fixture(scope="module")
def sp_mesh():
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(data=-1, sequence=4))


def _shard(x, mesh):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P(None, "sequence", None,
                                                   None)))


def _jax_full(q, k, v, causal=True):
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import xla_causal_attention

    if causal:
        return xla_causal_attention(q, k, v, dtype=jnp.float32)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), v)


def test_ulysses_matches_full_attention(port_runs, sp_mesh):
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import xla_causal_attention
    from dlrover_tpu.parallel.sequence import ulysses_attention

    q, k, v = (jnp.asarray(x) for x in _qkv(*CASES["ulysses"]))
    ref = _jax_full(q, k, v)
    jax_out = ulysses_attention(xla_causal_attention,
                                *(_shard(x, sp_mesh) for x in (q, k, v)),
                                sp_mesh, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(jax_out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port_runs["ulysses"]["out"], np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,causal", [("ring", True),
                                         ("ring_noncausal", False)])
def test_ring_matches_full_attention(port_runs, sp_mesh, name, causal):
    import jax.numpy as jnp

    from dlrover_tpu.parallel.sequence import ring_attention

    q, k, v = (jnp.asarray(x) for x in _qkv(*CASES[name]))
    ref = _jax_full(q, k, v, causal)
    jax_out = ring_attention(*(_shard(x, sp_mesh) for x in (q, k, v)),
                             sp_mesh, causal=causal)
    for got in (np.asarray(jax_out), port_runs[name]["out"]):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_ring_noncausal(port_runs):
    """The reference's own non-causal case: softmax over every key."""
    q, k, v = _qkv(*CASES["ring_noncausal"])
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    p = np.exp(logits - logits.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(port_runs["ring_noncausal"]["out"], ref,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["ring_grad", "ulysses_grad"])
def test_gradients_match(port_runs, name):
    """dQ, dK, dV of ``sum(out^2)`` through the port's ring and Ulysses
    on gloo against the reference's full attention's (which its own
    test holds its ring and Ulysses to)."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import xla_causal_attention

    q, k, v = (jnp.asarray(x) for x in _qkv(*CASES[name]))

    def loss_ref(q, k, v):
        return (xla_causal_attention(q, k, v, dtype=jnp.float32) ** 2).sum()

    g_ref = jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))(q, k, v)
    for gr, gp, which in zip(g_ref, port_runs[name]["grads"], "qkv"):
        np.testing.assert_allclose(gp, np.asarray(gr), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} grad of {which}")


def test_long_context_ring_runs(port_runs, sp_mesh):
    """The ring on a sequence 4x the per-rank block (512 over 4)."""
    import jax.numpy as jnp

    from dlrover_tpu.parallel.sequence import ring_attention

    q, k, v = (jnp.asarray(x) for x in _qkv(*CASES["ring_long"]))
    got = port_runs["ring_long"]["out"]
    assert got.shape == q.shape and np.isfinite(got).all()
    ref = ring_attention(*(_shard(x, sp_mesh) for x in (q, k, v)), sp_mesh)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_blocks_in_one_process_match_the_reference(sp_mesh, causal):
    """The ring's per-block functions over 4 shards in one process, GQA
    (4 q heads over 2 kv heads): outputs, lse against the whole-sequence
    plain forward, and dQ/dK/dV of ``sum(out^2)`` against the reference's
    ring on its 4-device sequence mesh (k and v repeated there)."""
    import jax
    import jax.numpy as jnp
    import torch

    from dlrover_tpu.parallel.sequence import ring_attention
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import sequence as port_seq

    b, s, h, kvh, d, sp = 2, 64, 4, 2, 16, 4
    q, k, v = _qkv(b, s, h, d, 7, kv_heads=kvh)
    group = h // kvh

    def loss(q, k, v):
        kr, vr = (jnp.repeat(x, group, axis=2) for x in (k, v))
        out = ring_attention(*(_shard(x, sp_mesh) for x in (q, kr, vr)),
                             sp_mesh, causal=causal)
        return (out ** 2).sum(), out

    (_, ref), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    scale = d ** -0.5
    shards = [list(torch.from_numpy(x).chunk(sp, dim=1)) for x in (q, k, v)]
    outs, lses = port_seq.ring_forward_shards(*shards, scale, causal)
    out = torch.cat(outs, dim=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = fa.fwd_plain(tq, tk, tv, scale, causal, 16, 16)
    np.testing.assert_allclose(torch.cat(lses, dim=2).numpy(), lse.numpy(),
                               atol=1e-5, rtol=1e-5)
    douts = [2 * o for o in outs]
    got = port_seq.ring_backward_shards(*shards, outs, douts, lses, scale,
                                        causal)
    for gp, gr, which in zip(got, grads, "qkv"):
        np.testing.assert_allclose(torch.cat(gp, dim=1).numpy(),
                                   np.asarray(gr), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{which}")
    # the blocks each rank ran: 4 diagonal and 6 full ones when causal
    kinds = [port_seq.ring_block_kind(r, src, causal)
             for r in range(sp) for src in range(sp)]
    assert kinds.count("skip") == (6 if causal else 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
