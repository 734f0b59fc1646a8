"""DiLoCo local SGD, ``Offload`` over FSDP2 and the strategy search's
tensor-parallel int8 candidates, on the CPU and on two gloo ranks.

- Twins of the reference's five DiLoCo tests (``tests/test_optim.py``:
  the outer sync averages replicas, GTA beats the linear mean under
  divergence, magnitude sparsification drops small noise, random
  sparsification keeps the expectation and the knobs validate, the
  outer step's ``reduce_method`` knob), each also holding the port's
  stacked functions (``optim/local_sgd.py``) against the reference's on
  the same numpy deltas at rtol 1e-6 (``random`` sparsification draws
  from another generator than JAX's, so its twin is statistical, as the
  reference's is).
- On two gloo ranks (one spawn for the file): the process-group form of
  the outer step, one replica a rank, against the stacked form of the
  same two replicas, for every reduce method (sparsified, random
  sparsification with a seeded ``torch.Generator`` on each rank)
  at rtol 1e-6; ``Offload`` over FSDP2 DTensor parameters (the tiny GPT,
  three AdamW steps, chunks of a few leaves) against the unwrapped
  AdamW bit for bit, its DTensor states carried by shard
  (``host_shard``/``device_shard``) bit for bit; and the strategy search
  with ``search_optimizer`` set, which dry-runs every candidate of world
  2, ``tensor 2`` with int8 q-AdamW among them, and finishes.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

SEQ, BATCH = 16, 8
# the process-group form's cases: (label, keyword arguments)
DIST_CASES = [
    ("linear", dict(reduce_method="linear")),
    ("gta_sum", dict(reduce_method="gta", consensus="sum")),
    ("gta_count", dict(reduce_method="gta", consensus="count")),
    ("gta_magnitude", dict(reduce_method="gta", sparsification="magnitude",
                           density=0.5)),
    ("sparsify_magnitude", dict(reduce_method="sparsify", density=0.3)),
    ("sparsify_rescaled_random", dict(reduce_method="sparsify",
                                      sparsification="rescaled_random",
                                      density=0.5)),
    ("gta_random", dict(reduce_method="gta", sparsification="random",
                        density=0.7)),
]


def _signal_deltas(seed, n=256):
    """6 replicas along a signal, 2 diverged twice as far the other way
    (the reference's divergence fixture)."""
    rng = np.random.default_rng(seed)
    signal = rng.normal(size=n).astype(np.float32)
    good = signal[None] + rng.normal(size=(6, n)).astype(np.float32) * 0.1
    bad = -2.0 * signal[None] + rng.normal(size=(2, n)).astype(
        np.float32) * 0.1
    return signal, np.concatenate([good, bad], axis=0)


# -- twins of the reference's DiLoCo tests (tests/test_optim.py) ----------------


def test_diloco_outer_sync_averages_replicas():
    import jax.numpy as jnp

    from dlrover_tpu.optim.local_sgd import diloco_outer_step as jax_outer
    from dlrover_tpu.optim.local_sgd import init_diloco as jax_init
    from dlrover_tpu_torch.optim.local_sgd import (
        diloco_outer_step,
        init_diloco,
    )

    values = [1.0, 2.0, 3.0, 4.0] + [2.5] * 4
    local = {"w": torch.stack([torch.full((4,), v) for v in values])}
    new_local, state = diloco_outer_step(
        local, init_diloco({"w": torch.zeros(4)}), outer_lr=1.0,
        outer_momentum=0.0, nesterov=False)
    # anchor_new = anchor - lr * (anchor - mean(local)) = 2.5
    np.testing.assert_allclose(state.anchor_params["w"].numpy(),
                               np.full(4, 2.5), atol=1e-6)
    np.testing.assert_allclose(new_local["w"][0].numpy(), np.full(4, 2.5),
                               atol=1e-6)
    assert new_local["w"].shape == (8, 4)
    jlocal, jstate = jax_outer(
        {"w": jnp.asarray(local["w"].numpy())}, jax_init({"w": jnp.zeros(4)}),
        None, outer_lr=1.0, outer_momentum=0.0, nesterov=False)
    np.testing.assert_allclose(state.anchor_params["w"].numpy(),
                               np.asarray(jstate.anchor_params["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(new_local["w"].numpy(),
                               np.asarray(jlocal["w"]), rtol=1e-6)


def test_reduce_deltas_gta_beats_linear_under_divergence():
    import jax.numpy as jnp

    from dlrover_tpu.optim.local_sgd import reduce_deltas as jax_reduce
    from dlrover_tpu_torch.optim.local_sgd import reduce_deltas

    signal, deltas = _signal_deltas(0, 512)
    t = torch.from_numpy(deltas)
    out = {"linear": reduce_deltas(t, reduce_method="linear"),
           "gta_sum": reduce_deltas(t, reduce_method="gta", consensus="sum"),
           "gta_count": reduce_deltas(t, reduce_method="gta",
                                      consensus="count")}

    def err(x):
        return float(np.linalg.norm(x.numpy() - signal))

    assert err(out["gta_sum"]) < err(out["linear"])
    assert err(out["gta_count"]) < err(out["linear"])
    for name, got in out.items():
        method, _, consensus = name.partition("_")
        want = jax_reduce(jnp.asarray(deltas), reduce_method=method,
                          consensus=consensus or "sum")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_reduce_deltas_sparsify_magnitude_drops_small_noise():
    import jax.numpy as jnp

    from dlrover_tpu.optim.local_sgd import reduce_deltas as jax_reduce
    from dlrover_tpu_torch.optim.local_sgd import reduce_deltas

    rng = np.random.default_rng(1)
    r, n, k = 4, 1000, 50
    signal = np.zeros(n, np.float32)
    signal[rng.choice(n, k, replace=False)] = rng.normal(size=k).astype(
        np.float32) * 5.0
    deltas = signal[None] + rng.normal(size=(r, n)).astype(np.float32) * 0.1
    t = torch.from_numpy(deltas)
    linear = reduce_deltas(t, reduce_method="linear")
    sparse = reduce_deltas(t, reduce_method="sparsify",
                           sparsification="magnitude", density=0.1)

    def err(x):
        return float(np.linalg.norm(x.numpy() - signal))

    assert err(sparse) < err(linear)
    assert float((sparse != 0).float().mean()) <= 0.25
    want = jax_reduce(jnp.asarray(deltas), reduce_method="sparsify",
                      sparsification="magnitude", density=0.1)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_reduce_deltas_random_sparsify_and_validation():
    from dlrover_tpu_torch.optim.local_sgd import reduce_deltas

    deltas = torch.ones(4, 64)
    out = reduce_deltas(deltas, reduce_method="sparsify",
                        sparsification="rescaled_random", density=0.5,
                        generator=torch.Generator().manual_seed(0))
    # rescaled random keeps the expectation
    assert 0.7 < float(out.mean()) < 1.3
    # the same generator seed draws the same mask
    again = reduce_deltas(deltas, reduce_method="sparsify",
                          sparsification="rescaled_random", density=0.5,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    with pytest.raises(ValueError):
        reduce_deltas(deltas, reduce_method="nope")
    with pytest.raises(ValueError):
        reduce_deltas(deltas, reduce_method="sparsify",
                      sparsification="random", density=0.5)  # no generator
    with pytest.raises(ValueError):
        reduce_deltas(deltas, density=0.0)


def test_diloco_outer_step_reduce_method_knob():
    import jax.numpy as jnp

    from dlrover_tpu.optim.local_sgd import diloco_outer_step as jax_outer
    from dlrover_tpu.optim.local_sgd import init_diloco as jax_init
    from dlrover_tpu_torch.optim.local_sgd import (
        diloco_outer_step,
        init_diloco,
    )

    signal, deltas = _signal_deltas(2)
    r, n = deltas.shape
    local = {"w": torch.from_numpy(-deltas)}
    outs = {}
    for method in ("linear", "gta"):
        new_local, state = diloco_outer_step(
            local, init_diloco({"w": torch.zeros(n)}), outer_lr=1.0,
            outer_momentum=0.0, nesterov=False, reduce_method=method)
        outs[method] = state.anchor_params["w"].numpy()
        np.testing.assert_allclose(
            new_local["w"].numpy(), np.broadcast_to(outs[method], (r, n)))
        _, jstate = jax_outer(
            {"w": jnp.asarray(-deltas)}, jax_init({"w": jnp.zeros(n)}),
            None, outer_lr=1.0, outer_momentum=0.0, nesterov=False,
            reduce_method=method)
        np.testing.assert_allclose(outs[method],
                                   np.asarray(jstate.anchor_params["w"]),
                                   rtol=1e-6, atol=1e-7)
    target = -signal
    assert (np.linalg.norm(outs["gta"] - target)
            < np.linalg.norm(outs["linear"] - target))


# -- two gloo ranks ------------------------------------------------------------


def _diloco_tree(seed):
    rng = np.random.default_rng(seed)
    anchor = {"w": rng.normal(size=(6, 40)).astype(np.float32),
              "b": rng.normal(size=(40,)).astype(np.float32)}
    local = {k: np.stack([v + rng.normal(size=v.shape).astype(np.float32)
                          for _ in range(2)]) for k, v in anchor.items()}
    return anchor, local


def _diloco_dist(rank):
    from dlrover_tpu_torch.optim.local_sgd import (
        diloco_outer_step,
        diloco_outer_step_dist,
        init_diloco,
    )

    out = {}
    anchor, local = _diloco_tree(3)
    for label, kw in DIST_CASES:
        state = init_diloco({k: torch.from_numpy(v)
                             for k, v in anchor.items()})
        # two outer steps, so the momentum takes part
        mine = {k: torch.from_numpy(v[rank].copy())
                for k, v in local.items()}
        stacked = {k: torch.from_numpy(v.copy()) for k, v in local.items()}
        s_state = state
        gen_d, gen_s = (torch.Generator().manual_seed(7),
                        torch.Generator().manual_seed(7))
        for _ in range(2):
            mine, state = diloco_outer_step_dist(
                mine, state, generator=gen_d, **kw)
            stacked, s_state = diloco_outer_step(
                stacked, s_state, generator=gen_s, **kw)
            # the replicas drift apart again before the next sync
            mine = {k: v + (rank + 1) * 0.1 for k, v in mine.items()}
            stacked = {k: v + torch.tensor([0.1, 0.2]).reshape(
                (2,) + (1,) * (v.dim() - 1)) for k, v in stacked.items()}
        out[label] = {
            "dist": {k: v.numpy() for k, v in state.anchor_params.items()},
            "dist_mom": {k: v.numpy() for k, v in state.momentum.items()},
            "stacked": {k: v.numpy()
                        for k, v in s_state.anchor_params.items()},
            "stacked_mom": {k: v.numpy()
                            for k, v in s_state.momentum.items()}}
    return out


def _offload_run(world):
    """The tiny GPT under FSDP2 (world 2), three AdamW steps with the
    state offloaded by chunks of a few leaves, and unwrapped."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.optim.offload import (
        Offload,
        device_shard,
        host_shard,
    )

    data = np.random.default_rng(0).integers(0, 256, (3, BATCH, SEQ + 1),
                                             dtype=np.int32)
    out = {}
    for label in ("plain", "offload"):
        def factory(ps, label=label):
            inner = torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.1)
            if label == "plain":
                return inner
            opt = Offload(inner)
            opt.chunk_bytes = 64 * 1024  # several chunks a step
            return opt

        res = auto_accelerate(
            GPT(GPTConfig.tiny(dtype=torch.float32), device="cpu", seed=0),
            factory, lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
            {"x": data[0, :, :-1], "y": data[0, :, 1:]},
            strategy=Strategy(opts=[("fsdp", {}), ("amp_native", {
                "dtype": "float32"})]), device="cpu")
        state = res.state
        for batch in data:
            state, _ = res.train_step(state, res.place_batch(
                {"x": batch[:, :-1], "y": batch[:, 1:]}))
        params = {n: p.full_tensor().detach().numpy()
                  for n, p in res.model.named_parameters()}
        out[label] = {"params": params,
                      "dtensor": all(isinstance(p, DTensor)
                                     for p in res.model.parameters())}
        if label == "offload":
            opt = state.optimizer
            out["chunks"] = len(opt._chunks(
                [p for g in opt.param_groups for p in g["params"]]))
            # a DTensor state carried by its shard and back
            carried = []
            for st in opt.state.values():
                for v in st.values():
                    if isinstance(v, DTensor) and v.dim() > 0:
                        buf = torch.empty_like(v.to_local())
                        back = device_shard(host_shard(v, buf), "cpu")
                        carried.append(
                            torch.equal(back.to_local(), v.to_local())
                            and back.placements == v.placements
                            and back.shape == v.shape)
            out["carried"] = carried
    dist.barrier()
    return out


def _search(world):
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import ModelContext
    from dlrover_tpu_torch.accel.strategy_search import search_strategy
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss

    data = np.random.default_rng(1).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)
    ctx = ModelContext(
        model=GPT(GPTConfig.tiny(), device="cpu", seed=0),
        optim_factory=lambda ps: torch.optim.AdamW(ps, lr=1e-3),
        loss_fn=lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
        sample_batch={"x": data[:, :-1], "y": data[:, 1:]},
        extra={"search_optimizer": True}, device=torch.device("cpu"))
    result = search_strategy(ctx, world, dry_run_budget=64,
                             grad_accums=(1,), profile_steps=1)
    dist.barrier()
    return {"best": result.best.describe(),
            "evaluated": [(c.tensor, c.low_bit_opt, c.half, c.step_time_s,
                           c.error) for c in result.evaluated]}


def _worker(rank, world, port, in_path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    results = {"diloco": _diloco_dist(rank), "offload": _offload_run(world),
               "search": _search(world)}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


@pytest.fixture(scope="module")
def world2():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import spawn

    return spawn({}, os.path.abspath(__file__), world=2)


@pytest.mark.parametrize("label", [c[0] for c in DIST_CASES])
def test_process_group_diloco_equals_the_stacked_form(world2, label):
    got = world2["diloco"][label]
    for which in ("", "_mom"):
        for k, want in got["stacked" + which].items():
            np.testing.assert_allclose(got["dist" + which][k], want,
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{label}{which} {k}")


def test_offload_over_fsdp2_equals_the_unwrapped_adamw(world2):
    got = world2["offload"]
    assert got["plain"]["dtensor"] and got["offload"]["dtensor"]
    assert got["chunks"] > 1
    assert got["carried"] and all(got["carried"])
    for name, want in got["plain"]["params"].items():
        assert np.array_equal(got["offload"]["params"][name], want), name


def test_search_dry_runs_tensor_parallel_int8_candidates(world2):
    got = world2["search"]
    tp_int8 = [c for c in got["evaluated"] if c[0] == 2 and c[1]]
    assert tp_int8, got["evaluated"]
    # each built and stepped: a finite step time and no error
    for tensor, low_bit, half, step_s, error in tp_int8:
        assert not error and np.isfinite(step_s), (tensor, error)
    assert got["best"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5], sys.argv[6])
