"""Tensor parallelism with the vocab-parallel embedding and head, on
four gloo ranks, against the JAX package.

``gpt_tp_rules`` splits ``wte`` and ``lm_head`` by vocab over the
tensor axis.  The port applies that in full (``parallel/sharding.py``):
the lookup is summed over the tensor group, the logits come out as a
DTensor sharded on vocab, and the cross-entropy, full and chunked,
reduces the max, the sum of exponentials and the target logit over the
group without gathering the ``[tokens, vocab]`` logits
(``models/losses.py``).

The tiny GPT (tied head) and the tiny Llama (untied ``lm_head``) run
one step through ``auto_accelerate`` at tensor 2 (with data 2) and at
fsdp 2 x tensor 2, in fp32, with the full and the chunked loss, from
the JAX package's init.  Held against the JAX package's model on the
whole batch (what GSPMD computes for any plan): the loss at rtol 1e-5,
each rank's logits (gathered over vocab) at atol 1e-5, and every
parameter's gradient (averaged over the data ranks by the step, then
gathered) at rtol 1e-4 / atol 1e-6.  In the same spawn, the port's
vocab-parallel loss against its unsharded one on random inputs: the
full loss over a ``Shard(-1)`` logits DTensor and the chunked loss over
a head split by vocab (tied and untied), loss and gradients at rtol
1e-6 / atol 1e-7.  One spawn of this file runs every case.
"""

import os
import pickle
import sys

import numpy as np
import pytest

# GPT's vocab; the tiny Llama's is 256 (tokens are drawn below 250)
SEQ, BATCH, VOCAB = 16, 8, 250
FP32 = ("amp_native", {"dtype": "float32"})
PLANS = {
    "tensor2": [("tensor_parallel", {"size": 2}), FP32],
    "fsdp2_tensor2": [("mixed_parallel", {"data": 1, "fsdp": 2,
                                          "tensor": 2}), FP32],
}
MODELS = ("gpt", "llama")
LOSSES = ("full", "chunked")
CASES = [(m, p, lo) for m in MODELS for p in PLANS for lo in LOSSES]


def _batch():
    data = np.random.default_rng(0).integers(0, VOCAB, (BATCH, SEQ + 1),
                                             dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def _port_model(name, params):
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.utils.convert import params_from_jax

    if name == "gpt":
        model = GPT(GPTConfig.tiny(dtype=torch.float32, vocab_size=VOCAB),
                    device="cpu")
    else:
        model = Llama(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _loss_checks(mesh):
    """The vocab-parallel losses against the unsharded ones, in-port."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.models.losses import chunked_cross_entropy

    tp = mesh["tensor"]
    rng = np.random.default_rng(5)
    out = {}
    logits = torch.from_numpy(
        rng.standard_normal((3, 6, VOCAB)).astype(np.float32) * 3)
    y = torch.from_numpy(rng.integers(0, VOCAB, (3, 6)))
    ref = logits.clone().requires_grad_()
    want = F.cross_entropy(ref.flatten(0, 1), y.flatten())
    want.backward()
    sharded = distribute_tensor(logits.clone(), tp, [Shard(2)])
    sharded.requires_grad_()
    got = cross_entropy_loss(sharded, y)
    got.backward()
    out["full"] = (float(got), float(want),
                   sharded.grad.full_tensor().numpy(), ref.grad.numpy())
    hidden = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(
        np.float32))
    for tied in (True, False):
        shape = (VOCAB, 16) if tied else (16, VOCAB)
        w = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.3)
        h_ref, w_ref = hidden.clone().requires_grad_(), w.clone()
        w_ref.requires_grad_()
        targets = torch.from_numpy(rng.integers(0, VOCAB, (2, 8)))
        want = chunked_cross_entropy(h_ref, w_ref, targets, num_chunks=2,
                                     transpose=tied)
        want.backward()
        h = hidden.clone().requires_grad_()
        wd = distribute_tensor(w.clone(), tp, [Shard(0 if tied else 1)])
        wd.requires_grad_()
        got = chunked_cross_entropy(h, wd, targets, num_chunks=2,
                                    transpose=tied)
        got.backward()
        assert isinstance(wd.grad, DTensor)
        out[f"chunked_{'tied' if tied else 'untied'}"] = (
            float(got), float(want),
            np.concatenate([h.grad.numpy().ravel(),
                            wd.grad.full_tensor().numpy().ravel()]),
            np.concatenate([h_ref.grad.numpy().ravel(),
                            w_ref.grad.numpy().ravel()]))
    return out


def _worker(rank, world, port, in_path, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.models.losses import chunked_loss_fn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    batch = job["batch"]
    losses = {"full": lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
              "chunked": chunked_loss_fn(num_chunks=2)}
    results = {}
    for model_name, plan, loss_name in job["cases"]:
        model = _port_model(model_name, job["params"][model_name])
        res = auto_accelerate(
            model, lambda ps: torch.optim.SGD(ps, lr=0.0), losses[loss_name],
            batch, strategy=Strategy(opts=PLANS[plan]), device="cpu")
        placed = res.place_batch(batch)
        state, metrics = res.train_step(res.state, placed)
        grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                     else p.grad).numpy().copy()
                 for n, p in res.model.named_parameters()}
        with torch.no_grad():
            logits = res.model(placed["x"])
        sharded_logits = isinstance(logits, DTensor)
        logits = (logits.full_tensor() if sharded_logits else logits).numpy()
        coord = res.mesh.coordinate()
        row = coord["data"] * res.mesh.shape["fsdp"] + coord["fsdp"]
        ranks = [None] * world
        dist.all_gather_object(ranks, (row, logits))
        head = getattr(res.model, "lm_head", res.model.wte).weight
        results[(model_name, plan, loss_name)] = {
            "loss": float(metrics["loss"]), "grads": grads,
            "logits": ranks, "sharded_logits": sharded_logits,
            "rows": BATCH // (res.mesh.shape["data"] * res.mesh.shape["fsdp"]),
            "head": str(head.placements), "mesh": dict(res.mesh.shape)}
    from torch.distributed.device_mesh import init_device_mesh

    results["losses"] = _loss_checks(init_device_mesh(
        "cpu", (2, 2), mesh_dim_names=("data", "tensor")))
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def _jax_model(name):
    import jax.numpy as jnp

    if name == "gpt":
        from dlrover_tpu.models import gpt

        return gpt.GPT(gpt.GPTConfig.tiny(dtype=jnp.float32,
                                          vocab_size=VOCAB))
    from dlrover_tpu.models import llama

    return llama.Llama(llama.LlamaConfig.tiny(dtype=jnp.float32))


def _reference(batch):
    """Per model: its init, and per loss the loss, the gradient tree
    and the logits on the whole batch."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import cross_entropy_loss
    from dlrover_tpu.models.losses import chunked_loss_fn

    out = {}
    for name in MODELS:
        model = _jax_model(name)
        params = model.init_params(jax.random.PRNGKey(0))
        jb = jax.tree.map(jnp.asarray, batch)
        fns = {"full": lambda p, b, m=model: cross_entropy_loss(
                   m.apply({"params": p}, b["x"]), b["y"]),
               "chunked": chunked_loss_fn(model, num_chunks=2)}
        out[name] = {"params": jax.tree.map(np.asarray, params),
                     "logits": np.asarray(model.apply({"params": params},
                                                      jb["x"]))}
        for loss_name, fn in fns.items():
            loss, grads = jax.value_and_grad(fn)(params, jb)
            out[name][loss_name] = (float(loss),
                                    jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def runs():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import spawn

    batch = _batch()
    want = _reference(batch)
    got = spawn({"batch": batch, "cases": CASES,
                 "params": {m: want[m]["params"] for m in MODELS}},
                os.path.abspath(__file__), world=4)
    return got, want


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_tensor_parallel_matches_the_jax_package(runs, case):
    from dlrover_tpu_torch.utils.convert import _flat, _torch_name

    got, want = runs
    model_name, plan, loss_name = case
    g, w = got[case], want[model_name]
    # the head is split by vocab over the tensor axis, and so are the
    # logits
    assert "Shard(dim=1)" in g["head"] or model_name == "gpt", g["head"]
    assert g["sharded_logits"]
    loss, grads = w[loss_name]
    np.testing.assert_allclose(g["loss"], loss, rtol=1e-5)
    for row, logits in g["logits"]:
        n = g["rows"]
        np.testing.assert_allclose(logits, w["logits"][row * n:(row + 1) * n],
                                   atol=1e-5)
    ref = {_torch_name(path): v for path, v in _flat(grads)}
    assert ref.keys() == g["grads"].keys()
    for name, value in ref.items():
        np.testing.assert_allclose(g["grads"][name], value, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{case} {name}")


@pytest.mark.parametrize("which", ["full", "chunked_tied", "chunked_untied"])
def test_vocab_sharded_loss_equals_the_unsharded_one(runs, which):
    got, _ = runs
    loss, want, grad, want_grad = got["losses"][which]
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5], sys.argv[6])
