"""``auto_accelerate`` of the port on torch.distributed (gloo, CPU)
against the JAX package's on ``jax.devices()[:world]``.

The same strategies, the same init (the JAX package's
``init_params(PRNGKey(0))`` converted into the port's GPT) and the
same three global batches: data parallel, FSDP2, ZeRO-1/2, tensor
parallel and the mixed (data 1, fsdp 2, tensor 2) mesh take three
AdamW steps (``optax.adamw(1e-3)`` against ``torch.optim.AdamW`` with
optax's defaults) in fp32 (``amp_native`` at float32 on both sides:
a plan's compute dtype defaults to bf16).  Losses and final params are
held at rtol 1e-4 and atol 1e-5, every element, except where the JAX
run itself shows rounding noise at work: Adam's ``g / (|g| + eps)``
turns the noise of a gradient near 0 (the sums run in another order;
the k part of each fused qkv bias has a gradient of 0 up to it) into a
step of up to lr each way, so an element whose reference gradient was
below ``GRAD_QUIET`` at some step is held only to Adam's bound of
2 * steps * lr.  One more plan runs int8 q-AdamW (``low_bit_opt``)
under FSDP2, where the 96-element shards of the qkv biases split a
quantization block of 2048 between two ranks: the moments' codes must
equal the JAX package's global-block codes, except that a code whose
pre-rounding value sat at a tie in the JAX run (recomputed from its
state and gradients) may round the other way, and the element's later
steps with it; the scales hold within rtol 1e-4, and the ranks that
share a split block hold the same codes and scale of it.  The test
prints how many elements each case exempts.

Each world runs in one spawn of ``world`` processes (this file with
``--worker``), every plan of that world in turn, so the suite pays the
processes' torch import once a world.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

SEQ, BATCH, STEPS, VOCAB = 16, 8, 3, 250
LR = 1e-3
# a gradient this small is rounding noise (the sums run in another
# order) that Adam's g / (|g| + eps) turns into a step of up to lr; and
# an int8 code whose pre-rounding value lies this close to a tie,
# relative to the terms that make it, may round either way with that
# noise
GRAD_QUIET, TIE = 1e-7, 1e-4
FP32 = ("amp_native", {"dtype": "float32"})
LOW_BIT = ("low_bit_opt", {"bits": 8, "learning_rate": 1e-3,
                           "weight_decay": 0.1})

CASES = {
    2: {
        "data": [("parallel_mode", {}), FP32],
        "fsdp": [("fsdp", {}), FP32],
        "zero1": [("zero1", {}), FP32],
        "zero2": [("zero2", {}), FP32],
        "tensor": [("tensor_parallel", {"size": 2}), FP32],
        "fsdp_int8": [("fsdp", {}), FP32, LOW_BIT],
    },
    4: {
        "data": [("parallel_mode", {}), FP32],
        "fsdp": [("fsdp", {}), FP32],
        "zero2": [("zero2", {}), FP32],
        "tensor": [("tensor_parallel", {"size": 4}), FP32],
        "mixed": [("mixed_parallel", {"data": 1, "fsdp": 2, "tensor": 2}),
                  FP32],
        "fsdp_int8": [("fsdp", {}), FP32, LOW_BIT],
    },
}


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        data = rng.integers(0, VOCAB, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the port, in each process of the world ----------------------------------


def _global_qstate(optimizer, model, world):
    """Each parameter's int8 moments on the global block grid, put
    together from the ranks' state rows, and whether the ranks that
    share a split block hold the same codes and scale of it."""
    import torch.distributed as dist

    from dlrover_tpu_torch.optim.low_bit import shard_grid

    keys = ("mu_values", "mu_scales", "nu_values", "nu_scales")
    out, alike = {}, True
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        grid = shard_grid(p, optimizer.block_size)
        ranks = [None] * world
        dist.all_gather_object(
            ranks, (grid.row0, {k: st[k].float().numpy() for k in keys}))
        total = -(-p.numel() // optimizer.block_size)
        parts = {}
        for key in keys:
            full = np.full((total,) + st[key].shape[1:], np.nan, np.float32)
            for row0, rows in ranks:
                held = full[row0:row0 + len(rows[key])]
                seen = ~np.isnan(held)
                alike &= bool(np.array_equal(held[seen], rows[key][seen]))
                held[...] = rows[key]
            parts[key] = full
        out[name] = parts
    return out, alike


def _worker(rank, world, port, in_path, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.utils.convert import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"])

    results = {}
    for label, opts in job["cases"].items():
        model = GPT(GPTConfig.tiny(dtype=torch.float32, vocab_size=VOCAB),
                    device="cpu")
        model.load_state_dict(params_from_jax(job["params"]))
        res = auto_accelerate(
            model, lambda ps: torch.optim.AdamW(
                ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=1e-4),
            loss_fn, job["batches"][0], strategy=Strategy(opts=opts),
            device="cpu")
        state, losses, qstates, alike = res.state, [], [], True
        for batch in job["batches"]:
            state, metrics = res.train_step(state, res.place_batch(batch))
            losses.append(float(metrics["loss"]))
            if res.plan.low_bit_opt:
                qstate, same = _global_qstate(state.optimizer, res.model,
                                              world)
                qstates.append(qstate)
                alike &= same
        params = {
            name: (p.full_tensor() if isinstance(p, DTensor) else p)
            .detach().numpy().copy()
            for name, p in res.model.named_parameters()}
        results[label] = {"losses": losses, "params": params,
                          "qstates": qstates, "split_blocks_alike": alike,
                          "mesh": dict(res.mesh.shape)}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def run_port(world, params, batches, cases):
    """Spawn ``world`` gloo ranks running every case; a function that
    waits for them and returns rank 0's results."""
    tmp = tempfile.mkdtemp(prefix="accel_dist_")
    in_path, out_path = (os.path.join(tmp, n) for n in ("in.pkl", "out.pkl"))
    with open(in_path, "wb") as f:
        pickle.dump({"params": params, "batches": batches, "cases": cases}, f)
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(world), str(port), in_path, out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    def wait():
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        with open(out_path, "rb") as f:
            return pickle.load(f)

    return wait


# -- the JAX package -----------------------------------------------------------


def _jax_model():
    import jax.numpy as jnp

    from dlrover_tpu.models import gpt as jax_gpt

    return jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32,
                                              vocab_size=VOCAB))


def jax_init():
    """The JAX package's init, as ``ModelContext.init_params`` draws it."""
    import jax

    return jax.tree.map(np.asarray,
                        _jax_model().init_params(jax.random.PRNGKey(0)))


def jax_reference(world, cases):
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import Strategy, auto_accelerate
    from dlrover_tpu.models import gpt as jax_gpt

    jmodel = _jax_model()

    def loss_fn(p, batch, model=jmodel):
        return jax_gpt.cross_entropy_loss(
            model.apply({"params": p}, batch["x"]), batch["y"])

    batches = _batches()
    grad_fn = jax.jit(jax.grad(loss_fn))
    out = {}
    for label, opts in cases.items():
        res = auto_accelerate(
            jmodel, lambda: optax.adamw(1e-3), loss_fn,
            jax.tree.map(jnp.asarray, batches[0]),
            strategy=Strategy(opts=opts), devices=jax.devices()[:world])
        state, losses, grads, opt_states = res.state, [], [], []
        for batch in batches:
            batch = jax.tree.map(jnp.asarray, batch)
            # on the host's copy: one compile for every plan
            grads.append(jax.tree.map(np.asarray, grad_fn(
                jax.tree.map(np.asarray, state.params), batch)))
            opt_states.append(jax.tree.map(np.asarray, state.opt_state))
            state, metrics = res.train_step(state, res.place_batch(batch))
            losses.append(float(metrics["loss"]))
        out[label] = {"losses": losses,
                      "params": jax.tree.map(np.asarray, state.params),
                      "opt_state": jax.tree.map(np.asarray, state.opt_state),
                      "grads": grads, "opt_states": opt_states}
    return out


def _jax_qstate(opt_state):
    """name -> the JAX q-AdamW state's codes and scales (flattened in
    blocks, as the port's global grid)."""
    from dlrover_tpu_torch.utils.convert import _flat, _torch_name

    node = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    out = {}
    for which in ("mu", "nu"):
        for path, qm in _flat(getattr(node, which)):
            name = _torch_name(path)
            out.setdefault(name, {})[f"{which}_values"] = np.asarray(
                qm.values, np.float32).reshape(-1, qm.values.shape[-1])
            out[name][f"{which}_scales"] = np.asarray(
                qm.scales, np.float32).reshape(-1, 1)
    return out


_RUNS = {}


@pytest.fixture()
def world_runs(request):
    """Both packages' runs of every case of one world, once a module."""
    world = request.param
    if world not in _RUNS:
        # the port's ranks run while the JAX package computes
        wait = run_port(world, jax_init(), _batches(), CASES[world])
        want = jax_reference(world, CASES[world])
        _RUNS[world] = (world, wait(), want)
    return _RUNS[world]


def _named(tree):
    from dlrover_tpu_torch.utils.convert import _flat, _torch_name

    return {_torch_name(path): np.asarray(v, np.float32)
            for path, v in _flat(tree)}


def _blocks(x, block=2048):
    x = x.reshape(-1)
    return np.pad(x, (0, -x.size % block)).reshape(-1, block)


def _reference_ties(grads, opt_state, b1=0.9, b2=0.999):
    """name -> ``[rows, block]``: which int8 moment codes of one step
    of the JAX run had their pre-rounding value within ``TIE`` of a
    rounding tie, relative to the terms that make it, recomputed from
    the state and gradient before the step with q-AdamW's moment
    update (``_qadam_kernel``).  Such a code rounds either way with the
    gradients' summation noise."""
    grads, ties = _named(grads), {}
    for name, st in _jax_qstate(opt_state).items():
        g = _blocks(grads[name])
        mu_prev = st["mu_values"] * st["mu_scales"]
        mu = b1 * mu_prev + (1 - b1) * g
        nu_prev = st["nu_values"] * st["nu_scales"]
        nu_sqrt = np.sqrt(b2 * nu_prev * nu_prev + (1 - b2) * g * g)
        # mu's sum may cancel, nu's terms are all positive
        for x, terms in ((mu, b1 * np.abs(mu_prev) + (1 - b1) * np.abs(g)),
                         (nu_sqrt, nu_sqrt)):
            scale = np.maximum(np.abs(x).max(-1, keepdims=True) / 127, 1e-12)
            a = np.abs(x / scale)
            ties[name] = ties.get(name, False) | (
                np.abs(a - np.floor(a) - 0.5) < TIE * (a + terms / scale))
    return ties


def _code_flips(got, want):
    """Hold the port's int8 codes to the JAX run's step by step: a code
    may differ by one, and first differ only where the JAX run's value
    sat at a tie (after that the element's moments carry the other
    rounding).  The scales hold at rtol 1e-4.  Returns name -> the
    elements whose codes differed at some step."""
    after = want["opt_states"][1:] + [want["opt_state"]]
    flipped = {}
    for step, (qstate, grads, before, ref) in enumerate(zip(
            got["qstates"], want["grads"], want["opt_states"], after)):
        ties, ref = _reference_ties(grads, before), _jax_qstate(ref)
        for name, parts in qstate.items():
            was = flipped.get(name, False)
            for key, value in parts.items():
                want_value = ref[name][key]
                assert value.shape == want_value.shape, (name, key)
                if key.endswith("scales"):
                    np.testing.assert_allclose(
                        value, want_value, rtol=1e-4,
                        err_msg=f"step {step} {name} {key}")
                    continue
                diff = np.abs(value - want_value)
                assert diff.max() <= 1, (step, name, key, diff.max())
                first = (diff > 0) & ~was & ~ties[name]
                assert not first.any(), (step, name, key,
                                         np.argwhere(first))
                flipped[name] = flipped.get(name, False) | (diff > 0)
    return flipped


def _compare(label, got, want, flipped=None):
    """Losses, then each param: every element within Adam's bound, and
    within rtol 1e-4 / atol 1e-5 unless the JAX run's gradient of it
    was quiet (0 < |g| < GRAD_QUIET at some step) or, under q-AdamW, its
    moment codes rounded the other way at a tie (``flipped``).  Returns
    (exempt elements, all elements, largest error of the held ones)."""
    from dlrover_tpu_torch.utils.convert import params_from_jax

    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-5, err_msg=f"{label} losses")
    quiet = {}
    for grads in want["grads"]:
        for name, g in _named(grads).items():
            a = np.abs(g).reshape(-1)
            quiet[name] = quiet.get(name, False) | ((a > 0) & (a < GRAD_QUIET))
    ref = {k: v.numpy() for k, v in params_from_jax(want["params"]).items()}
    assert set(ref) == set(got["params"]), label
    exempt = total = 0
    held_err = 0.0
    for name, w in ref.items():
        g = got["params"][name]
        assert g.shape == w.shape, (label, name)
        err = np.abs(g - w).reshape(-1)
        assert err.max() <= 2 * STEPS * LR, (label, name, err.max())
        skip = quiet[name]
        if flipped is not None:
            skip = skip | flipped[name].reshape(-1)[:err.size]
        miss = (err > 1e-5 + 1e-4 * np.abs(w).reshape(-1)) & ~skip
        assert not miss.any(), (label, name, np.flatnonzero(miss),
                                err[miss])
        exempt += int(skip.sum())
        total += err.size
        held_err = max(held_err, float(err[~skip].max(initial=0.0)))
    return exempt, total, held_err


@pytest.mark.parametrize("world_runs,label", [
    (world, label) for world, cases in CASES.items() for label in cases
    if label != "fsdp_int8"], indirect=["world_runs"])
def test_plans_match_jax_auto_accelerate(world_runs, label):
    world, got, want = world_runs
    exempt, total, held_err = _compare(label, got[label], want[label])
    print(f"world {world} {label}: {exempt} of {total} elements exempt, "
          f"largest held error {held_err:.3g}")


@pytest.mark.parametrize("world_runs", list(CASES), indirect=True)
def test_meshes_are_the_strategies(world_runs):
    world, got, _ = world_runs
    assert got["data"]["mesh"]["data"] == world
    assert got["fsdp"]["mesh"]["fsdp"] == world
    assert got["tensor"]["mesh"]["tensor"] == world
    if world == 4:
        assert (got["mixed"]["mesh"]["fsdp"],
                got["mixed"]["mesh"]["tensor"]) == (2, 2)


@pytest.mark.parametrize("world_runs", list(CASES), indirect=True)
def test_low_bit_under_fsdp_keeps_the_global_block_grid(world_runs):
    """int8 q-AdamW under FSDP2: losses and params as the JAX
    package's, and codes and scales of its global blocks, those that a
    shard boundary splits (the 96- and 48-element bias shards, the
    32- and 16-element layernorm shards) included."""
    world, got, want = world_runs
    g, w = got["fsdp_int8"], want["fsdp_int8"]
    assert g["split_blocks_alike"]
    flipped = _code_flips(g, w)
    exempt, total, held_err = _compare("fsdp_int8", g, w, flipped)
    print(f"world {world} fsdp_int8: {exempt} of {total} elements exempt "
          f"({sum(int(f.sum()) for f in flipped.values())} with a code "
          f"flipped at a tie), largest held error {held_err:.3g}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
