"""The tiny Llama trains on a mesh of the PyTorch port (gloo, four CPU
ranks) as the JAX package's does on ``jax.devices()[:4]``.

Twin of ``tests/test_llama.py::test_llama_trains_on_mesh`` (fsdp 2 x
tensor 2), through ``auto_accelerate`` on both sides, with one more
mesh: tensor 4, which the tiny config's two kv heads do not divide, so
every rank reads k and v whole and takes the kv heads its q heads read
(their gradients summed over the tensor ranks).  Both packages start
from the JAX package's init (converted into the port) and take three
SGD steps (lr 0.1) on one numpy batch in fp32 (``amp_native`` at
float32 on both sides); SGD, unlike Adam, does not blow rounding noise
up into a step, so losses and every final parameter are held at rtol
1e-4 / atol 1e-5.  The four ranks run in one spawn of this file
(``--worker``), both meshes in turn, while the parent computes the JAX
package's runs.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

SEQ, BATCH, STEPS, LR = 16, 8, 3, 0.1
WORLD = 4
FP32 = ("amp_native", {"dtype": "float32"})
CASES = {
    "mixed": [("mixed_parallel", {"data": 1, "fsdp": 2, "tensor": 2}), FP32],
    "tensor4": [("tensor_parallel", {"size": 4}), FP32],
}


def _batches():
    """One fixed batch, every step (the loss falls as the model fits
    it, as in the reference's test)."""
    data = np.random.default_rng(0).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)
    return [{"x": data[:, :-1], "y": data[:, 1:]}] * STEPS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, in_path, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.utils.convert import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"])

    results = {}
    for label, opts in CASES.items():
        model = Llama(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
        model.load_state_dict(params_from_jax(job["params"]))
        res = auto_accelerate(
            model, lambda ps: torch.optim.SGD(ps, lr=LR), loss_fn,
            job["batches"][0], strategy=Strategy(opts=opts), device="cpu")
        attn = res.model.blocks[0].attn
        head = res.model.lm_head.weight
        layout = {
            "q_proj": tuple(attn.q_proj.weight.placements),
            # FSDP2's placements are over the fsdp mesh alone: a head
            # sharded over tensor would carry a second placement
            "lm_head": tuple(head.placements) if isinstance(
                head, DTensor) else "plain",
        }
        state, losses = res.state, []
        for batch in job["batches"]:
            state, metrics = res.train_step(state, res.place_batch(batch))
            losses.append(float(metrics["loss"]))
        params = {
            name: (p.full_tensor() if isinstance(p, DTensor) else p)
            .detach().numpy().copy()
            for name, p in res.model.named_parameters()}
        results[label] = {"losses": losses, "params": params,
                          "mesh": dict(res.mesh.shape),
                          "layout": {k: str(v) for k, v in layout.items()}}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def run_port(params, batches):
    """Spawn the gloo ranks; a function that waits for them and returns
    rank 0's results."""
    tmp = tempfile.mkdtemp(prefix="llama_dist_")
    in_path, out_path = (os.path.join(tmp, n) for n in ("in.pkl", "out.pkl"))
    with open(in_path, "wb") as f:
        pickle.dump({"params": params, "batches": batches}, f)
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(WORLD), str(port), in_path, out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]

    def wait():
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        with open(out_path, "rb") as f:
            return pickle.load(f)

    return wait


def jax_runs(batches):
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import Strategy, auto_accelerate
    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.models.llama import Llama, LlamaConfig

    model = Llama(LlamaConfig.tiny(dtype=jnp.float32))

    def loss_fn(p, batch, model=model):
        return jax_gpt.cross_entropy_loss(
            model.apply({"params": p}, batch["x"]), batch["y"])

    out = {}
    for label, opts in CASES.items():
        res = auto_accelerate(
            model, lambda: optax.sgd(LR), loss_fn,
            jax.tree.map(jnp.asarray, batches[0]),
            strategy=Strategy(opts=opts), devices=jax.devices()[:WORLD])
        # its params: the model's init_params(PRNGKey(0)), as the port's
        state, losses = res.state, []
        for batch in batches:
            state, metrics = res.train_step(
                state, res.place_batch(jax.tree.map(jnp.asarray, batch)))
            losses.append(float(metrics["loss"]))
        out[label] = {"losses": losses,
                      "params": jax.tree.map(np.asarray, state.params)}
    return out


def test_llama_trains_on_mesh_as_the_jax_package():
    from dlrover_tpu_torch.utils.convert import _flat, _torch_name

    batches = _batches()
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import Llama, LlamaConfig

    init = jax.tree.map(np.asarray, Llama(LlamaConfig.tiny(
        dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    wait = run_port(init, batches)
    want = jax_runs(batches)
    got = wait()
    assert got["mixed"]["mesh"]["fsdp"] == 2
    assert got["mixed"]["mesh"]["tensor"] == 2
    assert got["tensor4"]["mesh"]["tensor"] == 4
    # q column-parallel over tensor, dim 0 over fsdp; the head split by
    # vocab over tensor as gpt_tp_rules places it (placements over the
    # fsdp x tensor mesh)
    assert got["mixed"]["layout"]["q_proj"] == \
        "(Shard(dim=0), Shard(dim=1))"
    assert got["mixed"]["layout"]["lm_head"] == \
        "(Shard(dim=0), Shard(dim=1))"
    for label in CASES:
        g, w = got[label], want[label]
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)
        assert g["losses"][-1] < g["losses"][0], g["losses"]
        ref = {_torch_name(path): v for path, v in _flat(w["params"])}
        assert ref.keys() == g["params"].keys()
        for name, value in ref.items():
            np.testing.assert_allclose(g["params"][name], value, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{label} {name}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
