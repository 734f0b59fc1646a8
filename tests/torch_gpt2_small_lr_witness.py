"""GPT-2 small's loss curve at the Trainer's default AdamW, in the JAX
package and in the port, on the CPU.

``chip_smoke.py``'s phase 5a trains GPT-2 small on one fixed batch of
random tokens.  With the embeddings drawn as flax's ``nn.Embed`` draws
them, the loss at the Trainer's default learning rate (1e-3, optax's
``adamw`` in the JAX package, AdamW with optax's defaults in the port)
climbs by step 6 on the card; this script asks whether the JAX package
does the same.  Both packages start from one flax init of GPT-2 small
(12 layers, width 768, vocab 50257, 1024 positions), carried into the
port by ``params_from_jax``, and take ``--steps`` AdamW steps on the
first ``--batch`` rows and ``--seq`` positions of phase 5a's batch
(``np.random.default_rng(0).integers(0, 50257, (32, 1025))``; all of
it by default), its gradient accumulated over ``--grad-accum``
micro-batches, with the plain attention math and the compute dtype of
phase 5a (bf16, fp32 params).  It prints each package's losses, their
relative difference a step, and the peak of each curve against its
first loss, as one JSON line at the end.  Not a test: at the default
size it takes about half an hour on 8 CPU cores.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_gpt2_small_lr_witness.py
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.trainer import elastic_trainer as jax_et
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.trainer.elastic_trainer import (
    TrainState,
    make_train_step,
)
from dlrover_tpu_torch.utils.convert import params_from_jax


def curves(batch: int, seq: int, steps: int, lr: float, dtype: str,
           grad_accum: int):
    data = np.random.default_rng(0).integers(
        0, 50257, (32, 1024 + 1), dtype=np.int32)[:batch, :seq + 1]
    fixed = {"x": data[:, :-1], "y": data[:, 1:]}
    jcfg = jax_gpt.GPTConfig.gpt2_small(dtype=getattr(jnp, dtype))
    jmodel = jax_gpt.GPT(jcfg)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, seq), jnp.int32))["params"])(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)

    def jloss(p, b):
        return jax_gpt.cross_entropy_loss(
            jmodel.apply({"params": p}, b["x"]), b["y"])

    # the JAX Trainer's default optimizer (trainer.py: optax.adamw(lr))
    optimizer = optax.adamw(lr)
    jstep = jax_et.make_train_step(jloss, optimizer, grad_accum=grad_accum)
    jstate = jax_et.TrainState.create(params, optimizer)
    jbatch = jax.tree.map(jnp.asarray, fixed)
    out = {"jax": [], "port": []}
    t0 = time.perf_counter()
    for _ in range(steps):
        jstate, m = jstep(jstate, jbatch)
        out["jax"].append(float(m["loss"]))
    out["jax_s"] = time.perf_counter() - t0
    del jstate, params

    model = port_gpt.GPT(port_gpt.GPTConfig.gpt2_small(
        dtype=getattr(torch, dtype)), device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    # the port Trainer's default optimizer: AdamW with optax's defaults
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)

    def ploss(module, b):
        return port_gpt.cross_entropy_loss(module(b["x"]), b["y"])

    step = make_train_step(ploss, opt, grad_accum=grad_accum, device="cpu")
    state = TrainState.create(model, opt)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, fixed)
        out["port"].append(m["loss"].item())
    out["port_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--grad-accum", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    out = curves(args.batch, args.seq, args.steps, args.lr, args.dtype,
                 args.grad_accum)
    for name in ("jax", "port"):
        c = out[name]
        print(f"{name}: losses {[round(x, 6) for x in c]}; peak "
              f"{max(c):.6f} at step {c.index(max(c)) + 1}, step 1 "
              f"{c[0]:.6f}; {out[name + '_s']:.1f} s", flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["port"], out["jax"])]
    print(f"port against jax, relative difference a step "
          f"{[f'{r:.2e}' for r in rel]}")
    print(json.dumps(dict(vars(args), jax=out["jax"], port=out["port"],
                          max_rel=max(rel))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
