"""CAME and quantized Adafactor of the PyTorch port against the JAX package.

``came``, ``q_came`` and ``q_adafactor`` (relative step, fixed lr
without a first moment, warm-up init) of the port against the optax
transforms under ``jax.jit``, five steps on a tree that mixes bf16 and
fp32 leaves of one, two and three dims (factored and whole second
moments).  Tolerances: fp32 leaves within 1e-5 (reductions run in
another order and XLA forms FMAs), bf16 leaves within one bf16 ulp.
The inputs come from seed 0.  On other seeds an int8 code of the
quantized first moment can land on the other side of a .5 boundary
(the same FMAs), after which a parameter differs by up to lr times one
code step per step: seeds 0 to 3 showed one such code in 37,000.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

jcame = importlib.import_module("dlrover_tpu.optim.came")
pcame = importlib.import_module("dlrover_tpu_torch.optim.came")

STEPS, BLOCK = 5, 64
TREE = {"w": ((37, 50), "float32"), "emb": ((300,), "bfloat16"),
        "conv": ((9, 7, 5), "float32"), "head": ((40, 9), "bfloat16")}
CASES = {
    "came": (lambda: jcame.came(1e-2, weight_decay=0.1),
             lambda ps: pcame.came(ps, lr=1e-2, weight_decay=0.1)),
    "q_came": (lambda: jcame.q_came(1e-2, weight_decay=0.1, block_size=BLOCK),
               lambda ps: pcame.q_came(ps, lr=1e-2, weight_decay=0.1,
                                       block_size=BLOCK)),
    "q_adafactor": (lambda: jcame.q_adafactor(block_size=BLOCK),
                    lambda ps: pcame.q_adafactor(ps, block_size=BLOCK)),
    "q_adafactor_no_momentum": (
        lambda: jcame.q_adafactor(1e-2, beta1=None, weight_decay=0.1,
                                  block_size=BLOCK),
        lambda ps: pcame.q_adafactor(ps, lr=1e-2, beta1=None,
                                     weight_decay=0.1, block_size=BLOCK)),
    "q_adafactor_warmup": (
        lambda: jcame.q_adafactor(warmup_init=True, scale_parameter=False,
                                  block_size=BLOCK),
        lambda ps: pcame.q_adafactor(ps, warmup_init=True,
                                     scale_parameter=False, block_size=BLOCK)),
}


def _to_torch(x):
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def run_pair(case, seed=0):
    jfactory, pfactory = CASES[case]
    rng = np.random.default_rng(seed)
    jparams = {k: jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                              jnp.bfloat16 if dt == "bfloat16" else jnp.float32)
               for k, (shape, dt) in TREE.items()}
    tparams = {k: torch.nn.Parameter(_to_torch(v)) for k, v in jparams.items()}
    opt = jfactory()
    state = opt.init(jparams)

    @jax.jit
    def jstep(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    popt = pfactory(list(tparams.values()))
    for _ in range(STEPS):
        grads = {k: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32), v.dtype) for k, v in jparams.items()}
        jparams, state = jstep(grads, state, jparams)
        for k, p in tparams.items():
            p.grad = _to_torch(grads[k])
        popt.step()
    return jparams, {k: p.detach() for k, p in tparams.items()}, popt


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_optax(case):
    jparams, tparams, _ = run_pair(case)
    for k, (_, dt) in TREE.items():
        want = np.asarray(jparams[k].astype(jnp.float32))
        got = tparams[k].float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)
        else:
            ulp = np.spacing(np.abs(want)) * 2.0 ** 16
            assert (np.abs(got - want) <= ulp).all(), k


def test_state_layout_follows_the_reference():
    """Factored row/col statistics for leaves of two or more dims, a
    whole buffer for vectors; the q variants keep mu as int8 codes,
    ``beta1=None`` keeps none."""
    w = torch.nn.Parameter(torch.zeros(6, 7, 5))
    v = torch.nn.Parameter(torch.zeros(300))
    opt = pcame.q_came([w, v], block_size=BLOCK)
    st = opt.state[w]
    assert st["nu_row"].shape == (6, 7) and st["nu_col"].shape == (6, 5)
    assert st["res_row"].shape == (6, 7) and st["nu_full"].shape == ()
    assert opt.state[v]["nu_full"].shape == (300,)
    assert opt.state[v]["nu_row"].shape == ()
    assert st["mu_values"].dtype == torch.int8
    assert st["mu_values"].shape == (-(-210 // BLOCK), BLOCK)
    assert opt.state[w]["step"] == 0
    assert pcame.came([w])._param_state(w)["mu"].dtype == torch.float32
    bare = pcame.q_adafactor([w], beta1=None, block_size=BLOCK)
    assert "mu_values" not in bare.state[w]
    ref = jcame.q_came(block_size=BLOCK).init({"w": jnp.zeros((6, 7, 5))})
    assert ref.nu["w"].row.shape == (6, 7) and ref.nu["w"].col.shape == (6, 5)


def parity_report():
    """Largest differences of the port's CAME family from the JAX
    package's on the cases above."""
    for case in CASES:
        jparams, tparams, _ = run_pair(case)
        errs = {}
        for k, (_, dt) in TREE.items():
            want = np.asarray(jparams[k].astype(jnp.float32))
            err = np.abs(tparams[k].float().numpy() - want)
            if dt == "bfloat16":
                err = err / (np.spacing(np.abs(want)) * 2.0 ** 16)
            errs[dt] = max(errs.get(dt, 0.0), float(err.max()))
        print(f"{case}, {STEPS} steps: fp32 leaves max_abs_err "
              f"{errs['float32']:.3e}, bf16 leaves max err "
              f"{errs['bfloat16']:.1f} ulp")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_came.py
    parity_report()
