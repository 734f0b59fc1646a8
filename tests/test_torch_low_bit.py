"""Low-bit optimizers of the PyTorch port against the JAX package.

``q_adamw`` (8 and 4 bit) and ``q_agd`` (8 and 4 bit) of the port
against the optax transforms, five steps on a small tree that mixes
bf16 and fp32 leaves (so the reference's joint tile dtype is fp32 and
its bf16 leaves' updates are rounded once, at the end, as the port's
are).  The reference's update and ``optax.apply_updates`` run under
``jax.jit``, as its training step runs them, from the same numpy
params and gradients.  Tolerances: fp32 leaves within 1e-5 (XLA
contracts some products and sums into FMAs, which the port does not);
bf16 leaves within one bf16 ulp.  Then the state: the ``nu_domain``
tag, the v0 migration, the carry to and from the reference's layout,
and the port's own state dict, each bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.ops import quantization as jq
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.ops import quantization as pq
from dlrover_tpu_torch.optim import low_bit as plb
from dlrover_tpu_torch.utils.convert import (
    params_from_jax,
    qadamw_state_from_jax,
    qadamw_state_to_jax,
)

BLOCK = 64
STEPS = 5
# name -> (shape, dtype): ragged leaves, none a multiple of the block
TREE = {"w": ((37, 50), "float32"), "emb": ((300,), "bfloat16"),
        "conv": ((9, 7, 5), "float32"), "head": ((40, 9), "bfloat16")}
CASES = {
    "q_adamw8": (lambda lr: jlb.q_adamw(lr, weight_decay=0.1, block_size=BLOCK),
                 lambda ps, lr: plb.q_adamw(ps, lr=lr, weight_decay=0.1,
                                            block_size=BLOCK)),
    "q_adamw4": (lambda lr: jlb.q_adamw(lr, weight_decay=0.1, block_size=BLOCK,
                                        bits=4),
                 lambda ps, lr: plb.q_adamw(ps, lr=lr, weight_decay=0.1,
                                            block_size=BLOCK, bits=4)),
    "q_agd8": (lambda lr: jlb.q_agd(lr, weight_decay=0.1, block_size=BLOCK),
               lambda ps, lr: plb.q_agd(ps, lr=lr, weight_decay=0.1,
                                        block_size=BLOCK)),
    "q_agd4": (lambda lr: jlb.q_agd(lr, weight_decay=0.1, block_size=BLOCK,
                                    bits=4),
               lambda ps, lr: plb.q_agd(ps, lr=lr, weight_decay=0.1,
                                        block_size=BLOCK, bits=4)),
}


def _jdtype(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def _init(seed):
    rng = np.random.default_rng(seed)
    jparams = {k: jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                              _jdtype(dt)) for k, (shape, dt) in TREE.items()}
    tparams = {k: torch.nn.Parameter(_to_torch(v)) for k, v in jparams.items()}
    return rng, jparams, tparams


def _to_torch(x):
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _jit_step(opt):
    def step(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return jax.jit(step)


def run_pair(case, seed=0, lr=1e-2, schedule=None):
    """STEPS steps of the reference's transform and of the port's
    optimizer on the same params and gradients; ``schedule`` (an optax
    schedule) drives the reference and, through ``LambdaLR``, the
    port.  Returns ``(jax params, port params)``."""
    jfactory, pfactory = CASES[case]
    rng, jparams, tparams = _init(seed)
    opt = jfactory(schedule or lr)
    state = opt.init(jparams)
    jstep = _jit_step(opt)
    popt = pfactory(list(tparams.values()), 1.0 if schedule else lr)
    sched = (torch.optim.lr_scheduler.LambdaLR(
        popt, lambda k: float(schedule(k))) if schedule else None)
    for _ in range(STEPS):
        grads = {k: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32), v.dtype) for k, v in jparams.items()}
        jparams, state = jstep(grads, state, jparams)
        for k, p in tparams.items():
            p.grad = _to_torch(grads[k])
        popt.step()
        if sched:
            sched.step()
    return jparams, {k: p.detach() for k, p in tparams.items()}


def assert_params_close(jparams, tparams):
    for k, (_, dt) in TREE.items():
        want = np.asarray(jparams[k].astype(jnp.float32))
        got = tparams[k].float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)
        else:
            ulp = np.spacing(np.abs(want)) * 2.0 ** 16  # bf16 ulp
            assert (np.abs(got - want) <= ulp).all(), k


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_optax(case):
    assert_params_close(*run_pair(case))


@pytest.mark.parametrize("case", ["q_adamw8", "q_adamw4"])
def test_lr_schedule_matches_optax(case):
    """A torch ``LambdaLR`` giving optax's ``linear_schedule`` values.
    The reference runs its kernel at lr 1 and scales the update; the
    port passes the scheduled lr into the step: the same to an ulp."""
    jparams, tparams = run_pair(
        case, schedule=optax.linear_schedule(1e-2, 1e-3, STEPS))
    assert_params_close(jparams, tparams)


def test_state_is_quantized_and_tagged():
    _, _, tparams = _init(0)
    opt = plb.q_adamw(list(tparams.values()), block_size=BLOCK)
    st = opt.state[tparams["w"]]
    rows = -(-37 * 50 // BLOCK)
    assert st["mu_values"].dtype == torch.int8
    assert st["mu_values"].shape == (rows, BLOCK)
    assert st["nu_scales"].shape == (rows, 1)
    assert st["nu_scales"].dtype == torch.float32
    assert st["step"] == 0
    sd = opt.state_dict()
    assert sd["nu_domain"] == plb.NU_DOMAIN_SQRT_V1 == jlb.NU_DOMAIN_SQRT_V1
    untagged = {k: v for k, v in sd.items() if k != "nu_domain"}
    with pytest.raises(ValueError, match="migrate_qadamw_state_v0"):
        opt.load_state_dict(untagged)
    four = plb.q_adamw(list(tparams.values()), block_size=BLOCK, bits=4)
    st4 = four.state[tparams["w"]]
    assert st4["mu_values"].dtype == torch.uint8
    assert st4["mu_values"].shape == (rows, BLOCK // 2)
    assert four.state_dict()["nu_domain"] == plb.NU_DOMAIN_SQRT_V1
    with pytest.raises(ValueError, match="bits"):
        plb.q_adamw(list(tparams.values()), bits=2)


def test_migrate_v0_matches_jax():
    """An old linear-domain nu requantizes to the sqrt domain code for
    code, as the reference's migration does (under ``jax.jit``)."""
    rng = np.random.default_rng(6)
    rows = 5
    nu_true = (rng.standard_normal((rows, BLOCK)) ** 2 * 1e-4).astype(
        np.float32)
    q, s = jq._quantize_tiles(jnp.asarray(nu_true), BLOCK, 127.0)
    mu = jlb.QMoment(values=jnp.zeros_like(q), scales=jnp.ones_like(s))
    old = (jnp.asarray(3, jnp.int32), {"w": mu},
           {"w": jlb.QMoment(values=q, scales=s)})
    new = jax.jit(jlb.migrate_qadamw_state_v0, static_argnums=1)(old, BLOCK)
    st = {"step": 3, "mu_values": _to_torch(mu.values),
          "mu_scales": _to_torch(mu.scales), "nu_values": _to_torch(q),
          "nu_scales": _to_torch(s)}
    got = plb.migrate_qadamw_state_v0({"state": {0: st}}, BLOCK)
    assert got["nu_domain"] == int(new.nu_domain) == plb.NU_DOMAIN_SQRT_V1
    np.testing.assert_array_equal(got["state"][0]["nu_values"].numpy(),
                                  np.asarray(new.nu["w"].values))
    np.testing.assert_array_equal(got["state"][0]["nu_scales"].numpy(),
                                  np.asarray(new.nu["w"].scales))
    assert got["state"][0]["mu_values"] is st["mu_values"]
    # and the port's optimizer takes the migrated state
    w = torch.nn.Parameter(torch.zeros(rows * BLOCK))
    opt = plb.q_adamw([w], block_size=BLOCK)
    opt.load_state_dict(got)
    assert torch.equal(opt.state[w]["nu_values"], got["state"][0]["nu_values"])


def _tiny_gpt():
    cfg = jax_gpt.GPTConfig.tiny(param_dtype=jnp.bfloat16)
    params = jax.jit(lambda k: jax_gpt.GPT(cfg).init(
        k, jnp.zeros((2, 16), jnp.int32))["params"])(jax.random.PRNGKey(0))
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(param_dtype=torch.bfloat16),
                         device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32), p.dtype), params)


def _set_grads(model, grads):
    sd = params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        p.grad = sd[name]


def test_state_carries_from_and_to_jax_bit_exact():
    """The reference's state after two steps loads into the port code
    for code; one more step on each side from those moments agrees;
    and the port's state goes back to the reference's layout
    unchanged."""
    params, model = _tiny_gpt()
    opt = jlb.q_adamw(1e-2, weight_decay=0.1, block_size=BLOCK)
    state = opt.init(params)
    jstep = _jit_step(opt)
    for seed in (1, 2):
        params, state = jstep(_random_grads(params, seed), state, params)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    popt = plb.q_adamw(model.parameters(), lr=1e-2, weight_decay=0.1,
                       block_size=BLOCK)
    popt.load_state_dict(qadamw_state_from_jax(
        jax.tree.map(np.asarray, state), model))
    back = qadamw_state_to_jax(popt, model)
    assert int(back["count"]) == int(state.count) == 2
    assert int(back["nu_domain"]) == int(state.nu_domain)
    for which in ("mu", "nu"):
        got = jax.tree_util.tree_leaves(back[which])
        want = jax.tree_util.tree_leaves(getattr(state, which))
        assert len(got) == len(want) == 2 * len(list(model.parameters()))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, np.asarray(w))
    # and the reference's layout back into a fresh optimizer: the
    # port -> reference -> port trip leaves every tensor as it was
    again = plb.q_adamw(model.parameters(), lr=1e-2, weight_decay=0.1,
                        block_size=BLOCK)
    again.load_state_dict(qadamw_state_from_jax(back, model))
    for p in model.parameters():
        for k, v in popt.state[p].items():
            w = again.state[p][k]
            assert (v == w) if k == "step" else torch.equal(v, w), k
    grads = _random_grads(params, 3)
    params, state = jstep(grads, state, params)
    _set_grads(model, grads)
    popt.step()
    want = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        got, ref = p.detach().float().numpy(), want[name].float().numpy()
        if p.dtype == torch.float32:
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
        else:
            ulp = np.spacing(np.abs(ref)) * 2.0 ** 16
            assert (np.abs(got - ref) <= ulp).all(), name
    # the reference's update takes the port's state as its own
    jstate = jlb.QAdamWState(
        count=jnp.asarray(back["count"]),
        mu=jax.tree.map(lambda m: jlb.QMoment(*m), back["mu"],
                        is_leaf=lambda x: isinstance(x, plb.QMoment)),
        nu=jax.tree.map(lambda m: jlb.QMoment(*m), back["nu"],
                        is_leaf=lambda x: isinstance(x, plb.QMoment)),
        nu_domain=jnp.asarray(back["nu_domain"]),
    )
    jstep(grads, jstate, params)


@pytest.mark.parametrize("bits", [8, 4])
def test_state_dict_round_trip(bits):
    """A second optimizer loaded from the first's state dict takes the
    same next step, bit for bit; the loaded state is a copy."""
    runs = []
    for _ in range(2):
        _, model = _tiny_gpt()
        runs.append((model, plb.q_adamw(model.parameters(), lr=1e-2,
                                        block_size=BLOCK, bits=bits)))
    (m1, o1), (m2, o2) = runs
    _set_grads(m1, _random_grads(jax.tree.map(
        jnp.asarray, _tiny_gpt()[0]), 4))
    o1.step()
    m2.load_state_dict(m1.state_dict())
    o2.load_state_dict(o1.state_dict())
    p0 = next(m1.parameters())
    assert o2.state[next(m2.parameters())]["mu_values"].data_ptr() != \
        o1.state[p0]["mu_values"].data_ptr()
    grads = _random_grads(jax.tree.map(jnp.asarray, _tiny_gpt()[0]), 5)
    for model, opt in runs:
        _set_grads(model, grads)
        opt.step()
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(o1.state.values(), o2.state.values()):
        assert a["step"] == b["step"] == 2
        for k in ("mu_values", "mu_scales", "nu_values", "nu_scales"):
            assert torch.equal(a[k], b[k]), k


def test_loaded_state_is_contiguous_on_the_parameters_device():
    """``load_state_dict`` lays strided state out contiguous on each
    parameter's device, as the step's launch takes it unchecked: the
    next step equals that of the same state loaded as it was saved."""
    runs = []
    for _ in range(3):
        _, model = _tiny_gpt()
        runs.append((model, plb.q_adamw(model.parameters(), lr=1e-2,
                                        block_size=BLOCK)))
    params = jax.tree.map(jnp.asarray, _tiny_gpt()[0])
    m0, o0 = runs[0]
    _set_grads(m0, _random_grads(params, 6))
    o0.step()
    sd = o0.state_dict()
    strided = {**sd, "state": {k: {n: (v.t().contiguous().t()
                                       if torch.is_tensor(v) else v)
                                   for n, v in st.items()}
                               for k, st in sd["state"].items()}}
    assert not strided["state"][0]["mu_values"].is_contiguous()
    for (model, opt), state in zip(runs[1:], (sd, strided)):
        model.load_state_dict(m0.state_dict())
        opt.load_state_dict(state)
        for st in opt.state.values():
            for k in ("mu_values", "mu_scales", "nu_values", "nu_scales"):
                assert st[k].is_contiguous(), k
        _set_grads(model, _random_grads(params, 7))
        opt.step()
    (m1, o1), (m2, o2) = runs[1:]
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
        for k in ("mu_values", "mu_scales", "nu_values", "nu_scales"):
            assert torch.equal(o1.state[a][k], o2.state[b][k]), (n, k)


def test_qadamw_step_is_the_per_leaf_step():
    """``QAdamW.step`` hands all its 8-bit leaves to one multi-tensor
    update; on a tiny GPT that gives, bit for bit, the parameters and
    state of the fused step taken leaf by leaf, each with its own step
    count (one parameter skips the first step)."""
    runs = [_tiny_gpt()[1] for _ in range(2)]
    opts = [plb.q_adamw(m.parameters(), lr=1e-2, weight_decay=0.1,
                        block_size=BLOCK) for m in runs]
    skipped = "blocks.0.attn.qkv.weight"
    params = jax.tree.map(jnp.asarray, _tiny_gpt()[0])
    for seed in (11, 12):
        for model in runs:
            _set_grads(model, _random_grads(params, seed))
            if seed == 11:
                dict(model.named_parameters())[skipped].grad = None
        opts[0].step()
        group = opts[1].param_groups[0]
        for p in group["params"]:
            if p.grad is None:
                continue
            st = opts[1].state[p]
            st["step"] += 1
            bc1, bc2 = pq.bias_corrections(group["b1"], group["b2"],
                                           st["step"])
            with torch.no_grad():
                pq.fused_qadam_update_(
                    p, p.grad, st["mu_values"], st["mu_scales"],
                    st["nu_values"], st["nu_scales"], bc1=bc1, bc2=bc2,
                    b1=group["b1"], b2=group["b2"], eps=group["eps"],
                    lr=group["lr"], wd=group["weight_decay"])
    (m1, m2), (o1, o2) = runs, opts
    steps = set()
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
        s1, s2 = o1.state[a], o2.state[b]
        assert s1["step"] == s2["step"], n
        steps.add(s1["step"])
        for k in ("mu_values", "mu_scales", "nu_values", "nu_scales"):
            assert torch.equal(s1[k], s2[k]), (n, k)
    assert steps == {1, 2}


def test_cpu_steps_launch_no_kernel():
    pq.reset_launch_counts()
    run_pair("q_adamw8")
    run_pair("q_agd4")
    assert pq.LAUNCHES == {"quantize": 0, "dequantize": 0, "qadam": 0}


def parity_report():
    """Largest differences of the port's low-bit optimizers from the
    JAX package's on the cases above."""
    for case in CASES:
        jparams, tparams = run_pair(case)
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
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_low_bit.py
    parity_report()
