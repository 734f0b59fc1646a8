"""The optimizers of slice 4.1 against the JAX package's optax ones.

``agd``, ``adamw_bf16``, ``with_fp32_master``, ``wsam`` (with
``sam_gradient``) and ``adamw_offload`` take five steps from the same
numpy params on the same gradients (drawn with numpy; WSAM's come from
one loss both sides differentiate) and hold at rtol 1e-5 and atol 1e-6
(fp32; bf16 params are held to their fp32 masters and to each other up
to one bf16 rounding).  Then the twins of ``tests/test_optim.py``'s
cases for these optimizers (AGD's convergence and moment, SAM's
perturbed gradient, WSAM's loop, the fp32 master under bf16 and with
AdamW, the offloaded state), and the JAX package's optimizer states
converted by ``utils.convert.optimizer_state_from_jax`` continuing in
the port as they continue in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu import optim as jax_optim
from dlrover_tpu_torch import optim as port_optim
from dlrover_tpu_torch.utils.convert import optimizer_state_from_jax

STEPS = 5
SHAPES = {"w": (8, 4), "b": (4,)}


def _params(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(dtype) for k, s in SHAPES.items()}


def _grads(n=STEPS, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * 0.1).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _nest(d):
    """``{"w": x}`` -> the flax-shaped ``{"w": {"kernel": x}}`` that
    ``utils.convert`` maps onto the port's ``w.weight``."""
    return {k: {"kernel": v} for k, v in d.items()}


def _unnest(d):
    return {k: v["kernel"] for k, v in d.items()}


def _jax_run(opt, params, grads, state=None):
    """Steps of ``opt`` over flat ``params``; (flat params, state)."""
    params = _nest(params)
    state = opt.init(params) if state is None else state

    @jax.jit
    def step(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    for g in grads:
        g = _nest({k: v.astype(np.asarray(params[k]["kernel"]).dtype)
                   for k, v in g.items()})
        params, state = step(params, state, g)
    return _unnest(jax.tree.map(np.asarray, params)), state


class _Model(torch.nn.Module):
    """Parameters named as the flax tree ``{"w": ..., "b": ...}``
    (``utils.convert`` maps ``w.weight`` <-> ``w/kernel``)."""

    def __init__(self, params):
        super().__init__()
        self.w = torch.nn.Module()
        self.b = torch.nn.Module()
        self.w.weight = torch.nn.Parameter(_t(params["w"]))
        self.b.weight = torch.nn.Parameter(_t(params["b"]))

    def tensors(self):
        return {"w": self.w.weight, "b": self.b.weight}


def _t(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _port_run(opt, model, grads):
    for g in grads:
        for k, p in model.tensors().items():
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        opt.step()
    return {k: _np(p) for k, p in model.tensors().items()}


def _small_chunks(opt, nbytes=64):
    """Offload in chunks of ``nbytes`` of state: a parameter each here."""
    opt.chunk_bytes = nbytes
    return opt


def _close(got, want, rtol=1e-5, atol=1e-6):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


CASES = {
    "agd": (lambda: jax_optim.agd(learning_rate=0.05, weight_decay=0.01),
            lambda ps: port_optim.agd(ps, learning_rate=0.05,
                                      weight_decay=0.01)),
    "adamw_bf16": (
        lambda: jax_optim.adamw_bf16(learning_rate=0.05, weight_decay=0.01),
        lambda ps: port_optim.adamw_bf16(ps, learning_rate=0.05,
                                         weight_decay=0.01)),
    "adamw_offload": (
        lambda: jax_optim.adamw_offload(0.05, weight_decay=0.01),
        lambda ps: _small_chunks(port_optim.adamw_offload(
            ps, learning_rate=0.05, weight_decay=0.01))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_optax(name):
    jax_opt, port_opt = CASES[name]
    params = _params()
    want, _ = _jax_run(jax_opt(), params, _grads())
    model = _Model(params)
    got = _port_run(port_opt(model.parameters()), model, _grads())
    _close(got, want)


def test_fp32_master_steps_match_optax():
    """bf16 params over fp32 masters with AdamW inside: the masters hold
    to optax's at 1e-5, each side's params are its masters rounded to
    bf16, and the two sides' params differ by at most one bf16 rounding
    of masters that agree."""
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _params())
    opt = jax_optim.with_fp32_master(optax.adamw(0.05, weight_decay=0.01))
    want, state = _jax_run(opt, params, _grads())
    model = _Model(jax.tree.map(np.asarray, params))  # bf16 leaves
    port = port_optim.with_fp32_master(
        model.parameters(), lambda ms: port_optim.OptaxAdamW(
            ms, lr=0.05, weight_decay=0.01))
    got = _port_run(port, model, _grads())
    masters = {k: m.detach().numpy()
               for k, m in zip(("w", "b"), port.masters)}
    _close(masters, _unnest(jax.tree.map(np.asarray, state.master)))
    for k, m in masters.items():
        rounded = torch.from_numpy(m).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[k], rounded)
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   rtol=2 ** -7)


def _wsam_loss_np(p):
    return jnp.sum(jnp.sin(p["w"]) * p["w"] ** 2) + jnp.sum(
        (p["b"] - 0.5) ** 2 * p["b"])


def _wsam_loss_torch(model):
    t = model.tensors()
    return torch.sum(torch.sin(t["w"]) * t["w"] ** 2) + torch.sum(
        (t["b"] - 0.5) ** 2 * t["b"])


def test_wsam_steps_match_the_reference():
    params = _params()
    opt = jax_optim.wsam(optax.sgd(0.05))
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        _, g = jax_optim.sam_gradient(lambda q, b: _wsam_loss_np(q), p,
                                      None, rho=0.1, gamma=0.7)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    p = params
    for _ in range(STEPS):
        p, state = step(p, state)
    model = _Model(params)
    port = port_optim.wsam(model.parameters(), learning_rate=0.05, rho=0.1,
                           gamma=0.7)

    def closure():
        loss = _wsam_loss_torch(model)
        loss.backward()
        return loss

    for _ in range(STEPS):
        port.zero_grad()
        closure()
        port.step(closure)
    _close({k: _np(v) for k, v in model.tensors().items()},
           jax.tree.map(np.asarray, p))


def test_sam_gradient_matches_the_reference():
    params = _params()
    loss_j, g_j = jax_optim.sam_gradient(lambda q, b: _wsam_loss_np(q),
                                         params, None, rho=0.1, gamma=0.5)
    model = _Model(params)
    loss_p, g_p = port_optim.sam_gradient(lambda m, b: _wsam_loss_torch(m),
                                          model, None, rho=0.1, gamma=0.5)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-6)
    _close({"w": g_p[0].numpy(), "b": g_p[1].numpy()},
           jax.tree.map(np.asarray, g_j))
    # the parameters are left as they were
    _close({k: _np(v) for k, v in model.tensors().items()}, params, 0, 0)


# -- twins of tests/test_optim.py ----------------------------------------------


def _quadratic_run(opt_factory, n, target=None):
    target = torch.arange(1.0, 9.0) if target is None else target
    w = torch.nn.Parameter(torch.zeros(8))
    opt = opt_factory([w])
    for _ in range(n):
        opt.zero_grad()
        torch.sum((w - target) ** 2).backward()
        opt.step()
    return w.detach(), target


def test_agd_converges_on_quadratic():
    w, target = _quadratic_run(lambda ps: port_optim.agd(ps, 0.1), 200)
    torch.testing.assert_close(w, target, atol=0.05, rtol=0)


def test_agd_state_has_grad_diff_moment():
    w = torch.nn.Parameter(torch.zeros(8))
    opt = port_optim.agd([w], 0.1)
    w.grad = torch.full((8,), -2.0)
    opt.step()
    nu1 = opt.state[w]["nu"].abs().sum().item()
    w.grad = torch.full((8,), -2.0)
    opt.step()
    assert opt.state[w]["nu"].abs().sum().item() <= nu1 + 1e-6


def test_sam_gradient_perturbs():
    model = _Model({"w": np.ones((8, 4), np.float32),
                    "b": np.ones(4, np.float32)})
    _, g_wsam = port_optim.sam_gradient(
        lambda m, b: _wsam_loss_torch(m), model, None, rho=0.1, gamma=0.5)
    loss = _wsam_loss_torch(model)
    plain = torch.autograd.grad(loss, list(model.parameters()))
    assert (g_wsam[0] - plain[0]).abs().sum() > 1e-6
    _, g0 = port_optim.sam_gradient(
        lambda m, b: _wsam_loss_torch(m), model, None, rho=0.1, gamma=0.0)
    torch.testing.assert_close(g0[0], plain[0], atol=1e-6, rtol=0)


def test_wsam_full_loop_converges():
    target = torch.arange(1.0, 9.0)
    w = torch.nn.Parameter(torch.zeros(8))
    opt = port_optim.wsam([w], torch.optim.SGD([w], lr=0.05), rho=0.01,
                          gamma=0.5)

    def closure():
        loss = torch.sum((w - target) ** 2)
        loss.backward()
        return loss

    for _ in range(300):
        opt.zero_grad()
        closure()
        opt.step(closure)
    torch.testing.assert_close(w.detach(), target, atol=0.05, rtol=0)


def test_fp32_master_prevents_bf16_update_loss():
    p_plain = torch.nn.Parameter(torch.ones(64, dtype=torch.bfloat16))
    p_master = torch.nn.Parameter(torch.ones(64, dtype=torch.bfloat16))
    plain = torch.optim.SGD([p_plain], lr=1e-2)
    opt = port_optim.with_fp32_master(
        [p_master], lambda ms: torch.optim.SGD(ms, lr=1e-2))
    for _ in range(1000):
        for p, o in ((p_plain, plain), (p_master, opt)):
            p.grad = torch.full((64,), 1e-4, dtype=torch.bfloat16)
            o.step()
    assert p_plain[0].item() == 1.0  # bf16 swallowed every step
    np.testing.assert_allclose(p_master.float().detach().numpy(),
                               np.full(64, 1.0 - 1e-3), rtol=3e-3)
    torch.testing.assert_close(p_master.detach(),
                               opt.masters[0].detach().to(torch.bfloat16))


def test_fp32_master_with_adamw_converges_bf16():
    target = torch.arange(1.0, 9.0)
    w = torch.nn.Parameter(torch.zeros(8, dtype=torch.bfloat16))
    opt = port_optim.with_fp32_master(
        [w], lambda ms: torch.optim.AdamW(ms, lr=0.1, weight_decay=0.0))
    for _ in range(300):
        opt.zero_grad()
        w.grad = None
        torch.sum((w.float() - target) ** 2).backward()
        opt.step()
    assert w.dtype == torch.bfloat16
    torch.testing.assert_close(w.float().detach(), target, atol=0.1, rtol=0)


def test_offload_state_lives_on_host_and_converges():
    """On the CPU the host is the device: the wrapper steps its chunks
    (here one parameter each) with the state in host memory, and
    converges as AdamW does."""
    w, target = _quadratic_run(
        lambda ps: _small_chunks(port_optim.adamw_offload(
            ps, 0.1, weight_decay=0.0), 16), 200)
    torch.testing.assert_close(w, target, atol=0.05, rtol=0)
    model = _Model(_params())
    opt = _small_chunks(port_optim.adamw_offload(model.parameters()), 16)
    assert len(opt._chunks(list(model.parameters()))) == 2
    _port_run(opt, model, _grads(1))
    devices = {v.device.type for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim()}
    assert devices == {"cpu"}


# -- JAX states carried across -----------------------------------------------


CONVERT = {
    "adamw": (lambda: optax.adamw(0.05, weight_decay=0.01),
              lambda ps: torch.optim.AdamW(ps, lr=0.05, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=0.01)),
    "adamw_bf16": CASES["adamw_bf16"],
    "agd": CASES["agd"],
    "offload": CASES["adamw_offload"],
    "fp32_master": (
        lambda: jax_optim.with_fp32_master(optax.adamw(0.05,
                                                       weight_decay=0.01)),
        lambda ps: port_optim.with_fp32_master(
            ps, lambda ms: port_optim.OptaxAdamW(ms, lr=0.05,
                                                 weight_decay=0.01))),
    "wsam_momentum": (
        lambda: jax_optim.wsam(optax.sgd(0.05, momentum=0.9)),
        lambda ps: port_optim.wsam(
            ps, torch.optim.SGD(ps, lr=0.05, momentum=0.9))),
}


@pytest.mark.parametrize("name", list(CONVERT))
def test_jax_optimizer_states_continue_in_the_port(name):
    """Two steps in the JAX package, its state converted into the
    port's optimizer, three more on both sides from there."""
    jax_opt, port_opt = CONVERT[name]
    params = _params()
    if name == "wsam_momentum":
        params = {k: v for k, v in params.items()}
    grads = _grads()
    opt = jax_opt()
    mid, state = _jax_run(opt, params, grads[:2])
    want, _ = _jax_run(opt, mid, grads[2:], state=state)
    model = _Model(mid)
    port = port_opt(list(model.parameters()))
    sd = optimizer_state_from_jax(jax.tree.map(np.asarray, state), port,
                                  model)
    port.load_state_dict(sd)
    if name == "wsam_momentum":
        # the base optimizer steps on the given gradients as optax does
        port = port.base
    got = _port_run(port, model, grads[2:])
    _close(got, want)


def test_low_bit_agd_shares_agd_update_rule():
    """The int8 AGD of slice 2 and the AGD of this slice take the same
    update (the reference's): from equal state, their first step agrees
    to the int8 moments' rounding."""
    params = _params()
    a, b = _Model(params), _Model(params)
    full = port_optim.agd(a.parameters(), 0.05)
    low = port_optim.q_agd(list(b.parameters()), lr=0.05, block_size=32)
    g = _grads(1)
    got_a = _port_run(full, a, g)
    got_b = _port_run(low, b, g)
    for k in got_a:
        np.testing.assert_allclose(got_b[k], got_a[k], atol=1e-4)
