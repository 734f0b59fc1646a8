"""GPT's ``save_attn`` remat policy in the PyTorch port against the JAX
package's.

The reference (``dlrover_tpu/models/gpt.py``, ``_remat_policy``) keeps
each block's ``attn_out`` (the attention module's output, after
``o_proj``) and recomputes the rest; the port checkpoints each block in
two halves split there.  Checked, on ``GPTConfig.tiny`` with flash
attention (Pallas in interpret mode on the JAX side, the plain flash
versions on the port's):

- the loss and every gradient against the JAX package's save_attn from
  one flax init, fp32: loss within 1e-5 relative, gradients within
  atol 1e-4 / rtol 1e-3 (as ``tests/test_torch_gpt.py``), and against
  the port's own full remat, which runs the same ops: equal;
- the flash calls of one training step (forward and backward) equal
  the ``pallas_call`` equations of the reference's
  ``jax.make_jaxpr(jax.grad(loss))``, read from the jaxpr, for no
  remat, full remat and save_attn alike;
- what the policy keeps: one more saved activation a block than full
  remat, of the block's residual shape (``attn_out``);
- the ``checkpoint`` opt keeps a save_attn model's policy (the model
  config alone chooses it), so the Trainer's default strategy leaves
  the model as it is; ``offload_activation`` still replaces it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.utils.convert import params_from_jax, params_to_jax

SEQ = 32
POLICIES = {"none": dict(), "full": dict(remat=True),
            "save_attn": dict(remat=True, remat_policy="save_attn")}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tokens(seed=1, batch=2, vocab=256):
    data = np.random.default_rng(seed).integers(
        0, vocab, (batch, SEQ + 1), dtype=np.int32)
    return data[:, :-1], data[:, 1:]


@pytest.fixture(scope="module")
def flax_init():
    model = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, SEQ), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_loss(policy):
    model = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(
        attention_impl="flash", dtype=jnp.float32, **POLICIES[policy]))
    x, y = _tokens()

    def loss(p):
        return jax_gpt.cross_entropy_loss(
            model.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    return loss


def _port_step(params, policy):
    """Loss and ``{flax path: grad}`` of one port step."""
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(
        attention_impl="flash", dtype=torch.float32, **POLICIES[policy]),
        device="cpu")
    model.load_state_dict(params_from_jax(params))
    x, y = _tokens()
    loss = port_gpt.cross_entropy_loss(model(torch.from_numpy(x)),
                                       torch.from_numpy(y))
    loss.backward()
    grads = dict(_flat(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()})))
    return loss.detach(), grads


def test_save_attn_matches_the_jax_package(flax_init):
    (jl, jgrads) = jax.jit(jax.value_and_grad(_jax_loss("save_attn")))(
        jax.tree.map(jnp.asarray, flax_init))
    loss, grads = _port_step(flax_init, "save_attn")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jgrads = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert sorted(grads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name], g, atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def test_save_attn_equals_full_remat(flax_init):
    """The same ops in the same order: the loss and gradients of full
    remat, bit for bit."""
    loss, grads = _port_step(flax_init, "save_attn")
    full_loss, full_grads = _port_step(flax_init, "full")
    assert torch.equal(loss, full_loss)
    for name, g in full_grads.items():
        np.testing.assert_array_equal(grads[name], g,
                                      err_msg=name)


def _pallas_calls(jaxpr) -> int:
    """``pallas_call`` equations in ``jaxpr`` and every jaxpr nested in
    its equations' params (remat, custom_vjp, pjit)."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            n += 1
            continue
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _pallas_calls(inner)
    return n


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_flash_calls_a_step_equal_the_reference_jaxpr(flax_init, policy,
                                                      monkeypatch):
    """The plain flash versions run on the CPU exactly as often in one
    training step as the reference's jaxpr holds Pallas calls (save_attn
    re-runs the flash forward in the backward, as full remat does: the
    flash VJP needs O and lse, which ``attn_out`` is not)."""
    closed = jax.make_jaxpr(jax.grad(_jax_loss(policy)))(
        jax.tree.map(jnp.asarray, flax_init))
    want = _pallas_calls(closed.jaxpr)
    calls = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    for name, fn in (("fwd", fa.fwd_plain), ("bwd_dq", fa.bwd_dq_plain),
                     ("bwd_dkv", fa.bwd_dkv_plain)):
        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(fa, f"{name}_plain", counted)
    _port_step(flax_init, policy)
    layers = port_gpt.GPTConfig.tiny().num_layers
    assert sum(calls.values()) == want, (calls, want)
    forwards = 1 if policy == "none" else 2
    assert calls == {"fwd": forwards * layers, "bwd_dq": layers,
                     "bwd_dkv": layers}


def test_save_attn_keeps_the_attention_output():
    """Full remat saves each block's input; save_attn saves it and the
    block's ``attn_out`` (``[b, s, hidden]``, the compute dtype): one
    more saved tensor of that shape a block, and nothing else (counted
    by storage: both of a block's checkpoints save its input, the same
    tensor)."""
    x, _ = _tokens()
    kept = {}
    for policy in ("full", "save_attn"):
        model = port_gpt.GPT(port_gpt.GPTConfig.tiny(**POLICIES[policy]),
                             device="cpu")
        saved = {}

        def pack(t, saved=saved):
            saved[t.untyped_storage().data_ptr()] = (tuple(t.shape), t.dtype)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(torch.from_numpy(x))
        kept[policy] = sorted(saved.values(), key=str)
    layers, hidden = 2, 64
    residual = ((2, SEQ, hidden), torch.bfloat16)
    extra = list(kept["save_attn"])
    for item in kept["full"]:
        extra.remove(item)
    assert extra == [residual] * layers


def test_trainer_default_strategy_keeps_save_attn():
    """The ``checkpoint`` opt keeps a save_attn model's policy, so the
    Trainer's default strategy leaves the model as it is; a full-remat
    model's plan stays full, and ``offload_activation`` still replaces
    save_attn."""
    from dlrover_tpu_torch.accel import (
        ModelContext,
        OptimizationLibrary,
        Strategy,
    )
    from dlrover_tpu_torch.accel.accelerate import _apply_plan_to_model
    from dlrover_tpu_torch.trainer.trainer import Trainer

    def context(policy):
        model = port_gpt.GPT(port_gpt.GPTConfig.tiny(**POLICIES[policy]),
                             device="cpu")
        return ModelContext(model=model, optim_factory=None,
                            loss_fn=lambda m, b: 0.0, sample_batch={},
                            device="cpu")

    lib = OptimizationLibrary()
    ctx = context("save_attn")
    plan = lib.apply_strategy(Trainer.default_strategy(ctx.model), ctx)
    assert plan.remat and plan.remat_policy == "save_attn"
    assert _apply_plan_to_model(plan, ctx) is ctx.model
    plan = lib.apply_strategy(Strategy(opts=[("checkpoint", {})]),
                              context("full"))
    assert plan.remat and plan.remat_policy == "full"
    plan = lib.apply_strategy(
        Strategy(opts=[("offload_activation", {})]), ctx)
    assert plan.remat and plan.remat_policy == "offload"
