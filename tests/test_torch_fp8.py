"""The port's fp8 matmuls (``ops/fp8.py``) against the JAX package's.

The reference runs its fp8 path under ``jit`` (the model's step), where
XLA turns the scale's division by 448 into a product with the
reciprocal; the port copies that, so the JAX side here is jitted too:
the e4m3 codes (compared as bits) and the scales are equal, the
products within 1e-5 relative, the straight-through gradients of
``Fp8Dense`` equal to the reference's ``custom_vjp``, and a tiny GPT
with ``fp8=True`` equal to the JAX package's in logits and gradients
(fp32 compute).  The ``cuda``-marked test holds ``torch._scaled_mm`` on
the card against the plain version.
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import fp8 as port_fp8

SHAPES = [(37, 19, 1.0), (64, 48, 1e-3), (8, 16, 300.0), (1, 5, 1.0)]


def _jax_quant(x):
    import jax

    from dlrover_tpu.ops.fp8 import quantize_fp8

    return jax.jit(quantize_fp8)(x)


@pytest.mark.parametrize("rows,cols,scale", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_codes_and_scale_equal_the_reference(rows, cols, scale,
                                                      dtype):
    import jax.numpy as jnp
    import ml_dtypes

    x = (np.random.default_rng(rows).normal(size=(rows, cols))
         * scale).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    want_q, want_s = _jax_quant(jnp.asarray(x))
    got_q, got_s = port_fp8.quantize_fp8(xt)
    assert got_q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got_q.view(torch.uint8).numpy(),
                                  np.asarray(want_q).view(np.uint8))
    assert float(got_s) == float(want_s)


def test_zero_input_keeps_the_floor_scale():
    got_q, got_s = port_fp8.quantize_fp8(torch.zeros(4, 4))
    want_q, want_s = _jax_quant(np.zeros((4, 4), np.float32))
    assert float(got_s) == float(want_s)
    assert not got_q.view(torch.uint8).any()


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (33, 70, 17), (128, 64, 96)])
def test_fp8_dot_matches_the_reference(m, k, n):
    import jax

    from dlrover_tpu.ops.fp8 import fp8_dot

    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jax.jit(fp8_dot)(a, b))
    got = port_fp8.fp8_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_straight_through_gradients_equal_the_reference():
    """``Fp8Dense``: forward through the fp8 product, backward over the
    full-precision operands (the reference's ``_ste_bwd``)."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.ops.fp8 import Fp8Dense as JaxFp8Dense

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 24)).astype(np.float32)
    cot = rng.normal(size=(2, 6, 40)).astype(np.float32)
    layer = JaxFp8Dense(40, dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.normal(size=(40,)).astype(np.float32))}

    def f(p, xin):
        return (layer.apply({"params": p}, xin) * cot).sum()

    out = jax.jit(lambda p, xin: layer.apply({"params": p}, xin))(
        params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))

    dense = port_fp8.Fp8Dense(24, 40)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(np.asarray(params["kernel"])))
        dense.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    got = dense(xt, torch.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(dense.weight.grad.numpy(),
                               np.asarray(gp["kernel"]), **tol)
    np.testing.assert_allclose(dense.bias.grad.numpy(),
                               np.asarray(gp["bias"]), **tol)


def test_fp8_gpt_matches_the_reference():
    """A tiny GPT with ``fp8=True`` (fp32 compute): logits and every
    gradient against the JAX package's, the weights carried across."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu_torch.models import gpt as port_gpt
    from dlrover_tpu_torch.utils.convert import flax_path, params_from_jax

    jm = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(fp8=True, dtype=jnp.float32,
                                            max_seq_len=32))
    params = jm.init_params(jax.random.PRNGKey(0))
    tok = np.random.default_rng(3).integers(0, 256, (2, 33)).astype(np.int32)
    x, y = tok[:, :-1], tok[:, 1:]

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jax_gpt.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (want_loss, want_logits), want_g = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    pm = port_gpt.GPT(port_gpt.GPTConfig.tiny(fp8=True, dtype=torch.float32,
                                              max_seq_len=32), device="cpu")
    pm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    assert isinstance(pm.blocks[0].mlp.fc_in, port_fp8.Fp8Dense)
    logits = pm(torch.from_numpy(x))
    got_loss = port_gpt.cross_entropy_loss(logits, torch.from_numpy(y))
    got_loss.backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **tol)
    flat = {"/".join(jax.tree_util.keystr((k,), simple=True, separator="/")
                     for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(want_g)}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(flat["/".join(flax_path(name))]),
                                   err_msg=name, **tol)


def test_fp8_opt_and_model_path():
    """Twin of ``tests/test_accelerate.py::test_fp8_opt_and_model_path``:
    the ``fp8`` knob rebuilds the model with ``Fp8Dense`` MLPs and the
    step trains to a finite loss."""
    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss

    a = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_fp8.fp8_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        a @ b, rtol=0.15, atol=0.15)

    data = np.random.default_rng(0).integers(0, 256, (4, 17), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    model = GPT(GPTConfig.tiny(), device="cpu")
    result = auto_accelerate(
        model, lambda ps: torch.optim.SGD(ps, lr=1e-2),
        lambda m, bt: cross_entropy_loss(m(bt["x"]), bt["y"]), batch,
        strategy=Strategy(opts=[("parallel_mode", {}), ("fp8", {}),
                                ("amp_native", {})]), device="cpu")
    assert result.model.config.fp8 is True
    assert isinstance(result.model.blocks[0].mlp.fc_out, port_fp8.Fp8Dense)
    _, metrics = result.train_step(result.state, result.place_batch(batch))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
@pytest.mark.parametrize("m,k,n", [(64, 48, 40), (256, 1600, 6400),
                                   (33, 70, 17)])
def test_scaled_mm_matches_the_plain_version(m, k, n):
    """``torch._scaled_mm`` (K and N padded to 16 where needed) against
    the plain version on the same codes: the same products of exact
    e4m3 values, summed in another order and, between the tensor cores'
    promotions to fp32, at about 14 bits (``chip_smoke.FP8_REL_NORM``:
    2^-10 by the relative norm, 1.3e-4 read at XL's MLP shapes)."""
    gen = torch.Generator("cuda").manual_seed(m)
    a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    b = torch.randn(k, n, device="cuda", generator=gen)
    aq, sa = port_fp8.quantize_fp8(a)
    bq, sb = port_fp8.quantize_fp8(b)
    got = port_fp8.scaled_mm(aq, bq, sa, sb)
    want = (aq.float() @ bq.float()) * (sa * sb)
    rel = float((got - want).norm() / want.norm())
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert rel <= 2.0 ** -10, rel


def test_fp8_degrades_to_bf16_without_fp8_units(monkeypatch):
    """The reference's degrade: a card without fp8 tensor cores builds
    the bf16 model and notes it in the plan (on the CPU and a card of
    compute capability 8.9 and up the fp8 path is taken)."""
    from dlrover_tpu_torch.accel import Strategy, accelerate, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss

    assert accelerate._hardware_supports_fp8("cpu")
    monkeypatch.setattr(accelerate, "_hardware_supports_fp8",
                        lambda device: False)
    data = np.random.default_rng(0).integers(0, 256, (4, 17), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    result = auto_accelerate(
        GPT(GPTConfig.tiny(), device="cpu"),
        lambda ps: torch.optim.SGD(ps, lr=1e-2),
        lambda m, bt: cross_entropy_loss(m(bt["x"]), bt["y"]), batch,
        strategy=Strategy(opts=[("fp8", {})]), device="cpu")
    assert result.model.config.fp8 is False
    assert "fp8 degraded to bf16 (no hw fp8 units)" in result.plan.notes
