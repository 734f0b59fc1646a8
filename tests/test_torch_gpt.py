"""GPT of the PyTorch port against the JAX package's flax GPT.

Both models start from one flax init of ``GPTConfig.tiny``, carried
into the port by ``params_from_jax``; the same numpy tokens go to
both.  fp32: logits within 1e-4, loss within 1e-5 relative, every
parameter gradient within atol 1e-4 / rtol 1e-3 (sums run in another
order); bf16: logits within 3e-2 (the frameworks round at other
places).  The converter's round trip is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.utils.convert import params_from_jax, params_to_jax

SEQ = 32


def _tokens(seed=1, batch=2, vocab=256):
    data = np.random.default_rng(seed).integers(
        0, vocab, (batch, SEQ + 1), dtype=np.int32
    )
    return data[:, :-1], data[:, 1:]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def flax_init():
    return flax_params()


def flax_params():
    """One flax init per head layout, as numpy."""
    out = {}
    for tie in (True, False):
        model = jax_gpt.GPT(
            jax_gpt.GPTConfig.tiny(dtype=jnp.float32, tie_embeddings=tie)
        )
        init = jax.jit(lambda key, m=model: m.init(
            key, jnp.zeros((2, SEQ), jnp.int32))["params"])
        out[tie] = _np_tree(init(jax.random.PRNGKey(0)))
    return out


def _pair(impl, dtype, params, tie=True):
    jcfg = jax_gpt.GPTConfig.tiny(
        attention_impl=impl, tie_embeddings=tie,
        dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype],
    )
    pcfg = port_gpt.GPTConfig.tiny(
        attention_impl=impl, tie_embeddings=tie, dtype=getattr(torch, dtype),
    )
    model = port_gpt.GPT(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jax_gpt.GPT(jcfg), model


def fp32_pairs(impl, params):
    """(port, JAX) fp32 logits, loss and ``{name: grad}`` on the same
    params and tokens."""
    jmodel, model = _pair(impl, "float32", params)
    x, y = _tokens()

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jax_gpt.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (jl, jlogits), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True)
    )(jax.tree.map(jnp.asarray, params))
    logits = model(torch.from_numpy(x))
    loss = port_gpt.cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    grads = dict(_flat(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}
    )))
    return ((logits.detach().numpy(), np.asarray(jlogits)),
            (loss.item(), float(jl)),
            (grads, dict(_flat(_np_tree(jgrads)))))


def bf16_logits_pair(impl, params):
    jmodel, model = _pair(impl, "bfloat16", params)
    x, _ = _tokens()
    # op by op, as the port runs: under jit XLA keeps some bf16
    # intermediates of a fusion in fp32
    jlogits = jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)
    )
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    return logits.detach().numpy(), np.asarray(jlogits)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_loss_and_grads_match_jax(impl, flax_init):
    logits, loss, (grads, want) = fp32_pairs(impl, flax_init[True])
    np.testing.assert_allclose(*logits, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(*loss, rtol=1e-5)
    assert grads.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(
            grads[name], g, atol=1e-4, rtol=1e-3, err_msg=name
        )


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_logits_close_to_jax(impl, flax_init):
    np.testing.assert_allclose(
        *bf16_logits_pair(impl, flax_init[True]), atol=3e-2, rtol=3e-2
    )


def test_untied_head_matches_jax(flax_init):
    params = flax_init[False]
    assert "lm_head" in params
    jmodel, model = _pair("xla", "float32", params, tie=False)
    x, _ = _tokens()
    jlogits = jax.jit(jmodel.apply)(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)
    )
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(), np.asarray(jlogits),
        atol=1e-4, rtol=1e-4,
    )


@pytest.mark.parametrize("tie", [True, False])
def test_params_round_trip_is_bit_exact(tie, flax_init):
    params = flax_init[tie]
    sd = params_from_jax(params)
    back = dict(_flat(params_to_jax(sd)))
    want = dict(_flat(params))
    assert back.keys() == want.keys()
    for name, value in want.items():
        assert back[name].dtype == value.dtype, name
        assert back[name].shape == value.shape, name
        assert np.array_equal(back[name], value), name
    # and the other way: the port's own state dict survives the trip
    model = port_gpt.GPT(
        port_gpt.GPTConfig.tiny(tie_embeddings=tie), device="cpu", seed=5
    )
    sd2 = params_from_jax(params_to_jax(model.state_dict()))
    for name, value in model.state_dict().items():
        assert torch.equal(sd2[name], value), name


def test_converter_transposes_dense_kernels(flax_init):
    """Dense weights keep flax's ``[in, out]`` kernel layout in the
    port, so the converter carries them over untransposed (and
    blockwise optimizer state over them code for code)."""
    params = flax_init[True]
    sd = params_from_jax(params)
    kernel = params["block_0"]["attn"]["qkv"]["kernel"]
    assert kernel.shape == (64, 192)
    np.testing.assert_array_equal(
        sd["blocks.0.attn.qkv.weight"].numpy(), kernel
    )
    np.testing.assert_array_equal(
        sd["blocks.0.ln_attn.weight"].numpy(),
        params["block_0"]["ln_attn"]["scale"],
    )
    np.testing.assert_array_equal(
        sd["wte.weight"].numpy(), params["wte"]["embedding"]
    )


def test_bf16_param_dtype_keeps_layernorms_fp32():
    """The reference's rule: Dense and Embed weights take
    ``param_dtype``; flax's ``nn.LayerNorm`` takes none, so layernorm
    params stay fp32 — and the flax init carries over bit for bit."""
    jcfg = jax_gpt.GPTConfig.tiny(param_dtype=jnp.bfloat16)
    params = _np_tree(jax.jit(lambda key: jax_gpt.GPT(jcfg).init(
        key, jnp.zeros((2, SEQ), jnp.int32))["params"])(jax.random.PRNGKey(0)))
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(param_dtype=torch.bfloat16),
                         device="cpu")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert {n for n, d in dtypes.items() if d == torch.float32} == {
        n for n in dtypes if ".ln_" in n or n.startswith("ln_f")}
    for name, value in _flat(params):
        want = torch.float32 if value.dtype == np.float32 else torch.bfloat16
        assert value.dtype in (np.float32, jnp.bfloat16), name
        assert dtypes[_port_name(name)] == want, name
    model.load_state_dict(params_from_jax(params))
    back = dict(_flat(params_to_jax(model.state_dict())))
    for name, value in _flat(params):
        assert back[name].dtype == value.dtype, name
        assert np.array_equal(back[name].view(np.uint8),
                              value.view(np.uint8)), name


def _port_name(flax_name: str) -> str:
    parts = flax_name.split("/")
    leaf = "bias" if parts[-1] == "bias" else "weight"
    mod = []
    for p in parts[:-1]:
        mod += ["blocks", p[6:]] if p.startswith("block_") else [p]
    return ".".join(mod + [leaf])


def test_gpt2_xl_config_matches_reference():
    cfg = port_gpt.GPTConfig.gpt2_xl(param_dtype=torch.bfloat16)
    ref = jax_gpt.GPTConfig.gpt2_xl()
    assert (cfg.num_layers, cfg.num_heads, cfg.hidden_dim, cfg.head_dim,
            cfg.max_seq_len, cfg.vocab_size) == (
        ref.num_layers, ref.num_heads, ref.hidden_dim, ref.head_dim,
        ref.max_seq_len, ref.vocab_size) == (48, 25, 1600, 64, 1024, 50304)


def test_count_params_matches_jax(flax_init):
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(), device="cpu")
    assert port_gpt.count_params(model) == jax_gpt.count_params(
        flax_init[True]
    )


@pytest.mark.parametrize("kw", [
    dict(decode=True),
    dict(head="value"),
    dict(moe_experts=4),
    dict(fp8=True),
    dict(remat=True, remat_policy="offload"),
    dict(remat=True, remat_policy="save_attn"),
    dict(attention_impl="ring"),
])
def test_later_slices_raise_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        port_gpt.GPT(port_gpt.GPTConfig.tiny(**kw), device="cpu")


def test_config_validation_matches_reference():
    with pytest.raises(ValueError, match="requires"):
        port_gpt.GPTConfig.tiny(remat_policy="offload")
    with pytest.raises(ValueError, match="unknown"):
        port_gpt.GPTConfig.tiny(remat=True, remat_policy="bogus")
    cfg = port_gpt.GPTConfig.gpt2_small()
    ref = jax_gpt.GPTConfig.gpt2_small()
    assert (cfg.num_layers, cfg.num_heads, cfg.hidden_dim, cfg.head_dim,
            cfg.vocab_size) == (ref.num_layers, ref.num_heads,
                                ref.hidden_dim, ref.head_dim, ref.vocab_size)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gives_the_same_gradients(impl):
    x, y = _tokens()
    grads = []
    for remat in (False, True):
        cfg = port_gpt.GPTConfig.tiny(attention_impl=impl, remat=remat,
                                      dtype=torch.float32)
        model = port_gpt.GPT(cfg, device="cpu", seed=2)
        port_gpt.cross_entropy_loss(
            model(torch.from_numpy(x)), torch.from_numpy(y)
        ).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-5)


def test_init_is_seeded_and_follows_flax_scales():
    cfg = port_gpt.GPTConfig.tiny()
    a = port_gpt.GPT(cfg, device="cpu", seed=0).state_dict()
    b = port_gpt.GPT(cfg, device="cpu", seed=0).state_dict()
    c = port_gpt.GPT(cfg, device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    # lecun-normal Dense kernels: std 1/sqrt(fan_in); zero biases
    std = a["blocks.0.mlp.fc_out.weight"].std().item()
    assert abs(std - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert not a["blocks.0.attn.qkv.bias"].any()
    assert torch.equal(a["ln_f.weight"], torch.ones(64))


def test_gpt_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_gpt.GPT(port_gpt.GPTConfig.tiny())


def parity_report():
    """Max-abs errors of the port's GPT against the JAX package on the
    cases above."""
    params = flax_params()[True]
    for impl in ("xla", "flash"):
        logits, loss, (grads, want) = fp32_pairs(impl, params)
        grad_err = max(np.abs(grads[n] - w).max() for n, w in want.items())
        print(f"{impl} fp32: logits max_abs_err "
              f"{np.abs(logits[0] - logits[1]).max():.3e}, loss rel_err "
              f"{abs(loss[0] - loss[1]) / abs(loss[1]):.3e}, grads "
              f"max_abs_err {grad_err:.3e}")
        got, ref = bf16_logits_pair(impl, params)
        print(f"{impl} bf16: logits max_abs_err {np.abs(got - ref).max():.3e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gpt.py
    parity_report()
