"""The Llama family of the PyTorch port against the JAX package's flax Llama.

Twins of ``tests/test_llama.py`` (forward shapes with GQA, RoPE's
properties, the TP rules, flash against xla; the mesh run is in
``test_torch_llama_dist.py``) and of ``tests/test_llama7b_lowering.py``
(the real ``llama2_7b`` config counted under the FSDP plan on the
``meta`` device), and parity with the JAX package: both models start
from one flax init of ``LlamaConfig.tiny`` (GQA group 2), carried into
the port by ``params_from_jax``, and take the same numpy tokens.  fp32:
logits within 1e-4, loss within 1e-5 relative, every parameter
gradient within atol 1e-4 / rtol 1e-3 (sums run in another order), for
``xla`` and ``flash`` (the JAX flash kernels in Pallas interpret mode,
the port's plain version on the CPU); bf16: logits within 3e-2 (the
frameworks round at other places).  The converter's round trip is
bit-exact, bf16 leaves and fp32 norm scales included.  Also: RoPE and
RMSNorm against the reference's functions, remat's gradients, the
deferred options, the init's scales, the count tier at GQA and the
rebuild of a Llama by a plan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.models import llama as port_llama
from dlrover_tpu_torch.utils.convert import (
    flax_path,
    params_from_jax,
    params_to_jax,
)

SEQ = 32
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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


def flax_params(param_dtype="float32", **kw):
    cfg = jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, param_dtype=JAX_DTYPES[param_dtype], **kw)
    model = jax_llama.Llama(cfg)
    init = jax.jit(lambda key: model.init(
        key, jnp.zeros((2, SEQ), jnp.int32))["params"])
    return _np_tree(init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def flax_init():
    return flax_params()


def _pair(impl, dtype, params, **kw):
    jcfg = jax_llama.LlamaConfig.tiny(attention_impl=impl,
                                      dtype=JAX_DTYPES[dtype], **kw)
    pcfg = port_llama.LlamaConfig.tiny(attention_impl=impl,
                                       dtype=getattr(torch, dtype), **kw)
    model = port_llama.Llama(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jax_llama.Llama(jcfg), model


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
    # op by op, as the port runs
    jlogits = jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)
    )
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    return logits.detach().numpy(), np.asarray(jlogits)


# -- twins of tests/test_llama.py ----------------------------------------------


def test_llama_forward_shapes():
    cfg = port_llama.LlamaConfig.tiny()
    model = port_llama.Llama(cfg, device="cpu")
    logits = model(torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32
    # GQA: kv projections smaller than q
    kp = model.blocks[0].attn.k_proj.weight
    qp = model.blocks[0].attn.q_proj.weight
    assert kp.shape[1] == qp.shape[1] // 2  # num_kv_heads = heads/2
    hidden = model(torch.zeros((2, 16), dtype=torch.long),
                   return_hidden=True)
    assert hidden.shape == (2, 16, cfg.hidden_dim)
    assert hidden.dtype == cfg.dtype


def test_rope_preserves_norm_and_relative_phase():
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(1, 8, 2, 16)).astype(np.float32))
    out = port_llama.rope(x, torch.arange(8), 10000.0)
    np.testing.assert_allclose(
        np.linalg.norm(out.numpy(), axis=-1),
        np.linalg.norm(x.numpy(), axis=-1), rtol=1e-5)
    # position 0 is unrotated
    np.testing.assert_allclose(out[:, 0].numpy(), x[:, 0].numpy(), atol=1e-6)
    # the score of two rotated vectors depends on their distance only
    q = x[:, :1].expand(1, 8, 2, 16)
    rq = port_llama.rope(q, torch.arange(8), 10000.0)
    scores = (rq[0, 1:] * rq[0, :-1]).sum(-1)
    np.testing.assert_allclose(scores.numpy(), scores[:1].expand_as(
        scores).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax_split_halves(theta, dtype):
    """The split-halves rotation (not the interleaved pairs), angles in
    fp32, at positions up to Llama-3-8B's context."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 24, 2, 128)).astype(np.float32)
    pos = np.array(list(range(12)) + list(range(8180, 8192)), np.int32)
    jx = jnp.asarray(x).astype(JAX_DTYPES[dtype])
    want = np.asarray(jax_llama.rope(jx, jnp.asarray(pos), theta)
                      .astype(jnp.float32))
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    got = port_llama.rope(px, torch.from_numpy(pos), theta)
    assert got.dtype == px.dtype
    tol = 2e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    # the interleaved pairs (x[2i], x[2i+1]) rotate into another result
    freqs = 1.0 / theta ** (np.arange(0, 128, 2) / 128)
    ang = pos[:, None] * freqs[None]
    cos, sin = np.cos(ang)[None, :, None], np.sin(ang)[None, :, None]
    ev, od = x[..., 0::2], x[..., 1::2]
    inter = np.stack([ev * cos - od * sin, ev * sin + od * cos],
                     -1).reshape(x.shape)
    assert not np.allclose(inter, want, atol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax_with_an_fp32_scale(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    jx = jnp.asarray(x).astype(JAX_DTYPES[dtype])
    want = jax_llama.RMSNorm(1e-5).apply({"params": {"scale": scale}}, jx)
    norm = port_llama.RMSNorm(64, 1e-5, device="cpu")
    norm.load_state_dict({"weight": torch.from_numpy(scale)})
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype))).detach()
    assert norm.weight.dtype == torch.float32
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_llama_tp_rules_cover_params():
    from torch.distributed.tensor import Replicate, Shard

    from dlrover_tpu_torch.parallel.registry import rules_for_model
    from dlrover_tpu_torch.parallel.sharding import (
        gpt_tp_rules,
        param_placements,
    )

    model = port_llama.Llama(port_llama.LlamaConfig.tiny(), device="cpu")
    rules = rules_for_model(model)
    assert rules.rules == gpt_tp_rules().rules
    paths = {"/".join(flax_path(n)): n for n, _ in model.named_parameters()}
    # the JAX package's tree has the same paths
    assert set(paths) == set(dict(_flat(flax_params())))
    spec = {p: tuple(rules.spec_for(p)) for p in paths}
    for name in ("q_proj", "k_proj", "v_proj", "gate", "up"):
        assert spec[f"block_0/{'mlp' if name in ('gate', 'up') else 'attn'}"
                    f"/{name}/kernel"] == ("fsdp", "tensor")
    for name in ("attn/o_proj", "mlp/down"):
        assert spec[f"block_1/{name}/kernel"] == ("tensor", "fsdp")
    assert spec["block_0/ln_attn/scale"] == ()
    assert spec["ln_f/scale"] == ()
    assert spec["lm_head/kernel"] == ("fsdp", "tensor")
    # fsdp 2 x tensor 2: q holds heads/2, k and v kv_heads/2 (the GQA
    # group kept); the norms replicated
    # (placements over data, pipeline, fsdp, sequence, expert, tensor)
    shape = {"data": 1, "fsdp": 2, "tensor": 2}
    pl = param_placements(model, shape, rules)
    r = Replicate()
    assert pl["blocks.0.attn.q_proj.weight"] == (r, r, Shard(0), r, r,
                                                 Shard(1))
    assert pl["blocks.0.attn.k_proj.weight"] == (r, r, Shard(0), r, r,
                                                 Shard(1))
    assert pl["blocks.0.attn.o_proj.weight"] == (r, r, Shard(1), r, r,
                                                 Shard(0))
    assert pl["blocks.0.mlp.down.weight"] == (r, r, Shard(1), r, r,
                                              Shard(0))
    assert pl["blocks.0.ln_mlp.weight"] == (r,) * 6
    # a dim the tensor axis does not divide stays replicated over it:
    # k_proj of one kv head of 24 columns over 16 ranks
    odd = port_llama.Llama(port_llama.LlamaConfig.tiny(
        num_heads=2, num_kv_heads=1, hidden_dim=48), device="meta")
    pl = param_placements(odd, {"data": 1, "fsdp": 1, "tensor": 16}, rules)
    assert pl["blocks.0.attn.k_proj.weight"][-1] == Replicate()
    assert pl["blocks.0.attn.q_proj.weight"][-1] == Shard(1)  # 48 % 16 == 0
    pl = param_placements(odd, {"data": 1, "fsdp": 1, "tensor": 8}, rules)
    assert pl["blocks.0.attn.k_proj.weight"][-1] == Shard(1)  # 24 % 8 == 0


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_loss_and_grads_match_jax(impl, flax_init):
    logits, loss, (grads, want) = fp32_pairs(impl, flax_init)
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
        *bf16_logits_pair(impl, flax_init), atol=3e-2, rtol=3e-2
    )


def test_flash_attention_matches_xla():
    """Twin of ``test_llama_flash_attention_matches_xla``: the flash
    model (GQA straight into the kernels' plain version) against the
    plain attention model (k and v repeated), seq 128, fp32."""
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 128)))
    out = {}
    for impl in ("xla", "flash"):
        model = port_llama.Llama(port_llama.LlamaConfig.tiny(
            attention_impl=impl, dtype=torch.float32), device="cpu", seed=0)
        out[impl] = model(x)
    torch.testing.assert_close(out["flash"], out["xla"], atol=1e-5,
                               rtol=1e-5)


def test_gqa_reaches_the_flash_kernels_without_a_repeat(monkeypatch):
    """``"flash"`` hands the kernels k and v at the kv heads' width;
    ``"xla"`` repeats them first."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    seen = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, **kw)

    spy.gqa_aware = True
    monkeypatch.setattr(fa, "flash_attention", spy)
    model = port_llama.Llama(port_llama.LlamaConfig.tiny(
        attention_impl="flash", num_heads=8, num_kv_heads=2,
        dtype=torch.float32), device="cpu")
    model(torch.zeros((1, 16), dtype=torch.long))
    assert seen == [(8, 2, 2)] * 2


@pytest.mark.parametrize("tied_dtype", ["float32", "bfloat16"])
def test_params_round_trip_is_bit_exact(tied_dtype):
    """The flax tree -> the port's state dict -> the flax tree, bit for
    bit: bf16 Dense and Embed leaves under bf16 params, the norm scales
    fp32 whatever the param dtype (the reference declares them fp32)."""
    params = flax_params(tied_dtype)
    sd = params_from_jax(params)
    model = port_llama.Llama(port_llama.LlamaConfig.tiny(
        param_dtype=getattr(torch, tied_dtype)), device="cpu")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert {n for n, d in dtypes.items() if d == torch.float32} == (
        set(dtypes) if tied_dtype == "float32" else
        {n for n in dtypes if ".ln_" in n or n.startswith("ln_f")})
    model.load_state_dict(sd)
    back = dict(_flat(params_to_jax(model.state_dict())))
    want = dict(_flat(params))
    assert back.keys() == want.keys()
    for name, value in want.items():
        assert back[name].dtype == value.dtype, name
        assert back[name].shape == value.shape, name
        assert np.array_equal(back[name].view(np.uint8),
                              value.view(np.uint8)), name
    for name, value in model.state_dict().items():
        assert value.dtype == dtypes[name], name
    # and the port's own state dict survives the trip
    other = port_llama.Llama(port_llama.LlamaConfig.tiny(), device="cpu",
                             seed=5)
    sd2 = params_from_jax(params_to_jax(other.state_dict()))
    for name, value in other.state_dict().items():
        assert torch.equal(sd2[name], value), name


def test_converter_keeps_the_flax_layouts(flax_init):
    sd = params_from_jax(flax_init)
    np.testing.assert_array_equal(
        sd["blocks.0.attn.k_proj.weight"].numpy(),
        flax_init["block_0"]["attn"]["k_proj"]["kernel"])
    assert sd["blocks.0.attn.k_proj.weight"].shape == (64, 32)
    np.testing.assert_array_equal(
        sd["blocks.1.mlp.down.weight"].numpy(),
        flax_init["block_1"]["mlp"]["down"]["kernel"])
    np.testing.assert_array_equal(
        sd["ln_f.weight"].numpy(), flax_init["ln_f"]["scale"])
    np.testing.assert_array_equal(
        sd["lm_head.weight"].numpy(), flax_init["lm_head"]["kernel"])
    np.testing.assert_array_equal(
        sd["wte.weight"].numpy(), flax_init["wte"]["embedding"])


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gives_the_same_gradients(impl):
    x, y = _tokens()
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "offload")):
        cfg = port_llama.LlamaConfig.tiny(
            attention_impl=impl, remat=remat, remat_policy=policy,
            dtype=torch.float32)
        model = port_llama.Llama(cfg, device="cpu", seed=2)
        port_gpt.cross_entropy_loss(
            model(torch.from_numpy(x)), torch.from_numpy(y)
        ).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for other in grads[1:]:
        for name, g in grads[0].items():
            torch.testing.assert_close(other[name], g, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kw,slice_", [
    (dict(moe_experts=4), "slice 5.2"),
    (dict(decode=True), "slice 5.4"),
    (dict(attention_impl="ring"), "slice 5.2"),
    (dict(attention_impl="ulysses"), "slice 5.2"),
])
def test_later_slices_raise_not_implemented(kw, slice_):
    """Options of later slices raise naming their slice; those of slice
    5.2 build since it landed (tests/test_torch_moe.py and
    test_torch_sp_e2e.py drive them), and decode, which the reference
    names slice 5.4's, since slice 7 brought it (tests/test_torch_rl.py
    holds it against the JAX package's): every option of the
    reference's Llama builds now."""
    if slice_ in ("slice 5.2", "slice 5.4"):
        model = port_llama.Llama(port_llama.LlamaConfig.tiny(**kw),
                                 device="cpu")
        assert model.config == port_llama.LlamaConfig.tiny(**kw)
        return
    with pytest.raises(NotImplementedError, match=slice_):
        port_llama.Llama(port_llama.LlamaConfig.tiny(**kw), device="cpu")


def test_pipelined_llama_raises_naming_its_slice():
    """Slice 5.3 landed: the pipelined Llama builds (in process, every
    stage here) with the stage-stacked layout; tests/test_torch_pipeline.py
    holds it against the JAX package's."""
    model = port_llama.Llama(port_llama.LlamaConfig.tiny(), device="cpu")
    for pm in (model.to_pipelined(num_stages=2, num_microbatches=2),
               port_llama.PipelinedLlama(model, 2, 2)):
        assert isinstance(pm, port_llama.PipelinedLlama)
        q = dict(pm.named_parameters())["blocks.attn.q_proj.weight"]
        assert q.shape[:2] == (2, model.config.num_layers // 2)


@pytest.mark.parametrize("opts,slice_", [
    ([("sequence_parallel", {"size": 2})], "slice 5.2"),
    ([("expert_parallel", {"size": 2})], "slice 5.2"),
    ([("pipeline_parallel", {"size": 2, "microbatches": 2})], "slice 5.3"),
    ([("fp8", {})], "slice 5.4"),
])
def test_deferred_parallelism_raises_naming_its_slice(opts, slice_):
    """The optimizations of slices 5.2 and 5.3 apply since they landed:
    they size their mesh axis (or set fp8) as the reference's do.
    ``slice_`` keeps the slice each was once deferred to (fp8 was
    planned for 5.4 and came with 5.3)."""
    from dlrover_tpu_torch.accel import OptimizationLibrary, Strategy

    plan = OptimizationLibrary().apply_strategy(Strategy(opts=opts))
    name = opts[0][0]
    if name == "fp8":
        assert plan.fp8 is True
        return
    axis = name.split("_")[0]
    assert getattr(plan.mesh_config, axis) == 2


@pytest.mark.parametrize("axis,slice_", [
    ("sequence", "slice 5.2"), ("expert", "slice 5.2"),
    ("pipeline", "slice 5.3"),
])
def test_deferred_mesh_axes_raise_naming_their_slice(axis, slice_):
    """The sequence and expert axes build since slice 5.2 landed, the
    pipeline axis since slice 5.3: two ranks need a process group."""
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    with pytest.raises(ValueError, match="process group"):
        build_mesh(MeshConfig(**{"data": 1, axis: 2}), world_size=2)


def test_config_validation_and_presets_match_reference():
    with pytest.raises(ValueError, match="requires"):
        port_llama.LlamaConfig.tiny(remat_policy="offload")
    with pytest.raises(ValueError, match="unknown"):
        port_llama.LlamaConfig.tiny(remat=True, remat_policy="bogus")
    fields = [f.name for f in dataclasses.fields(jax_llama.LlamaConfig)]
    assert fields == [f.name for f in dataclasses.fields(
        port_llama.LlamaConfig)]
    for preset in ("tiny", "llama2_7b", "llama3_8b", "mixtral_8x7b"):
        got = getattr(port_llama.LlamaConfig, preset)()
        want = getattr(jax_llama.LlamaConfig, preset)()
        for name in fields:
            if name not in ("dtype", "param_dtype"):
                assert getattr(got, name) == getattr(want, name), (preset,
                                                                   name)
        assert got.head_dim == want.head_dim
    cfg = port_llama.LlamaConfig.llama3_8b()
    assert (cfg.num_layers, cfg.hidden_dim, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.intermediate_dim, cfg.vocab_size,
            cfg.max_seq_len, cfg.rope_theta) == (
        32, 4096, 32, 8, 128, 14336, 128256, 8192, 500000.0)


def test_count_params_matches_jax(flax_init):
    model = port_llama.Llama(port_llama.LlamaConfig.tiny(), device="cpu")
    assert port_gpt.count_params(model) == jax_gpt.count_params(flax_init)
    # Llama-3-8B on meta: 8,030,261,248 parameters in 291 tensors
    big = port_llama.Llama(port_llama.LlamaConfig.llama3_8b(), device="meta")
    assert port_gpt.count_params(big) == 8_030_261_248
    assert len(list(big.parameters())) == 291


def test_init_is_seeded_and_follows_flax_scales():
    """lecun-normal Dense kernels, flax ``nn.Embed``'s plain normal of
    std 1/sqrt(features), unit fp32 RMSNorm scales, on the device asked
    for.  GPT draws its embeddings as Llama does, as flax's
    ``nn.Embed`` (ROADMAP §C 5, closed)."""
    cfg = port_llama.LlamaConfig.tiny(vocab_size=4096, hidden_dim=256,
                                      intermediate_dim=512,
                                      param_dtype=torch.bfloat16)
    a = port_llama.Llama(cfg, device="cpu", seed=0).state_dict()
    b = port_llama.Llama(cfg, device="cpu", seed=0).state_dict()
    c = port_llama.Llama(cfg, device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    std = a["blocks.0.mlp.down.weight"].float().std().item()
    assert abs(std - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert a["blocks.0.mlp.down.weight"].float().abs().max() <= \
        2 * 512 ** -0.5 / 0.87962566103423978 * 1.01
    emb = a["wte.weight"].float()
    assert abs(emb.std().item() - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert emb.abs().max().item() > 3 * 256 ** -0.5  # not truncated
    assert a["ln_f.weight"].dtype == torch.float32
    assert torch.equal(a["blocks.1.ln_attn.weight"], torch.ones(256))
    gpt = port_gpt.GPT(port_gpt.GPTConfig.tiny(vocab_size=4096,
                                               hidden_dim=256),
                       device="cpu").state_dict()
    wte = gpt["wte.weight"]
    assert abs(wte.std().item() - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert wte.abs().max().item() > 3 * 256 ** -0.5  # not truncated


def test_llama_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_llama.Llama(port_llama.LlamaConfig.tiny())


# -- auto_accelerate and the count tier on a Llama ---------------------------


def _context(model, batch, loss_fn=None, **kw):
    from dlrover_tpu_torch.accel import ModelContext

    def full_loss(module, b):
        return port_gpt.cross_entropy_loss(module(b["x"]), b["y"])

    return ModelContext(model=model, optim_factory=None,
                        loss_fn=loss_fn or full_loss, sample_batch=batch,
                        device=torch.device("cpu"), **kw)


def test_a_plan_rebuilds_a_llama_with_its_knobs():
    """``half`` + ``checkpoint`` + ``module_replace``: the model rebuilt
    with bf16 params (the RMSNorm scales kept fp32), remat and flash,
    its weights copied (cast)."""
    from dlrover_tpu_torch.accel import OptimizationLibrary, Strategy
    from dlrover_tpu_torch.accel.accelerate import _apply_plan_to_model

    model = port_llama.Llama(port_llama.LlamaConfig.tiny(), device="cpu")
    x, y = _tokens()
    context = _context(model, {"x": x, "y": y})
    plan = OptimizationLibrary().apply_strategy(Strategy(opts=[
        ("half", {}), ("checkpoint", {}),
        ("module_replace", {"attention": "flash"})]), context)
    new = _apply_plan_to_model(plan, context)
    cfg = new.config
    assert isinstance(new, port_llama.Llama) and new is not model
    assert (cfg.remat, cfg.attention_impl, cfg.dtype, cfg.param_dtype) == (
        True, "flash", torch.bfloat16, torch.bfloat16)
    for (name, p), q in zip(new.named_parameters(), model.parameters()):
        if ".ln_" in name or name.startswith("ln_f"):
            assert p.dtype == torch.float32 and torch.equal(p, q), name
        else:
            assert p.dtype == torch.bfloat16, name
            assert torch.equal(p, q.to(torch.bfloat16)), name
    assert new(torch.from_numpy(x)).shape == (2, SEQ, cfg.vocab_size)


def test_count_tier_counts_gqa_attention_at_the_kv_heads_size():
    """The count tier's stand-in for the flash kernels takes k and v at
    their own (kv-head) size at group 4: its gradients are k's shape and
    its bytes count q, o, dO, dQ at q's size and k, v, dK, dV at k's."""
    from dlrover_tpu_torch.accel import dry_runner

    b, s, h, kvh, d = 2, 64, 8, 2, 16
    q = torch.empty(b, s, h, d, device="meta", requires_grad=True)
    k = torch.empty(b, s, kvh, d, device="meta", requires_grad=True)
    v = torch.empty(b, s, kvh, d, device="meta", requires_grad=True)
    counter = dry_runner._Count()
    dry_runner._ACTIVE["count"] = counter
    try:
        out = dry_runner._attention_cost(q, k, v)
        fwd_bytes = counter.bytes
        out.backward(torch.empty_like(out))
    finally:
        dry_runner._ACTIVE.pop("count")
    qb, kvb, rows = b * s * h * d * 4, b * s * kvh * d * 4, b * h * s * 4
    assert fwd_bytes == 2 * qb + 2 * kvb + rows
    assert counter.bytes - fwd_bytes == 4 * qb + 4 * kvb + 2 * rows
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    assert q.grad.shape == q.shape
    assert counter.flops == 3.5 * 4 * b * h * s * s * d * 0.5


def test_count_tier_counts_a_gqa_llama_with_flash():
    from dlrover_tpu_torch.accel import OptimizationLibrary, Strategy
    from dlrover_tpu_torch.accel.dry_runner import count_step

    model = port_llama.Llama(port_llama.LlamaConfig.tiny(
        num_heads=8, num_kv_heads=2, hidden_dim=128), device="cpu")
    x, y = _tokens()
    context = _context(model, {"x": x, "y": y})
    costs = {}
    for impl in ("xla", "flash"):
        plan = OptimizationLibrary().apply_strategy(Strategy(opts=[
            ("module_replace", {"attention": impl})]), context)
        costs[impl] = count_step(plan, context)
    # the formula's causal attention against the plain math's full
    # square: fewer FLOPs; the weights the same
    assert 0 < costs["flash"]["flops"] < costs["xla"]["flops"]
    assert costs["flash"]["state_bytes"] == costs["xla"]["state_bytes"]


def test_llama2_7b_fsdp_step_counts_on_meta():
    """Twin of ``tests/test_llama7b_lowering.py``: the real
    ``llama2_7b`` config (seq 2048, remat) under the FSDP plan, counted
    on the ``meta`` device (no memory): more than 6.5e9 params, the q
    projection sharded on dim 0 over fsdp at fsdp 8, and the per-device
    share of the fp32 params and AdamW moments within an H100's 80 GB."""
    from torch.distributed.tensor import Shard

    from dlrover_tpu_torch.accel import OptimizationLibrary, Strategy
    from dlrover_tpu_torch.accel.dry_runner import count_step
    from dlrover_tpu_torch.parallel.sharding import (
        fsdp_rules,
        param_placements,
    )

    cfg = port_llama.LlamaConfig.llama2_7b(max_seq_len=2048, remat=True)
    model = port_llama.Llama(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params > 6.5e9  # the real 7B, not a toy
    batch = {"x": np.zeros((8, 2048), np.int32),
             "y": np.zeros((8, 2048), np.int32)}
    context = _context(model, batch)
    plan = OptimizationLibrary().apply_strategy(
        Strategy(opts=[("fsdp", {}), ("checkpoint", {})]), context)
    assert plan.param_rules.rules == fsdp_rules().rules
    pl = param_placements(model, {"data": 1, "fsdp": 8, "tensor": 1},
                          plan.param_rules)
    assert pl["blocks.0.attn.q_proj.weight"][2] == Shard(0)  # fsdp
    assert model.blocks[0].attn.q_proj.weight.shape[0] % 8 == 0
    cost = count_step(plan, context)
    # 6 FLOPs a weight a token at least, plus the remat recompute
    tokens = 8 * 2048
    assert cost["flops"] > 6 * tokens * (n_params - cfg.vocab_size * 4096)
    assert cost["state_bytes"] == 4 * n_params * 4  # params, grads, mu, nu
    assert 3 * n_params * 4 / 8 < 80e9


def test_memory_model_prunes_fp32_adamw_for_llama3_8b_on_one_h100():
    """Llama-3-8B (8.03e9 params) on one 80 GB card: the fp32 and the
    bf16 AdamW plans (~128 and ~96 GB of state) are pruned; with the
    int8-optimizer opt-in the half + int8 plans remain."""
    from dlrover_tpu_torch.accel import analyser, strategy_search

    model = port_llama.Llama(port_llama.LlamaConfig.llama3_8b(),
                             device="meta")
    batch = {"x": np.zeros((1, 8192), np.int32),
             "y": np.zeros((1, 8192), np.int32)}
    context = _context(model, batch, extra={"search_optimizer": True})
    analysis = analyser.analyse(context)
    analysis.per_device_hbm = 80 * 10 ** 9
    assert analysis.num_params == 8_030_261_248
    for half, low_bit, fits in ((False, False, False), (True, False, False),
                                (False, True, False), (True, True, True)):
        for remat in (False, True):
            assert analyser.fits_in_hbm(
                analysis, 1, 1, remat, half=half,
                low_bit_opt=low_bit) is fits, (half, low_bit, remat)
    cands = strategy_search.generate_candidates(context, 1,
                                                analysis=analysis)
    assert cands and all(c.half and c.low_bit_opt for c in cands)
    assert {c.remat for c in cands} == {False, True}


def test_mixtral_moe_llama_forward_and_params():
    """Twin of the reference's Mixtral-class Llama test: gated (SwiGLU)
    experts replace the MLP of every block (``moe_every`` 1), the expert
    kernels carry the leading expert dim the expert rules place, and
    from the JAX package's init the port's fp32 logits (atol 1e-4, as
    the dense Llama's) and aux loss (rtol 1e-5) are the reference's."""
    from dlrover_tpu.parallel.moe import collect_moe_aux_loss as jax_aux
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss
    from dlrover_tpu_torch.parallel.sharding import moe_rules

    kw = dict(moe_experts=4, moe_top_k=2)
    jax_model = jax_llama.Llama(jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, **kw))
    params = _np_tree(jax_model.init_params(jax.random.PRNGKey(0),
                                            seq_len=16))
    model = port_llama.Llama(port_llama.LlamaConfig.tiny(
        dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    paths = ["/".join(flax_path(n)) for n, _ in model.named_parameters()]
    assert set(paths) == {p for p, _ in _flat(params)}
    gate_paths = [p for p in paths if "experts_w_gate" in p]
    assert gate_paths, sorted(paths)[:12]
    assert tuple(moe_rules().spec_for(gate_paths[0])) == (
        "expert", "fsdp", "tensor")
    assert not any("/mlp/" in p for p in paths)
    x, _ = _tokens()
    logits = model(torch.from_numpy(x))
    aux = collect_moe_aux_loss(model)
    assert logits.shape == (2, SEQ, 256) and float(aux.detach()) > 0.0
    ref, st = jax.jit(lambda p, x: jax_model.apply(
        {"params": p}, x, mutable=["intermediates"]))(params, x)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    np.testing.assert_allclose(float(aux.detach()),
                               float(jax_aux(st["intermediates"])), rtol=1e-5)


MIXTRAL_STEPS = 4
# the expert-mesh twin's plans: expert 2 with data 2, and with tensor 2
MIXTRAL_PLANS = {"expert2_data2": {"expert": 2, "data": -1},
                 "expert2_tensor2": {"expert": 2, "tensor": 2, "data": -1}}


def _mixtral_worker(rank, world, port, in_path, out_path):
    """One gloo rank of the expert-mesh twins: ``auto_accelerate`` with
    each of ``MIXTRAL_PLANS`` over four ranks."""
    import pickle

    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)

    def loss_fn(module, batch):
        ce = port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])
        return ce + 0.01 * collect_moe_aux_loss(module)

    out = {}
    for label, mesh in MIXTRAL_PLANS.items():
        model = port_llama.Llama(port_llama.LlamaConfig.tiny(
            moe_experts=2, moe_every=2), device="cpu")
        model.load_state_dict(params_from_jax(job["params"]))
        res = auto_accelerate(
            model, lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                                weight_decay=1e-4),
            loss_fn, job["batch"], strategy=Strategy(opts=[
                ("mixed_parallel", mesh),
                ("amp_native", {"dtype": "float32"})]), device="cpu")
        state, losses = res.state, []
        placed = res.place_batch(job["batch"])
        for _ in range(MIXTRAL_STEPS):
            state, metrics = res.train_step(state, placed)
            losses.append(float(metrics["loss"]))
        # the experts are DTensors: each rank's local box
        experts = [(tuple(p.to_local().shape), str(p.placements))
                   for n, p in res.model.named_parameters()
                   if "experts_w" in n]
        out[label] = {"losses": losses, "experts": experts,
                      "mesh": dict(res.mesh.shape)}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def mixtral_runs():
    """The expert-mesh twins: the port's runs of every plan (one gloo
    spawn of world 4) and the JAX package's on ``jax.devices()[:4]``."""
    import optax
    from torch_gloo import spawn

    from dlrover_tpu.accel import Strategy, auto_accelerate
    from dlrover_tpu.parallel.moe import collect_moe_aux_loss as jax_aux

    cfg = jax_llama.LlamaConfig.tiny(moe_experts=2, moe_every=2,
                                     dtype=jnp.float32)
    model = jax_llama.Llama(cfg)
    params = _np_tree(model.init_params(jax.random.PRNGKey(0)))
    data = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 17),
                                             dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    got = spawn({"params": params, "batch": batch},
                os.path.abspath(__file__))

    def loss_fn(p, batch, model=model):
        logits, st = model.apply({"params": p}, batch["x"],
                                 mutable=["intermediates"])
        return jax_gpt.cross_entropy_loss(logits, batch["y"]) + \
            0.01 * jax_aux(st["intermediates"])

    jbatch = jax.tree.map(jnp.asarray, batch)
    want = {}
    for label, mesh in MIXTRAL_PLANS.items():
        res = auto_accelerate(
            model, lambda: optax.adamw(1e-3), loss_fn, jbatch,
            strategy=Strategy(opts=[
                ("mixed_parallel", mesh),
                ("amp_native", {"dtype": "float32"})]),
            devices=jax.devices()[:4])
        state, losses = res.state, []
        placed = res.place_batch(jbatch)
        for _ in range(MIXTRAL_STEPS):
            state, m = res.train_step(state, placed)
            losses.append(float(m["loss"]))
        want[label] = losses
    return got, want


def test_mixtral_trains_via_auto_accelerate_on_expert_mesh(mixtral_runs):
    """Twin of the reference's expert-mesh test on gloo (world 4:
    expert 2 x data 2), both packages in fp32 from the JAX package's
    init with AdamW (1e-3, optax's weight decay 1e-4), ``moe_every`` 2:
    each rank holds one of the two experts of each MoE block, and every
    step's loss is the JAX package's on ``jax.devices()[:4]`` at rtol
    1e-4 and falls."""
    got, want = mixtral_runs
    got = got["expert2_data2"]
    assert got["mesh"]["expert"] == 2 and got["mesh"]["data"] == 2
    # one of the two experts a rank, in block 1 (moe_every 2)
    assert [shape for shape, _ in got["experts"]] == [
        (1, 64, 128), (1, 64, 128), (1, 128, 64)]
    np.testing.assert_allclose(got["losses"], want["expert2_data2"],
                               rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0], got["losses"]


def test_mixtral_at_expert_2_tensor_2_matches_the_jax_package(mixtral_runs):
    """Expert 2 x tensor 2 (the reference's ``moe_rules`` place the
    experts on ``("expert", "fsdp", "tensor")``): each rank holds one
    expert, its last dim split over the tensor axis, and every step's
    loss is the JAX package's on the same plan at rtol 1e-4 and falls."""
    got, want = mixtral_runs
    got = got["expert2_tensor2"]
    assert got["mesh"]["expert"] == 2 and got["mesh"]["tensor"] == 2
    # (FSDP2 over its one-rank fsdp axis adds a placement in front)
    assert [shape for shape, _ in got["experts"]] == [
        (1, 64, 64), (1, 64, 64), (1, 128, 32)]
    assert all(pl.endswith("Shard(dim=0), Shard(dim=2))")
               for _, pl in got["experts"]), got["experts"]
    np.testing.assert_allclose(got["losses"], want["expert2_tensor2"],
                               rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0], got["losses"]


def parity_report():
    """Max-abs errors of the port's Llama against the JAX package."""
    params = flax_params()
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
    import sys

    if sys.argv[1:2] == ["--worker"]:
        _mixtral_worker(*(int(a) for a in sys.argv[2:5]), *sys.argv[5:7])
    else:
        # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_llama.py
        parity_report()
