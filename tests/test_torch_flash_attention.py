"""Flash attention of the PyTorch port against the JAX package.

Every case of ``tests/test_flash_attention.py``, with the JAX
``flash_attention`` (Pallas, interpret mode on the CPU) as the oracle:
the same numpy inputs go to both, and on the CPU the port runs its
plain version of the kernels.  Tolerances are the JAX suite's own:
fp32 forward 2e-5, fp32 gradients atol 5e-5 / rtol 5e-4, bf16 3e-2.
The CUDA kernels themselves are held against the plain version on the
card (``cuda`` marker; ``chip_smoke.py`` does the same at the training
shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jax_fa
from dlrover_tpu_torch.ops import flash_attention as fa


def _qkv(b=2, s=128, h=4, d=32, kvh=None, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    return (
        (rng.standard_normal((b, s, h, d)) * scale).astype(np.float32),
        (rng.standard_normal((b, s, kvh, d)) * scale).astype(np.float32),
        (rng.standard_normal((b, s, kvh, d)) * scale).astype(np.float32),
    )


def _torch(xs, dtype=torch.float32):
    return [torch.tensor(x, dtype=dtype, requires_grad=True) for x in xs]


def _jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cot(xs, seed=1):
    return np.random.default_rng(seed).standard_normal(
        xs[0].shape).astype(np.float32)


def forward_pair(xs, dtype="float32", **kw):
    """(port, JAX) outputs of flash_attention on the same inputs."""
    out = fa.flash_attention(*_torch(xs, getattr(torch, dtype)), **kw)
    ref = jax_fa.flash_attention(*_jax(xs, getattr(jnp, dtype)), **kw)
    assert out.dtype == getattr(torch, dtype)
    return _np(out), _np(ref)


def gradient_pairs(xs, cot, **kw):
    """``[(name, port grad, JAX grad)]`` of
    ``sum(flash_attention(q, k, v) * cot)`` for q, k and v."""
    q, k, v = _torch(xs)
    fa.flash_attention(q, k, v, **kw).backward(torch.from_numpy(cot))

    def loss(q, k, v):
        return (jax_fa.flash_attention(q, k, v, **kw) * cot).sum()

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(*_jax(xs))
    return [(name, _np(g), _np(w))
            for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), g_ref)]


def _gqa_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 128, n, 64)).astype(np.float32)
            for n in (8, 2, 2)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [64, 128])
def test_forward_matches_jax(causal, block):
    out, ref = forward_pair(_qkv(s=128), causal=causal, block_q=block,
                            block_k=block)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_forward_uneven_blocks():
    out, ref = forward_pair(_qkv(s=256), block_q=128, block_k=64)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    xs = _qkv(s=64, d=16)
    for name, got, want in gradient_pairs(xs, _cot(xs), causal=causal,
                                          block_q=32, block_k=32):
        np.testing.assert_allclose(
            got, want, atol=5e-5, rtol=5e-4,
            err_msg=f"grad mismatch for {name}",
        )


def test_bf16_forward_close():
    out, ref = forward_pair(_qkv(s=128), "bfloat16")
    np.testing.assert_allclose(out, ref, atol=3e-2, rtol=3e-2)


def test_flash_attention_head_dim_128():
    """Llama-7B-class head_dim: the tiling must hold at d=128."""
    xs = _qkv(b=1, s=256, h=2, d=128, scale=1.0)
    q, k, v = _torch(xs, torch.bfloat16)
    out = fa.flash_attention(q, k, v)
    ref = jax_fa.flash_attention(*_jax(xs, jnp.bfloat16))
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-2, rtol=3e-2)
    out.float().sum().backward()
    assert bool(torch.isfinite(q.grad.float()).all())


def test_model_integration_flash_impl():
    """GPT with attention_impl='flash' runs and matches the plain
    attention impl."""
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 128))
    )
    logits = {}
    for impl in ("xla", "flash"):
        model = GPT(GPTConfig.tiny(attention_impl=impl), device="cpu")
        logits[impl] = _np(model(tokens))
    np.testing.assert_allclose(logits["xla"], logits["flash"], atol=5e-2,
                               rtol=5e-2)


def test_flash_gqa_matches_repeated_kv():
    """GQA: k/v with fewer heads must match the materialised repeat,
    forward and gradients (q, k AND v), and the JAX GQA path."""
    xs = _gqa_inputs()
    group = xs[0].shape[2] // xs[1].shape[2]

    def loss(q, k, v, repeat):
        if repeat:
            k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
        out = fa.flash_attention(q, k, v, block_q=64, block_k=64)
        return out, (out ** 2).sum()

    q, k, v = _torch(xs)
    out_gqa, l_gqa = loss(q, k, v, repeat=False)
    g_gqa = torch.autograd.grad(l_gqa, (q, k, v))
    out_rep, l_rep = loss(q, k, v, repeat=True)
    g_rep = torch.autograd.grad(l_rep, (q, k, v))
    np.testing.assert_allclose(_np(out_gqa), _np(out_rep), atol=1e-5,
                               rtol=1e-5)
    for a, b_ in zip(g_gqa, g_rep):
        np.testing.assert_allclose(_np(a), _np(b_), atol=2e-4, rtol=2e-4)
    for name, got, want in gradient_pairs(xs, _cot(xs), block_q=64,
                                          block_k=64):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_flash_gqa_rejects_nondivisible_heads():
    q = torch.zeros((1, 128, 6, 64))
    k = torch.zeros((1, 128, 4, 64))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, k)
    # k/v head mismatch must be rejected, not silently mis-indexed
    q8 = torch.zeros((2, 128, 8, 64))
    k2 = torch.zeros((2, 128, 2, 64))
    v8 = torch.zeros((2, 128, 8, 64))
    with pytest.raises(ValueError, match="heads"):
        fa.flash_attention(q8, k2, v8)


@pytest.mark.parametrize("s,requested", [
    (128, 64), (192, 128), (100, 128), (96, 1024), (7, 4), (1024, 512),
])
def test_fit_block_matches_jax(s, requested):
    assert fa._fit_block(s, requested) == jax_fa._fit_block(s, requested)


def test_plain_kernels_take_a_ragged_seq():
    """A seq no block divides (the kernels mask a ragged last tile;
    the plain version falls back to one block) against dense math."""
    xs = _qkv(b=1, s=100, h=2, d=16)
    q, k, v = _torch(xs)
    out = fa.flash_attention(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    mask = torch.tril(torch.ones(100, 100, dtype=torch.bool))
    ref = torch.einsum(
        "bhqk,bkhd->bqhd",
        logits.masked_fill(~mask, -1e30).softmax(-1), v,
    )
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-6)


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_at_head_dims_the_kernels_pad(d, causal):
    """head_dim 16 (the tiny GPT, Llama and BERT configs) and 80, which
    the CUDA wrapper pads to 64 and 128: the plain version against the
    JAX package, forward and gradients."""
    xs = _qkv(b=1, s=64, h=2, d=d)
    out, ref = forward_pair(xs, causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    for name, got, want in gradient_pairs(xs, _cot(xs), causal=causal,
                                          block_q=32, block_k=32):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-4,
                                   err_msg=f"grad mismatch for {name}")


def test_fp16_matches_jax():
    """fp16 inputs, which the CUDA path now takes: p is rounded to fp16
    before P.V on both sides.  fp16 keeps 11 significant bits, so the
    output is held to 2e-3 (bf16's 3e-2 scaled by 2^-4)."""
    out, ref = forward_pair(_qkv(s=128), "float16")
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("d", [16, 32, 80, 96, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_head_dim_is_exact(d, dtype):
    """What the CUDA wrapper does around the kernels, on the plain
    version: zero columns up to the kernel's head_dim, the true d's
    scale, the extra columns of O, dQ, dK and dV zero and sliced off.
    The result is the unpadded one up to fp32 summation order."""
    kd = fa.kernel_head_dim(d)
    assert kd == (64 if d <= 64 else 128 if d <= 128 else 256)
    xs = [torch.from_numpy(x).to(dtype) for x in _qkv(b=1, s=64, h=4, d=d,
                                                      kvh=2)]
    dout = torch.from_numpy(_cot(xs)).to(dtype)
    scale = d ** -0.5

    def run(q, k, v, do):
        out, lse = fa.fwd_plain(q, k, v, scale, True, 32, 32)
        delta = fa.delta_plain(out, do)
        dq = fa.bwd_dq_plain(q, k, v, do, lse, delta, scale, True, 32, 32)
        return [out, lse, dq, *fa.bwd_dkv_plain(q, k, v, do, lse, delta,
                                                scale, True, 32, 32)]

    want = run(*xs, dout)
    got = run(*(fa.pad_head_dim(x, kd) for x in (*xs, dout)))
    for g in (got[0], got[2], got[3], got[4]):
        assert g.shape[-1] == kd and not g[..., d:].any()
    for g, w in zip(got, want):
        g = g[..., :d] if g.dim() == 4 else g
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_head_dim_over_256_raises_naming_the_fault():
    assert fa.kernel_head_dim(256) == 256
    with pytest.raises(ValueError, match="ROADMAP §C 1"):
        fa.kernel_head_dim(257)


def test_cpu_path_launches_no_kernel():
    fa.reset_launch_counts()
    q, k, v = _torch(_qkv(s=64, d=16))
    fa.flash_attention(q, k, v).sum().backward()
    assert fa.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float64, 64, "float32, bfloat16 or float16"),
    (torch.float32, 32, "head_dim"),
])
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(dtype, d, match):
    q = torch.zeros((1, 64, 2, d), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa.fwd_cuda(q, q, q, 0.125, True)


@pytest.mark.parametrize("d_model,head_dim", [
    (768, 64),    # GPT-2 small
    (1600, 64),   # GPT-2 XL
    (2048, 128),  # a head_dim-128 width
])
def test_bf16_rows_reach_the_kernels_16_byte_aligned(d_model, head_dim):
    """The bf16 kernels read rows through TMA tensor maps (and 16-byte
    copies), which need a 16-byte-aligned base and 16-byte strides.
    The model's q/k/v, views of one fused projection (seq stride
    3 d_model), meet that and pass through untouched; views whose rows
    start elsewhere are copied."""
    b, s = 2, 16
    qkv = torch.zeros((b, s, 3 * d_model), dtype=torch.bfloat16)
    views = [t.reshape(b, s, d_model // head_dim, head_dim)
             for t in qkv.split(d_model, dim=-1)]
    assert all(a is v for a, v in zip(fa._cuda_inputs(*views), views))
    for v in views:
        assert v.data_ptr() % 16 == 0 and v.stride(-1) == 1
        assert all(st * v.element_size() % 16 == 0
                   for st in v.stride()[:-1])
    assert views[0].stride(1) == 3 * d_model
    q, k, v = views
    odd = torch.zeros((q.numel() + 1,), dtype=torch.bfloat16)[1:]
    odd = odd.view(q.shape)
    q2, k2, v2 = fa._cuda_inputs(odd, k, v)
    assert q2.data_ptr() % 16 == 0 and q2.is_contiguous()
    assert torch.equal(q2, odd) and k2 is k and v2 is v
    f32 = torch.zeros((b, s, 2, head_dim))[:, 1:]
    assert fa._cuda_inputs(f32, f32, f32)[0] is f32


def _rounding_ratios(dk, dv, fine, coarse):
    """Mean error of (dk, dv) to the plain version with fp32 p and dS
    (``fine``) over the mean error to one that rounds them to bf16
    (``coarse``): ~0.63 for a kernel that keeps fp32 p and dS, ~1.6
    for one that rounds them, its outputs rounded to bf16 either way."""
    return [((g.float() - a).abs().mean()
             / (g.float() - c).abs().mean()).item()
            for g, a, c in zip((dk, dv), fine, coarse)]


def _dkv_references(q, k, v, dout, lse, delta, scale, causal, blk):
    f32 = [x.float() for x in (q, k, v, dout)]
    return [fa.bwd_dkv_plain(*f32, lse, delta, scale, causal, blk, blk,
                             operand_dtype=dt)
            for dt in (torch.float32, torch.bfloat16)]


def test_dkv_rounding_check_tells_fp32_p_from_bf16_p():
    """The check that holds the bf16 dK/dV kernel to fp32 p and dS
    (also in ``chip_smoke.py``): a stand-in for each design, the
    matching plain version rounded to bf16 once, lands on its side of
    0.8."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 200, 4, 64, generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    scale, blk = 64 ** -0.5, fa._fit_block(200, 128)
    out, lse = fa.fwd_plain(q, k, v, scale, True, blk, blk)
    delta = fa.delta_plain(out, dout)
    fine, coarse = _dkv_references(q, k, v, dout, lse, delta, scale, True,
                                   blk)
    keeps = _rounding_ratios(*(t.to(torch.bfloat16) for t in fine), fine,
                             coarse)
    rounds = _rounding_ratios(*(t.to(torch.bfloat16) for t in coarse), fine,
                              coarse)
    assert max(keeps) < 0.8 < 1 / 0.8 < min(rounds), (keeps, rounds)


def test_dq_rounding_check_tells_bf16_ds_from_fp32_ds():
    """The check that holds the bf16 dQ kernel to dS rounded to bf16
    before dS K, the TPU kernel's rounding point (``chip_smoke.py``
    ``_check_dq_rounding``): a stand-in for each design, the matching
    plain version rounded to bf16 once, lands on its side of 0.8."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 200, 4, 64, generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    scale, blk = 64 ** -0.5, fa._fit_block(200, 128)
    out, lse = fa.fwd_plain(q, k, v, scale, True, blk, blk)
    delta = fa.delta_plain(out, dout)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    fine = fa.bwd_dq_plain(qf, kf, vf, dof, lse, delta, scale, True, blk,
                           blk)
    # k in bf16 rounds dS to bf16; q in fp32 keeps dq in fp32
    coarse = fa.bwd_dq_plain(qf, k, vf, dof, lse, delta, scale, True, blk,
                             blk)

    def ratio(dq):
        dq = dq.to(torch.bfloat16).float()
        return ((dq - coarse).abs().mean() / (dq - fine).abs().mean()).item()

    assert ratio(coarse) < 0.8 < 1 / 0.8 < ratio(fine), (ratio(coarse),
                                                         ratio(fine))


def test_params_struct_covers_the_cuda_struct():
    """The ctypes mirror of ``FlashParams`` names every field of the C
    struct, in order."""
    import re
    from pathlib import Path

    src = (Path(fa.__file__).parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    body = re.search(r"struct FlashParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip() for n in re.sub(
                r"^(?:const\s+)?(?:long long|void\s*\*|int|float)\s*", "",
                decl,
            ).split(",")]
    assert names == [f[0] for f in fa._Params._fields_]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 200, 4, 2, 64),   # ragged last tile, GQA group 2
    (1, 136, 4, 2, 128),  # head_dim 128, a seq that no 128 divides
    (2, 320, 8, 2, 128),  # head_dim 128, GQA group 4
])
def test_cuda_kernels_match_plain(cuda, dtype, tol, causal, b, s, h, kvh, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (
        torch.randn(b, s, n, d, generator=gen, device=cuda).to(dtype)
        for n in (h, kvh, kvh, h)
    )
    scale = d ** -0.5
    blk = fa._fit_block(s, 128)
    out, lse = fa.fwd_plain(q, k, v, scale, causal, blk, blk)
    delta = fa.delta_plain(out, dout)
    want = [out, lse, fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale,
                                      causal, blk, blk)]
    want += fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal, blk,
                             blk)
    got = list(fa.fwd_cuda(q, k, v, scale, causal))
    got.append(fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale, causal)[0])
    got += fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


# fp16 holds 11 significant bits to bf16's 8; the head_dim-256 FMA
# kernels round p and dS where the wgmma kernels do
PAD_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 80, 96, 256])
@pytest.mark.parametrize("b,s,h,kvh", [
    (2, 200, 4, 2),  # ragged last tile, GQA group 2
    (1, 256, 4, 4),
])
def test_cuda_head_dims_and_fp16_match_plain(cuda, dtype, causal, d, b, s,
                                             h, kvh):
    """Every head_dim up to 256 and fp16 go through the kernels on the
    card (padded to 64, 128 or 256), forward and backward through
    autograd, and match the plain version on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (
        torch.randn(b, s, n, d, generator=gen, device=cuda).to(dtype)
        for n in (h, kvh, kvh, h)
    )
    fa.reset_launch_counts()
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=causal)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    assert out.shape == q.shape and out.dtype == dtype
    scale, blk = d ** -0.5, fa._fit_block(s, 128)
    w_out, lse = fa.fwd_plain(q, k, v, scale, causal, blk, blk)
    delta = fa.delta_plain(w_out, dout)
    want = [w_out, fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                                   blk, blk)]
    want += fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal, blk,
                             blk)
    tol = PAD_TOL[dtype]
    for g, w in zip([out] + [x.grad for x in xs], want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_head_dim_over_256_raises(cuda):
    q = torch.zeros((1, 64, 2, 320), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP §C 1"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 1024, 4, 4, 64),  # the training seq
    (2, 328, 8, 4, 64),   # GQA group 2, ragged
    (1, 136, 4, 2, 128),  # head_dim 128, ragged
])
def test_cuda_dkv_keeps_fp32_p_and_ds(cuda, b, s, h, kvh, d):
    """TOL cannot tell fp32 p and dS from bf16 ones in dK/dV: the
    error ratio can."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (
        torch.randn(b, s, n, d, generator=gen, device=cuda)
        .to(torch.bfloat16) for n in (h, kvh, kvh, h)
    )
    scale, blk = d ** -0.5, fa._fit_block(s, 128)
    out, lse = fa.fwd_plain(q, k, v, scale, True, blk, blk)
    delta = fa.delta_plain(out, dout)
    dk, dv = fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, True)
    ratios = _rounding_ratios(dk, dv, *_dkv_references(
        q, k, v, dout, lse, delta, scale, True, blk))
    assert max(ratios) < 0.8, ratios


def parity_report():
    """Max-abs errors of the port's plain kernels against the JAX
    package on the cases above."""
    rows = []
    for causal in (True, False):
        rows.append((f"forward fp32 causal={causal}",
                     *forward_pair(_qkv(s=128), causal=causal, block_q=64,
                                   block_k=64)))
        xs = _qkv(s=64, d=16)
        rows += [(f"d{n} fp32 causal={causal}", g, w) for n, g, w in
                 gradient_pairs(xs, _cot(xs), causal=causal, block_q=32,
                                block_k=32)]
    rows.append(("forward bf16", *forward_pair(_qkv(s=128), "bfloat16")))
    xs = _gqa_inputs()
    rows += [(f"d{n} fp32 GQA group 4", g, w) for n, g, w in
             gradient_pairs(xs, _cot(xs), block_q=64, block_k=64)]
    for name, got, want in rows:
        print(f"{name}: max_abs_err {np.abs(got - want).max():.3e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_flash_attention.py
    parity_report()
