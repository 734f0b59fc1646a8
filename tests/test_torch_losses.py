"""The chunked cross entropy of the PyTorch port.

Twins of ``tests/test_losses.py``: the chunked loss matches the full
loss for GPT (tied ``wte``, ``transpose``) and Llama (untied
``lm_head``), value and every gradient at rtol 1e-5 in fp32 (the
reference holds 2e-3 on the TPU, where the head runs in bf16 passes);
a sequence the chunks do not divide raises; the graph keeps less than
one chunk's logits beyond its inputs where the full loss keeps the
``[b, s, V]`` logits (where the reference reads the compiled step's
temp memory, the port adds up the distinct storages the graph saves,
through ``torch.autograd.graph.saved_tensors_hooks``); the loss trains
through ``auto_accelerate`` under FSDP2 (a one-rank gloo group); a
model with no ``return_hidden`` flag raises the reference's
``ValueError``.  And parity: the port's ``chunked_cross_entropy``
against the JAX package's on the same numpy hidden states, head and
targets, value and gradients (rtol 1e-5, atol 1e-6), for both head
layouts.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import losses as jax_losses
from dlrover_tpu_torch.models import (
    GPT,
    GPTConfig,
    Llama,
    LlamaConfig,
    chunked_cross_entropy,
    chunked_loss_fn,
    cross_entropy_loss,
)


def _models():
    llama = Llama(LlamaConfig(
        vocab_size=128, max_seq_len=32, num_layers=2, num_heads=4,
        num_kv_heads=2, hidden_dim=64, intermediate_dim=128,
        dtype=torch.float32), device="cpu", seed=0)
    gpt = GPT(GPTConfig.tiny(max_seq_len=32, dtype=torch.float32),
              device="cpu", seed=0)
    return {"llama": llama, "gpt": gpt}


def _xy(vocab, batch=4, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, vocab, (batch, seq)))
    y = torch.from_numpy(rng.integers(0, vocab, (batch, seq)))
    return x, y


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_chunked_ce_matches_full(family):
    model = _models()[family]
    x, y = _xy(model.config.vocab_size)
    full = cross_entropy_loss(model(x), y)
    g_full = torch.autograd.grad(full, list(model.parameters()))
    loss_fn = chunked_loss_fn(model, num_chunks=4)
    chunked = loss_fn(model, {"x": x, "y": y})
    g_chunk = torch.autograd.grad(chunked, list(model.parameters()))
    assert chunked.dtype == torch.float32 and chunked.dim() == 0
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=0)
    for (name, _), a, b in zip(model.named_parameters(), g_full, g_chunk):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=name)


def test_chunked_ce_rejects_bad_chunking():
    h = torch.zeros((2, 30, 8))
    k = torch.zeros((8, 16))
    t = torch.zeros((2, 30), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_cross_entropy(h, k, t, num_chunks=4)


def test_chunked_ce_saves_no_full_logits():
    """Big vocab, long seq: the full loss's graph keeps ``[b, s, V]``
    logits (its log-softmax) alive for the backward; the chunked loss's
    keeps nothing but its inputs (each chunk's logits are recomputed in
    the backward), and its gradient is the full loss's.  Counted as the
    bytes of the distinct storages the graph saves beyond the inputs'."""
    vocab, b, s, h, chunks = 8192, 2, 512, 64, 16
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32))
    kernel = torch.from_numpy(
        (rng.normal(size=(h, vocab)) * 0.02).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    logits_bytes = b * s * vocab * 4

    def full(w):
        logits = (hidden @ w).float()
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(-1, t[..., None]).mean()

    def chunked(w):
        return chunked_cross_entropy(hidden, w, t, num_chunks=chunks)

    grads, kept = {}, {}
    for name, fn in (("full", full), ("chunked", chunked)):
        w = kernel.clone().requires_grad_()
        inputs = {x.untyped_storage().data_ptr() for x in (hidden, w, t)}
        storages = {}

        def pack(x):
            st = x.untyped_storage()
            if st.data_ptr() not in inputs:
                storages[st.data_ptr()] = st.nbytes()
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss = fn(w)
        kept[name] = sum(storages.values())
        grads[name] = torch.autograd.grad(loss, w)[0]
    assert kept["full"] >= logits_bytes
    assert kept["chunked"] < logits_bytes / chunks, kept
    torch.testing.assert_close(grads["chunked"], grads["full"], rtol=1e-5,
                               atol=1e-9)


@pytest.fixture()
def one_rank_group():
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="losses_pg_")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_chunked_loss_trains_through_auto_accelerate(family, one_rank_group):
    """Under ``fsdp`` + ``amp_native`` on a one-rank group: FSDP2 makes
    every parameter a DTensor, the head (Llama's ``lm_head``, GPT's tied
    ``wte``) included, and the loss falls."""
    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.common.device import is_dtensor

    model = _models()[family]
    rng = np.random.default_rng(0)
    data = rng.integers(0, model.config.vocab_size, (8, 33), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    result = auto_accelerate(
        model, lambda ps: torch.optim.AdamW(ps, lr=1e-3),
        chunked_loss_fn(model, num_chunks=4), batch,
        strategy=Strategy(opts=[("fsdp", {}), ("amp_native", {})]),
        device="cpu")
    assert all(is_dtensor(p) for p in result.model.parameters())
    state, losses = result.state, []
    for _ in range(4):
        state, m = result.train_step(state, result.place_batch(batch))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_chunked_loss_rejects_a_model_without_return_hidden():
    class NoHidden(torch.nn.Module):
        def forward(self, tokens):
            return tokens.float()

    with pytest.raises(ValueError, match="pipelined"):
        chunked_loss_fn(NoHidden())
    loss_fn = chunked_loss_fn(num_chunks=2)
    x = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="return_hidden"):
        loss_fn(NoHidden(), {"x": x, "y": x})


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("num_chunks", [1, 4])
def test_chunked_ce_matches_jax(transpose, num_chunks):
    rng = np.random.default_rng(1)
    b, s, h, v = 2, 16, 32, 96
    hidden = rng.normal(size=(b, s, h)).astype(np.float32)
    kernel = (rng.normal(size=(v, h) if transpose else (h, v))
              * 0.1).astype(np.float32)
    t = rng.integers(0, v, (b, s), dtype=np.int32)

    def jloss(hd, k):
        return jax_losses.chunked_cross_entropy(
            hd, k, jnp.asarray(t), num_chunks=num_chunks,
            transpose=transpose)

    want, (jgh, jgk) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(kernel))
    ph = torch.from_numpy(hidden).requires_grad_()
    pk = torch.from_numpy(kernel).requires_grad_()
    got = chunked_cross_entropy(ph, pk, torch.from_numpy(t),
                                num_chunks=num_chunks, transpose=transpose)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pk.grad.numpy(), np.asarray(jgk), rtol=1e-5,
                               atol=1e-6)


def test_chunked_ce_keeps_the_bf16_head_matmul():
    """bf16 hidden states: the head matmul in bf16, the softmax in fp32,
    an fp32 loss within bf16's rounding of the fp32 loss."""
    rng = np.random.default_rng(2)
    hidden = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
    kernel = torch.from_numpy((rng.normal(size=(32, 64)) * 0.1)
                              .astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 64, (2, 16)))
    fp32 = chunked_cross_entropy(hidden, kernel, t, num_chunks=4)
    bf16 = chunked_cross_entropy(hidden.bfloat16(), kernel, t, num_chunks=4)
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, fp32, rtol=2e-2, atol=0)
    assert bf16.item() != fp32.item()
