"""Training steps with q-AdamW of the PyTorch port against the JAX package.

Three steps of the tiny GPT with ``q_adamw`` through the port's
``make_train_step`` and through the JAX ``make_train_step(mesh=None)``
with the reference's ``q_adamw``, from one flax init and the same
numpy batches, with fp32 and bf16 ``param_dtype`` (fp32 compute) and
grad_accum 1 and 2.  Tolerances: losses within 1e-4 relative; final
fp32 params within 1e-4, except the k part of the qkv bias (see
``test_torch_trainer.py``: its gradient is zero up to rounding noise,
which Adam turns into steps of up to lr each way, so it is held to
2 * steps * lr).  bf16 params: the two frameworks round bf16
gradients at other points (the embedding's scatter-add, the
accumulation of micro-batches), so an element whose gradient is near
zero can see its sign flip and Adam's normalised step go the other
way; every element is held to the same 2 * steps * lr, and at most 1
in 10^3 may lie beyond one bf16 ulp (about 0.07% do).  Then the
example's smoke run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu.trainer import elastic_trainer as jax_et
from dlrover_tpu_torch.examples import train_xl_lowmem
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.optim import q_adamw
from dlrover_tpu_torch.ops import quantization as pq
from dlrover_tpu_torch.trainer.elastic_trainer import (
    TrainState,
    make_train_step,
)
from dlrover_tpu_torch.utils.convert import params_from_jax, params_to_jax

SEQ, BATCH, STEPS, BLOCK, LR = 16, 8, 3, 64, 1e-3
K_BIAS = slice(64, 128)  # the k part of the fused qkv bias (width 64)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batches(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        data = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


def _port_loss(module, batch):
    return port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])


def qadamw_runs(param_dtype, grad_accum):
    """STEPS q-AdamW steps of the port and of the JAX package from one
    init: ``([(port, JAX) loss per step], [(name, port leaf, JAX leaf)]
    of the final params as fp32)``."""
    jpd, ppd = DTYPES[param_dtype]
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32,
                                                param_dtype=jpd))
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, SEQ), jnp.int32))["params"])(jax.random.PRNGKey(0))

    def jloss(p, batch):
        return jax_gpt.cross_entropy_loss(
            jmodel.apply({"params": p}, batch["x"]), batch["y"])

    jopt = jlb.q_adamw(LR, weight_decay=0.1, block_size=BLOCK)
    jstep = jax_et.make_train_step(jloss, jopt, grad_accum=grad_accum)
    jstate = jax_et.TrainState.create(params, jopt)

    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(
        dtype=torch.float32, param_dtype=ppd), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = q_adamw(model.parameters(), lr=LR, weight_decay=0.1,
                  block_size=BLOCK)
    step = make_train_step(_port_loss, opt, grad_accum=grad_accum,
                           device="cpu")
    state = TrainState.create(model, opt)

    losses = []
    for batch in _batches():
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        losses.append((m["loss"].item(), float(jm["loss"])))
    got = params_to_jax(model.state_dict())
    want = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                        jstate.params)
    return losses, [
        (jax.tree_util.keystr(path), np.asarray(g, np.float32), w)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want))
    ]


@pytest.mark.parametrize("param_dtype", list(DTYPES))
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_qadamw_train_steps_match_jax(param_dtype, grad_accum):
    losses, leaves = qadamw_runs(param_dtype, grad_accum)
    for loss in losses:
        np.testing.assert_allclose(*loss, rtol=1e-4)
    beyond_ulp = total = 0
    for name, g, w in leaves:
        if name.endswith("['qkv']['bias']"):
            assert np.abs(g[K_BIAS] - w[K_BIAS]).max() <= 2 * STEPS * LR
            g, w = np.delete(g, K_BIAS), np.delete(w, K_BIAS)
        if param_dtype == "float32" or "['ln" in name:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
        else:
            err = np.abs(g - w)
            assert err.max() <= 2 * STEPS * LR, name
            beyond_ulp += int((err > np.spacing(np.abs(w)) * 2.0 ** 16).sum())
            total += err.size
    assert beyond_ulp <= total // 1_000, f"{beyond_ulp} of {total}"


def test_example_smoke_runs_on_cpu(tmp_path, monkeypatch):
    """``python -m dlrover_tpu_torch.examples.train_xl_lowmem --smoke
    --device cpu``, two steps: bf16 params, int8 moments, falling
    loss, and no kernel launched on the CPU."""
    monkeypatch.setenv("DLROVER_METRICS_FILE", str(tmp_path / "m.json"))
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(tmp_path / "events.jsonl"))
    pq.reset_launch_counts()
    result = train_xl_lowmem.main(["--smoke", "--device", "cpu",
                                   "--steps", "2"])
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    assert result["losses"][1] < result["losses"][0]
    assert pq.LAUNCHES == {"quantize": 0, "dequantize": 0, "qadam": 0}
    trainer = train_xl_lowmem.build_trainer(True, 1, "cpu")
    trainer.train()
    model, opt = trainer.model, trainer.state.optimizer
    assert model.wte.weight.dtype == torch.bfloat16
    assert model.blocks[0].ln_attn.weight.dtype == torch.float32
    st = opt.state[model.wte.weight]
    assert st["mu_values"].dtype == torch.int8 and st["step"] == 1
    assert opt.param_groups[0]["lr"] == 3e-4
    assert opt.param_groups[0]["weight_decay"] == 0.1


def test_example_full_config_is_gpt2_xl():
    cfg = train_xl_lowmem.config(smoke=False)
    assert (cfg.num_layers, cfg.num_heads, cfg.hidden_dim, cfg.max_seq_len,
            cfg.vocab_size) == (48, 25, 1600, 1024, 50304)
    assert cfg.param_dtype == torch.bfloat16 and cfg.remat
    assert cfg.attention_impl == "flash" and cfg.tie_embeddings


def parity_report():
    """Largest differences of the port's q-AdamW training steps from
    the JAX package's on the cases above."""
    for param_dtype in DTYPES:
        for grad_accum in (1, 2):
            losses, leaves = qadamw_runs(param_dtype, grad_accum)
            loss_err = max(abs(a - b) / abs(b) for a, b in losses)
            err = max(np.abs(np.delete(g, K_BIAS) - np.delete(w, K_BIAS)).max()
                      if n.endswith("['qkv']['bias']")
                      else np.abs(g - w).max() for n, g, w in leaves)
            print(f"{param_dtype} grad_accum {grad_accum}: {STEPS} steps, "
                  f"loss rel_err {loss_err:.3e}, final params max_abs_err "
                  f"{err:.3e} (k bias excepted)")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_low_bit_trainer.py
    parity_report()
