"""A 12-layer Llama trained by the PyTorch port against the JAX package.

Twelve layers, so that the flatten order of both packages' trees
(dict keys sorted: ``block_10`` before ``block_2``, ``k_proj`` before
``q_proj``) is exercised wherever a tree is walked: the converter, the
q-AdamW state and the flash checkpoint.

- Five int8 q-AdamW steps of a narrow Llama (d 32, two heads over one
  kv head, GQA group 2) through the port's ``make_train_step`` and the
  JAX ``make_train_step`` with the reference's ``q_adamw``, from one
  flax init and the same numpy batches, fp32 and bf16 ``param_dtype``
  (fp32 compute).  After every step each run's int8 codes and scales
  are those of its own moments, recomputed from its state before the
  step and its gradient, in every leaf (so a fault of the port's
  q-AdamW in any leaf fails, however small), and the two runs' codes
  differ only where their moments straddle a rounding tie.  Then
  ``tests/test_torch_low_bit_trainer.py``'s tolerances: losses within
  1e-4 relative; every param within Adam's bound of 2 * steps * lr;
  fp32 params (and the fp32 norm scales) within 1e-4, except an
  element whose codes differed from the JAX run's at some step or
  whose JAX gradient was below 1e-7 but not 0 at some step (at most 1
  in 50 of them; 1,231 of 119,584 in fp32 when written); bf16 params
  at most 1 in 10^3 beyond one bf16 ulp.  The JAX run's final q-AdamW
  state loads into the port's optimizer and goes back to the
  reference's layout bit for bit.
- The port's ``Trainer`` with the chunked loss saves the Llama, resumes
  it bit-equal, and its checkpoint resumes the JAX package's
  ``Trainer`` bit-equal, and the other way round.
"""

import os
import shutil
import tempfile
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.accel import Strategy as JaxStrategy
from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.models import losses as jax_losses
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu.trainer import elastic_trainer as jax_et
from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
from dlrover_tpu.trainer.trainer import (
    TrainingArguments as JaxTrainingArguments,
)
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.models import llama as port_llama
from dlrover_tpu_torch.models.losses import chunked_loss_fn
from dlrover_tpu_torch.optim import q_adamw
from dlrover_tpu_torch.trainer.elastic_trainer import (
    TrainState,
    make_train_step,
)
from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments
from dlrover_tpu_torch.utils.convert import (
    _flat,
    _torch_name,
    params_from_jax,
    params_to_jax,
    qadamw_state_from_jax,
    qadamw_state_to_jax,
)

SEQ, BATCH, STEPS, BLOCK, LR = 16, 8, 5, 64, 1e-3
# a gradient this small is rounding noise of the sums (as in
# test_torch_accelerate_dist.py)
GRAD_QUIET = 1e-7
# a pre-rounding moment this near a rounding tie (relative to the terms
# that make it) rounds either way (as in test_torch_accelerate_dist.py)
TIE = 1e-4
LAYERS, VOCAB = 12, 128
NARROW = dict(vocab_size=VOCAB, max_seq_len=SEQ, num_layers=LAYERS,
              num_heads=2, num_kv_heads=1, hidden_dim=32,
              intermediate_dim=64)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        data = rng.integers(0, VOCAB, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


def _port_loss(module, batch):
    return port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])


def _jax_qstate(opt_state):
    """name -> the JAX run's int8 codes and fp32 scales of mu and nu:
    codes ``[rows, BLOCK]``, scales ``[rows, 1]``."""
    node = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    out = {}
    for which in ("mu", "nu"):
        for path, qm in _flat(getattr(node, which)):
            parts = out.setdefault(_torch_name(path), {})
            parts[f"{which}_values"] = np.asarray(
                qm.values, np.float32).reshape(-1, BLOCK)
            parts[f"{which}_scales"] = np.asarray(
                qm.scales, np.float32).reshape(-1, 1)
    return out


def _port_qstate(opt, p):
    """The port's codes and scales of ``p``, as :func:`_jax_qstate`'s."""
    st = opt.state[p]
    return {k: st[k].float().numpy().reshape(
        (-1, 1) if k.endswith("scales") else (-1, BLOCK)).copy()
        for k in ("mu_values", "mu_scales", "nu_values", "nu_scales")}


def _pre_rounding(g, st, b1=0.9, b2=0.999):
    """``{"mu": (a, slack), "nu": (a, slack), "mu_scale": s, "nu_scale":
    s}`` of one step of q-AdamW's
    moment update (``_qadam_kernel``) from the state before it and the
    gradient: ``a`` the moments over their new block scales, whose
    rounding is the new codes, and ``slack`` how near a rounding tie
    ``a`` may sit and round either way with the sums' rounding noise
    (``TIE`` of the terms that make it; mu's sum may cancel, nu's terms
    are all positive), as ``tests/test_torch_accelerate_dist.py``'s
    ``_reference_ties``."""
    g = np.pad(g, (0, -g.size % BLOCK)).reshape(-1, BLOCK)
    mu_prev = st["mu_values"] * st["mu_scales"]
    mu = b1 * mu_prev + (1 - b1) * g
    nu_prev = st["nu_values"] * st["nu_scales"]
    nu_sqrt = np.sqrt(b2 * nu_prev * nu_prev + (1 - b2) * g * g)
    out = {}
    for which, x, terms in (
            ("mu", mu, b1 * np.abs(mu_prev) + (1 - b1) * np.abs(g)),
            ("nu", nu_sqrt, nu_sqrt)):
        scale = np.maximum(np.abs(x).max(-1, keepdims=True) / 127, 1e-12)
        out[which] = (x / scale, TIE * (np.abs(x / scale) + terms / scale))
        out[f"{which}_scale"] = scale
    return out


def _off_tie(a, slack):
    """Where ``a`` sits farther than ``slack`` from a rounding tie."""
    return np.abs(np.abs(a) - np.floor(np.abs(a)) - 0.5) >= slack


def qadamw_runs(param_dtype):
    """STEPS q-AdamW steps of the port and of the JAX package from one
    init: ``(losses, [(path, port leaf, JAX leaf, flipped)] of the final
    params as fp32, the JAX run's final state, the port's model and
    optimizer)``.  After every step each run's int8 codes and scales
    must be those of its own moments, recomputed from its state before
    the step and its gradient, for every leaf; the two runs' codes may
    differ only where their moments straddle a rounding tie (the
    gradients drift apart once an element steps apart, by up to 1.2
    codes in an unmarked element after 5 steps).  ``flipped`` marks the
    elements whose codes differed at some step, and those whose JAX
    gradient was below ``GRAD_QUIET`` (rounding noise of the sums).
    ``flipped`` marks those elements, which Adam's normalised step may
    move apart by up to lr a step."""
    jpd, ppd = DTYPES[param_dtype]
    jmodel = jax_llama.Llama(jax_llama.LlamaConfig(
        dtype=jnp.float32, param_dtype=jpd, **NARROW))
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, SEQ), jnp.int32))["params"])(jax.random.PRNGKey(0))

    def jloss(p, batch):
        return jax_gpt.cross_entropy_loss(
            jmodel.apply({"params": p}, batch["x"]), batch["y"])

    jopt = jlb.q_adamw(LR, weight_decay=0.1, block_size=BLOCK)
    jstep = jax_et.make_train_step(jloss, jopt)
    jgrad = jax.jit(jax.grad(jloss))
    jstate = jax_et.TrainState.create(params, jopt)

    model = port_llama.Llama(port_llama.LlamaConfig(
        dtype=torch.float32, param_dtype=ppd, **NARROW), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = q_adamw(model.parameters(), lr=LR, weight_decay=0.1,
                  block_size=BLOCK)
    step = make_train_step(_port_loss, opt, device="cpu")
    state = TrainState.create(model, opt)

    losses = []
    flipped = {n: np.zeros(p.numel(), bool)
               for n, p in model.named_parameters()}
    named = dict(model.named_parameters())
    for i, batch in enumerate(_batches()):
        jbatch = jax.tree.map(jnp.asarray, batch)
        grads = {_torch_name(path): np.asarray(g, np.float32).reshape(-1)
                 for path, g in _flat(jax.tree.map(
                     np.asarray, jgrad(jstate.params, jbatch)))}
        jbefore = _jax_qstate(jax.tree.map(np.asarray, jstate.opt_state))
        before = {n: _port_qstate(opt, p) for n, p in named.items()}
        for name, g in grads.items():
            # (an exact 0, a row of wte no token reads, is the same on
            # both sides)
            flipped[name] |= (np.abs(g) > 0) & (np.abs(g) < GRAD_QUIET)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        losses.append((m["loss"].item(), float(jm["loss"])))
        jafter = _jax_qstate(jax.tree.map(np.asarray, jstate.opt_state))
        for name, p in named.items():
            n = p.numel()
            after = _port_qstate(opt, p)
            mine = _pre_rounding(p.grad.float().numpy().reshape(-1),
                                 before[name])
            ref = _pre_rounding(grads[name], jbefore[name])
            for which in ("mu", "nu"):
                where = (i, name, which)
                (a, slack), (ra, rslack) = (
                    (x.reshape(-1)[:n], t.reshape(-1)[:n])
                    for x, t in (mine[which], ref[which]))
                codes = after[f"{which}_values"].reshape(-1)[:n]
                want = jafter[name][f"{which}_values"].reshape(-1)[:n]
                # each run's codes round its own moments, recomputed
                # from its state before the step and its gradient (off a
                # tie), and its scales are their blocks' largest / 127:
                # the port's, in every leaf, as the JAX run's
                for run, got, x, t, scales, own in (
                        ("port", codes, a, slack, after, mine),
                        ("jax", want, ra, rslack, jafter[name], ref)):
                    wrong = (got != np.clip(np.round(x), -127, 127)) & \
                        _off_tie(x, t)
                    assert not wrong.any(), (run, where, np.argwhere(wrong))
                    np.testing.assert_allclose(
                        scales[f"{which}_scales"], own[f"{which}_scale"],
                        rtol=1e-5, err_msg=f"{run} {where}")
                # the two runs' codes differ only where their moments lie
                # on the two sides of a tie (the JAX run's within their
                # distance of it)
                diff = codes != want
                gap = np.abs(a - ra) + rslack
                assert not (diff & _off_tie(ra, gap)).any(), (
                    where, np.argwhere(diff & _off_tie(ra, gap)))
                flipped[name] |= diff
    got = params_to_jax(model.state_dict())
    want = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                        jstate.params)
    marks = params_to_jax({n: torch.from_numpy(f)
                           for n, f in flipped.items()})
    leaves = [
        (jax.tree_util.keystr(path), np.asarray(g, np.float32), w,
         f.reshape(w.shape))
        for (path, g), w, f in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(marks))
    ]
    return losses, leaves, jax.tree.map(np.asarray, jstate.opt_state), \
        model, opt


@pytest.mark.parametrize("param_dtype", list(DTYPES))
def test_qadamw_train_steps_match_jax_at_12_layers(param_dtype):
    losses, leaves, jopt_state, model, opt = qadamw_runs(param_dtype)
    names = [n for n, _, _, _ in leaves]
    # the sorted flatten order at depth 12, on both sides
    assert names.index("['block_10']['attn']['k_proj']['kernel']") < \
        names.index("['block_2']['attn']['k_proj']['kernel']")
    for loss in losses:
        np.testing.assert_allclose(*loss, rtol=1e-4)
    beyond_ulp = total = exempt = 0
    for name, g, w, flipped in leaves:
        err = np.abs(g - w)
        # Adam's bound: a step moves an element by at most ~lr
        assert err.max() <= 2 * STEPS * LR, name
        total += err.size
        if param_dtype == "float32" or "['ln" in name:
            # an element whose int8 codes straddled a tie from the JAX
            # run's, or whose gradient was noise, takes steps of its own
            # (up to Adam's bound)
            exempt += int(flipped.sum())
            np.testing.assert_allclose(g[~flipped], w[~flipped], atol=1e-4,
                                       err_msg=name)
        else:
            beyond_ulp += int((err > np.spacing(np.abs(w)) * 2.0 ** 16).sum())
    assert beyond_ulp <= total // 1_000, f"{beyond_ulp} of {total}"
    assert exempt <= total // 50, f"{exempt} of {total} codes flipped"
    print(f"{param_dtype}: {exempt} of {total} elements held to Adam's "
          f"bound, {beyond_ulp} beyond one bf16 ulp")

    # the JAX run's state into the port's layout and back, bit for bit
    node = jopt_state if hasattr(jopt_state, "mu") else jopt_state[0]
    again = q_adamw(model.parameters(), lr=LR, weight_decay=0.1,
                    block_size=BLOCK)
    again.load_state_dict(qadamw_state_from_jax(node, model))
    back = qadamw_state_to_jax(again, model)
    assert int(back["count"]) == int(node.count) == STEPS
    for which in ("mu", "nu"):
        got = jax.tree_util.tree_leaves_with_path(back[which])
        want = jax.tree_util.tree_leaves_with_path(getattr(node, which))
        assert [jax.tree_util.keystr(p) for p, _ in got] == [
            jax.tree_util.keystr(p) for p, _ in want]
        assert len(got) == 2 * len(list(model.parameters()))
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), path


# -- the Trainer's checkpoint, both ways -----------------------------------


@pytest.fixture()
def job(monkeypatch):
    """A shm namespace and a socket directory of the test's own."""
    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"test-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _batch():
    return _batches(seed=3)[0]


def _port_trainer(out, max_steps, seed=1, **kw):
    model = port_llama.Llama(port_llama.LlamaConfig(
        dtype=torch.float32, **NARROW), device="cpu", seed=seed)
    args = TrainingArguments(
        output_dir=str(out), max_steps=max_steps, global_batch_size=BATCH,
        micro_batch_size=BATCH, logging_steps=100, **kw)
    return Trainer(model, args, [_batch()], chunked_loss_fn(num_chunks=2),
                   device="cpu")


def _jax_trainer(out, max_steps, **kw):
    model = jax_llama.Llama(jax_llama.LlamaConfig(**NARROW))
    args = JaxTrainingArguments(
        output_dir=str(out), max_steps=max_steps, global_batch_size=BATCH,
        micro_batch_size=BATCH, logging_steps=100,
        strategy=JaxStrategy(opts=[("parallel_mode", {})]), **kw)
    return JaxTrainer(model, args, [_batch()],
                      jax_losses.chunked_loss_fn(model, num_chunks=2))


def _tracked_step(out, step, timeout=30.0):
    tracker = os.path.join(str(out), CheckpointConstant.TRACKER_FILE)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(tracker) and open(tracker).read().strip() == str(
                step):
            return
        time.sleep(0.02)
    raise AssertionError(f"step {step} not committed in {out}")


def _flat_bytes(tree) -> dict:
    return {
        jax.tree_util.keystr(path): (np.asarray(leaf).dtype,
                                     np.asarray(leaf).tobytes())
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_trainer_resumes_a_llama_bit_equal(tmp_path, job):
    first = _port_trainer(tmp_path, 3, save_steps=3)
    result = first.train()
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    assert result["losses"][-1] < result["losses"][0]
    saved = {k: v.detach().clone() for k, v in first.model.state_dict()
             .items()}
    _tracked_step(tmp_path, 3)
    second = _port_trainer(tmp_path, 3, seed=2, save_steps=3)
    result = second.train()
    assert second.last_restore_phases["tier"] == "shm"
    assert result["steps"] == 3 and result["losses"] == []
    for name, value in second.model.state_dict().items():
        assert torch.equal(value, saved[name]), name


def test_jax_trainer_checkpoint_resumes_the_port_trainer(tmp_path, job):
    jax_trainer = _jax_trainer(tmp_path, 2, save_steps=2)
    jax_trainer.train()
    _tracked_step(tmp_path, 2)
    want = _flat_bytes(jax.tree.map(np.asarray,
                                    jax_trainer._accel.state.params))
    JaxSaver.reset()
    port = _port_trainer(tmp_path, 2, save_steps=2)
    result = port.train()
    assert port.last_restore_phases["tier"] == "storage"
    assert result["steps"] == 2 and result["losses"] == []
    assert _flat_bytes(params_to_jax(port.model.state_dict())) == want


def test_port_trainer_checkpoint_resumes_the_jax_trainer(tmp_path, job):
    port = _port_trainer(tmp_path, 2, save_steps=2)
    port.train()
    _tracked_step(tmp_path, 2)
    want = _flat_bytes(params_to_jax(port.model.state_dict()))
    assert "['block_10']['attn']['k_proj']['kernel']" in want
    AsyncCheckpointSaver.reset()
    jax_trainer = _jax_trainer(tmp_path, 2, save_steps=2)
    result = jax_trainer.train()
    assert result["steps"] == 2
    got = _flat_bytes(jax.tree.map(np.asarray,
                                   jax_trainer._accel.state.params))
    assert got == want


def parity_report():
    """Largest differences of the port's 12-layer q-AdamW run from the
    JAX package's."""
    for param_dtype in DTYPES:
        losses, leaves, _, _, _ = qadamw_runs(param_dtype)
        loss_err = max(abs(a - b) / abs(b) for a, b in losses)
        err = max(np.abs(g - w).max() for _, g, w, _ in leaves)
        print(f"{param_dtype}: {STEPS} steps, loss rel_err {loss_err:.3e}, "
              f"final params max_abs_err {err:.3e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_llama_train.py
    parity_report()
