"""Training step and Trainer of the PyTorch port against the JAX package.

Three AdamW steps of the port's ``make_train_step`` against the JAX
``make_train_step(mesh=None)`` with ``optax.adamw(1e-3)``, from one
flax init and the same numpy batches: losses within 1e-4 relative,
final params within 1e-4 (fp32; sums run in another order).  Then
the port alone: gradient accumulation equals one full batch, the
Trainer writes its metrics file and events on the CPU, refuses to run
without a GPU unless told ``device="cpu"``, and raises for the options
of later slices.  Every Trainer here writes its final checkpoint into
the test's own directory and does not resume (the shm segment of an
earlier test in the process would hold one); the in-process saver is
stopped and the segment unlinked after each test.
"""

import json
import shutil
import tempfile
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.trainer import elastic_trainer as jax_et
from dlrover_tpu_torch.accel import Strategy
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.telemetry.events import read_events
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    StepPhaseProfiler,
    TrainState,
    make_train_step,
)
from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments
from dlrover_tpu_torch.utils.convert import params_from_jax, params_to_jax

SEQ, BATCH, STEPS = 16, 8, 3
# the k part of the tiny model's fused qkv bias (hidden width 64)
K_BIAS = slice(64, 128)


def _batches(n=STEPS, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        data = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


def _port_loss(module, batch):
    return port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])


def _port_model(params=None, seed=0):
    model = port_gpt.GPT(
        port_gpt.GPTConfig.tiny(dtype=torch.float32), device="cpu", seed=seed
    )
    if params is not None:
        model.load_state_dict(params_from_jax(params))
    return model


def _adamw(model, lr=1e-3):
    # optax.adamw(lr) defaults
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def adamw_runs(grad_accum):
    """STEPS AdamW steps of the port and of the JAX package from one
    init: ``([(port, JAX) (loss, grad_norm) per step], [(name, port
    leaf, JAX leaf)] of the final params)``."""
    cfg = jax_gpt.GPTConfig.tiny(dtype=jnp.float32)
    jmodel = jax_gpt.GPT(cfg)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, SEQ), jnp.int32))["params"])(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)

    def jloss(p, batch):
        return jax_gpt.cross_entropy_loss(
            jmodel.apply({"params": p}, batch["x"]), batch["y"]
        )

    optimizer = optax.adamw(1e-3)
    jstep = jax_et.make_train_step(jloss, optimizer, grad_accum=grad_accum)
    jstate = jax_et.TrainState.create(params, optimizer)

    model = _port_model(np_params)
    opt = _adamw(model)
    step = make_train_step(_port_loss, opt, grad_accum=grad_accum,
                           device="cpu")
    state = TrainState.create(model, opt)

    metrics = []
    for batch in _batches():
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        metrics.append(((m["loss"].item(), float(jm["loss"])),
                        (m["grad_norm"].item(), float(jm["grad_norm"]))))
    assert state.step == int(jstate.step) == STEPS
    got = params_to_jax(model.state_dict())
    want = jax.tree.map(np.asarray, jstate.params)
    return metrics, [
        (jax.tree_util.keystr(path), g, w) for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves(want))
    ]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_adamw_steps_match_jax(grad_accum):
    metrics, leaves = adamw_runs(grad_accum)
    for loss, grad_norm in metrics:
        np.testing.assert_allclose(*loss, rtol=1e-4)
        np.testing.assert_allclose(*grad_norm, rtol=1e-4)
    for name, g, w in leaves:
        if name.endswith("['qkv']['bias']"):
            # the k bias adds one constant to a row of logits, which
            # softmax ignores: its gradient is 0 up to rounding noise,
            # and Adam's g / (|g| + eps) turns that noise into steps of
            # up to lr each way.  It is held to that bound; q and v
            # biases to 1e-4 like every other leaf.
            assert np.abs(g[K_BIAS] - w[K_BIAS]).max() <= 2 * STEPS * 1e-3
            g, w = np.delete(g, K_BIAS), np.delete(w, K_BIAS)
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


def test_grad_accum_equals_one_full_batch():
    """Micro-batch gradients summed and divided equal the full batch's
    (plain SGD with lr 1 turns the update into the gradient)."""
    batch = _batches(1)[0]
    params, metrics = [], []
    for accum in (1, 2, 4):
        model = _port_model(seed=3)
        opt = torch.optim.SGD(model.parameters(), lr=1.0)
        step = make_train_step(_port_loss, opt, grad_accum=accum,
                               device="cpu")
        _, m = step(TrainState.create(model, opt), batch)
        params.append(model.state_dict())
        metrics.append(m)
    for other, m in zip(params[1:], metrics[1:]):
        torch.testing.assert_close(m["loss"], metrics[0]["loss"])
        torch.testing.assert_close(m["grad_norm"], metrics[0]["grad_norm"])
        for name, value in params[0].items():
            torch.testing.assert_close(other[name], value, atol=1e-6,
                                       rtol=1e-5)


@pytest.fixture(autouse=True)
def _checkpoint_scope(monkeypatch):
    """A shm namespace and a socket directory of the test's own."""
    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"test-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    yield
    AsyncCheckpointSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _trainer(tmp_path, max_steps=4, device="cpu", **kw):
    model = _port_model(seed=1)
    args = TrainingArguments(
        output_dir=str(tmp_path / "ckpt"), resume_from_checkpoint=False,
        max_steps=max_steps, global_batch_size=8, micro_batch_size=4,
        logging_steps=2, **kw,
    )
    return Trainer(model, args, [_batches(1)[0]], _port_loss, device=device)


def test_trainer_on_cpu_writes_metrics_and_events(tmp_path, monkeypatch):
    events = tmp_path / "events.jsonl"
    metrics = tmp_path / "metrics.json"
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(events))
    monkeypatch.setenv("DLROVER_METRICS_FILE", str(metrics))
    trainer = _trainer(tmp_path, max_steps=6)
    result = trainer.train()

    assert result["steps"] == 6 and len(result["losses"]) == 6
    assert all(np.isfinite(result["losses"]))
    # one fixed batch: the model fits it
    assert result["final_loss"] < result["losses"][0]
    assert trainer._elastic.grad_accum == 2
    record = json.loads(metrics.read_text())
    assert record["global_step"] == 6
    assert record["loss"] == pytest.approx(result["final_loss"])
    assert {"compute", "h2d", "report", "total_s"} <= set(record["phases"])
    steps = [e for e in read_events(str(events)) if e["type"] == "train_step"]
    assert [e["step"] for e in steps] == list(range(1, 7))
    assert steps[-1]["loss"] == pytest.approx(result["final_loss"])
    assert all(e["source"] == "trainer" for e in steps)
    phases = [e for e in read_events(str(events))
              if e["type"] == "step_phases"]
    assert len(phases) == 6 and all("compute" in e for e in phases)


def test_trainer_evaluate_on_cpu(tmp_path):
    trainer = _trainer(tmp_path, max_steps=2)
    trainer.eval_data = _batches(2, seed=7)
    trainer.train()
    loss = trainer.evaluate()
    assert np.isfinite(loss)
    assert trainer.model.training


def test_trainer_runs_on_the_gpu_unless_told_otherwise(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer(tmp_path, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(_port_loss, None)


@pytest.mark.parametrize("kw,match", [
    # a strategy is taken since slice 4.1; the pipeline and fp8 of
    # slice 5 raised when the Trainer was built until slice 5.3 landed:
    # both now build and train (``match`` names the slice they came with)
    (dict(strategy=Strategy(opts=[("pipeline_parallel", {"size": 2})])),
     "slice 5"),
    (dict(strategy=Strategy(opts=[("parallel_mode", {}), ("fp8", {})])),
     "slice 5"),
])
def test_trainer_options_of_later_slices_raise(tmp_path, kw, match):
    from dlrover_tpu_torch.models.gpt import PipelinedGPT
    from dlrover_tpu_torch.ops.fp8 import Fp8Dense

    trainer = _trainer(tmp_path, max_steps=2, **kw)
    result = trainer.train()
    assert all(np.isfinite(result["losses"]))
    model = trainer.state.module
    if "fp8" in kw["strategy"].names():
        assert isinstance(model.blocks[0].mlp.fc_in, Fp8Dense)
    else:
        assert isinstance(model, PipelinedGPT)
        assert dict(model.named_parameters())[
            "blocks.attn.qkv.weight"].shape[0] == 2


def test_default_optimizer_is_optax_adamw(tmp_path):
    trainer = _trainer(tmp_path)
    opt = trainer._default_optim(trainer.model.parameters())
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)


def test_loss_spike_detection(tmp_path):
    trainer = _trainer(tmp_path)
    trainer._loss_ema = 1.0
    trainer.args.loss_spike_factor = 2.0
    trainer._check_loss_spike(1, 5.0)  # 5 > 2*1.0
    assert trainer.loss_spikes and trainer.loss_spikes[0]["step"] == 1
    trainer._check_loss_spike(2, 1.0)
    assert len(trainer.loss_spikes) == 1


def test_elastic_trainer_keeps_the_global_batch(tmp_path):
    et = ElasticTrainer(32, 8, dp_size=2,
                        metrics_path=str(tmp_path / "m.json"))
    assert (et.grad_accum, et.local_batch_size) == (2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        ElasticTrainer(30, 8, dp_size=2)
    et.report_step({"loss": torch.tensor(2.5), "grad_norm": 1.0})
    et.set_epoch(3)
    state = et.state_dict()
    assert state == {"global_step": 1, "epoch": 3}
    other = ElasticTrainer(32, 8, dp_size=2,
                           metrics_path=str(tmp_path / "m2.json"))
    other.load_state_dict(state)
    assert other.state_dict() == state
    record = json.loads((tmp_path / "m.json").read_text())
    assert record["loss"] == 2.5 and record["grad_norm"] == 1.0


def test_elastic_trainer_reads_world_size_from_env(monkeypatch):
    monkeypatch.setenv("DLROVER_WORLD_SIZE", "4")
    monkeypatch.setenv("DLROVER_RESTART_COUNT", "2")
    et = ElasticTrainer(32, 4)
    assert et.dp_size == 4 and et.grad_accum == 2
    assert et._restart_count == 2


def test_step_phase_profiler_books_phases():
    prof = StepPhaseProfiler()
    with prof.phase("compute") as p:
        p.block({"loss": torch.ones(())})
    prof.add("checkpoint", 0.25)
    phases = prof.finish_step()
    assert phases["checkpoint"] == 0.25
    assert phases["total_s"] >= phases["compute"] >= 0.0
    assert set(phases) == {"compute", "checkpoint", "total_s", "other_s"}
    assert prof.finish_step().keys() == {"total_s", "other_s"}


def parity_report():
    """Largest differences of the port's AdamW steps from the JAX
    package's on the cases above."""
    for grad_accum in (1, 2):
        metrics, leaves = adamw_runs(grad_accum)
        loss_err = max(abs(a - b) / abs(b) for (a, b), _ in metrics)
        errs = {"k bias": 0.0, "other leaves": 0.0}
        for name, g, w in leaves:
            err = np.abs(g - w)
            if name.endswith("['qkv']['bias']"):
                errs["k bias"] = max(errs["k bias"], err[K_BIAS].max())
                err = np.delete(err, K_BIAS)
            errs["other leaves"] = max(errs["other leaves"], err.max())
        print(f"grad_accum {grad_accum}: {STEPS} steps, loss rel_err "
              f"{loss_err:.3e}, final params max_abs_err " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_trainer.py
    parity_report()
