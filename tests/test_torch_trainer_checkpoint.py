"""``Trainer`` checkpointing of the PyTorch port against the JAX package.

A 2-layer GPT on the CPU: the port's ``Trainer`` saves every
``save_steps`` (memory) and ``save_storage_steps`` (storage) and at the
end, and resumes from shm or storage with its params bit-equal to the
state it saved, the trainer's step counter restored and the optimizer
built fresh.  A checkpoint of the JAX package's ``Trainer`` resumes the
port's with bit-equal params, and the other way round: both save the
params under their flax paths, and the flat layout is the same.
"""

import os
import shutil
import tempfile
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.accel import Strategy
from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
from dlrover_tpu.trainer.trainer import (
    TrainingArguments as JaxTrainingArguments,
)
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments
from dlrover_tpu_torch.utils.convert import params_to_jax

BATCH, SEQ = 8, 16


@pytest.fixture(autouse=True)
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
    data = np.random.default_rng(0).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def _port_loss(module, batch):
    return port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])


def _port_trainer(out, max_steps, seed=1, **kw):
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(dtype=torch.float32),
                         device="cpu", seed=seed)
    args = TrainingArguments(
        output_dir=str(out), max_steps=max_steps, global_batch_size=BATCH,
        micro_batch_size=BATCH // 2, logging_steps=100, **kw,
    )
    return Trainer(model, args, [_batch()], _port_loss, device="cpu")


def _jax_trainer(out, max_steps, **kw):
    model = jax_gpt.GPT(jax_gpt.GPTConfig.tiny())

    def loss_fn(p, batch, model=model):
        return jax_gpt.cross_entropy_loss(
            model.apply({"params": p}, batch["x"]), batch["y"])

    args = JaxTrainingArguments(
        output_dir=str(out), max_steps=max_steps, global_batch_size=BATCH,
        micro_batch_size=BATCH, logging_steps=100,
        strategy=Strategy(opts=[("parallel_mode", {})]), **kw,
    )
    return JaxTrainer(model, args, [_batch()], loss_fn)


def _params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _tracked_step(out, step, timeout=30.0) -> None:
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


@pytest.mark.parametrize("tier", ["shm", "storage"])
def test_resume_restores_params_and_step(tmp_path, tier):
    first = _port_trainer(tmp_path, 4, save_steps=2)
    first.train()
    saved = _params(first)
    _tracked_step(tmp_path, 4)
    if tier == "storage":
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
    # another seed: every param must come from the checkpoint
    second = _port_trainer(tmp_path, 4, seed=2, save_steps=2)
    result = second.train()
    assert second.last_restore_phases["tier"] == tier
    assert {"read_s", "assemble_s", "h2d_s"} <= set(
        second.last_restore_phases)
    assert result["steps"] == 4 and result["losses"] == []
    assert second._elastic.global_step == 4 and second.state.step == 4
    got = _params(second)
    assert got.keys() == saved.keys()
    for name in saved:
        assert torch.equal(got[name], saved[name]), name
    third = _port_trainer(tmp_path, 6, seed=3, save_steps=2)
    result = third.train()
    assert result["steps"] == 6 and len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    assert third._elastic.global_step == 6 and third.state.step == 6


def test_resume_builds_the_optimizer_fresh(tmp_path):
    """As the reference: params and counters come back, the AdamW
    moments start from zero."""
    _port_trainer(tmp_path, 2, save_steps=2).train()
    resumed = _port_trainer(tmp_path, 3, seed=2, save_steps=2)
    resumed.train()
    opt = resumed.state.optimizer
    assert {int(s["step"]) for s in opt.state.values()} == {1}


def test_save_cadence_memory_and_storage(tmp_path):
    """save_steps 2, save_storage_steps 4, 6 steps: memory saves at 2
    and 6, storage at 4, and the final storage save at 6."""
    trainer = _port_trainer(tmp_path, 6, save_steps=2, save_storage_steps=4,
                            resume_from_checkpoint=False)
    trainer.train()
    _tracked_step(tmp_path, 6)
    dirs = sorted(d for d in os.listdir(tmp_path)
                  if d.startswith(CheckpointConstant.CKPT_NAME_PREFIX))
    assert dirs == ["checkpoint-4", "checkpoint-6"]


def test_no_resume_ignores_an_existing_checkpoint(tmp_path):
    _port_trainer(tmp_path, 2, save_steps=2).train()
    fresh = _port_trainer(tmp_path, 2, save_steps=0,
                          resume_from_checkpoint=False)
    result = fresh.train()
    assert result["steps"] == 2 and len(result["losses"]) == 2
    assert fresh.last_restore_phases == {}


def test_jax_trainer_checkpoint_resumes_the_port_trainer(tmp_path):
    jax_trainer = _jax_trainer(tmp_path, 3, save_steps=3)
    jax_trainer.train()
    _tracked_step(tmp_path, 3)
    want = _flat_bytes(jax.tree.map(np.asarray,
                                    jax_trainer._accel.state.params))
    JaxSaver.reset()
    port = _port_trainer(tmp_path, 3, save_steps=3)
    result = port.train()
    assert port.last_restore_phases["tier"] == "storage"
    assert result["steps"] == 3 and result["losses"] == []
    got = _flat_bytes(params_to_jax(port.model.state_dict()))
    assert got == want


def test_port_trainer_checkpoint_resumes_the_jax_trainer(tmp_path):
    port = _port_trainer(tmp_path, 3, save_steps=3)
    port.train()
    _tracked_step(tmp_path, 3)
    want = _flat_bytes(params_to_jax(port.model.state_dict()))
    AsyncCheckpointSaver.reset()
    jax_trainer = _jax_trainer(tmp_path, 3, save_steps=3)
    result = jax_trainer.train()
    assert result["steps"] == 3
    got = _flat_bytes(jax.tree.map(np.asarray,
                                   jax_trainer._accel.state.params))
    assert got == want
