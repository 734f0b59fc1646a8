"""The sparse slice on the card: ``cuda``-marked, each skipped without a
CUDA device.  The file imports no JAX (the card machine has no flax):
the CPU parity with the JAX package lives in
``tests/test_torch_kv_variable.py``, ``tests/test_torch_paged_shm.py``
and ``tests/test_torch_deepfm.py``; here the card's paths are held
against the port's own CPU paths.

- ``KvVariable.device_gather`` copies a gather to the card from pinned
  memory, bit for bit.
- The paged shm tier takes tensors on the card: it fetches them, skips
  the unchanged one and restores both bit for bit.
- ``SparseTrainPipeline``'s gradient copy on its side stream: with the
  device step held behind a sleep kernel, the host reaches each update
  before the copy is done, and every update still applies the step's
  gradient bit for bit (it waits for the copy's event); the strict
  trajectory on the card matches the strict trajectory on the CPU of
  the same weights (fp32, rtol 1e-4), and the pipelined one trains.
"""

import shutil
import tempfile
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
from dlrover_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from dlrover_tpu_torch.ops.kv_variable import GroupAdamOptimizer, KvVariable
from dlrover_tpu_torch.trainer.sparse_pipeline import (
    SparseTrainPipeline,
    make_deepfm_device_step,
)

pytestmark = pytest.mark.cuda

SMALL = dict(num_sparse_fields=4, num_dense_features=3, embedding_dim=8,
             hidden_dims=(32,), seed=3)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture()
def job(monkeypatch):
    sockets = tempfile.mkdtemp(prefix="dlc")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"cu-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _batches(n, batch=64, vocab=300, seed=0):
    cfg = DeepFMConfig(**SMALL)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sparse = rng.integers(0, vocab, (batch, cfg.num_sparse_fields)
                              ).astype(np.int64)
        dense = rng.normal(size=(batch, cfg.num_dense_features)
                           ).astype(np.float32)
        out.append((sparse, dense, (sparse[:, 0] % 2).astype(np.float32)))
    return out


def _model(device):
    """SMALL's DeepFM on ``device`` with the weights drawn on the CPU
    (one draw for every device)."""
    weights = DeepFM(DeepFMConfig(**SMALL), device="cpu").dense.state_dict()
    model = DeepFM(DeepFMConfig(**SMALL), device=device)
    model.dense.load_state_dict(weights)
    opt = torch.optim.Adam(model.dense.parameters(), lr=1e-2)
    return model, make_deepfm_device_step(model, opt)


def _run(device, data, pipeline):
    model, step = _model(device)
    pipe = SparseTrainPipeline(model.table, model.sparse_optimizer, step,
                               device=device, pipeline=pipeline)
    losses = []
    pipe.run(None, data, on_aux=lambda a: losses.append(a["loss"]))
    return [float(x) for x in losses]


def test_device_gather_copies_from_pinned_memory_to_the_card(cuda):
    table = KvVariable(16, seed=7)
    keys = np.arange(4096, dtype=np.int64).reshape(256, 16)
    got = table.device_gather(keys, cuda)
    assert got.is_cuda and got.shape == (256, 16, 16)
    want = table.gather(keys.reshape(-1), insert_missing=False,
                        count_freq=False)
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_a_paged_save_of_tensors_on_the_card(cuda, job, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("DLROVER_SHM_PAGED", "1")
    table = KvVariable(4, seed=7, name="emb")
    opt = GroupAdamOptimizer(table)
    keys = np.arange(500, dtype=np.int64)
    opt.apply_gradients(keys, np.tanh(table.gather(keys)) * 0.1)
    adapter = SparseStateAdapter().register_optimizer(opt)
    engine = CheckpointEngine(str(tmp_path / "ckpt"), replicated=True,
                              local_rank=0, global_rank=0, world_size=1)
    engine.register_sparse(adapter)
    gen = torch.Generator(device=cuda).manual_seed(0)
    dense = {"w": torch.randn(1 << 20, generator=gen, device=cuda),
             "frozen": torch.arange(4096, device=cuda)}
    assert engine.save_to_memory(1, dense)
    dense["w"].mul_(2.0)
    assert engine.save_to_memory(2, dense)
    assert engine.last_save_phases["kind"] == "delta"
    assert engine.last_save_phases["bytes_skipped"] == 4096 * 8
    step, state = engine.load()
    assert step == 2
    assert torch.equal(state["w"], dense["w"].cpu())
    assert torch.equal(state["frozen"], dense["frozen"].cpu())
    engine.close()


def test_pipelined_gradients_on_the_card_come_back_whole(cuda):
    data = _batches(5) * 2
    model, inner = _model(cuda)
    got, applied = [], []

    def slow_step(state, emb, dense_x, labels):
        torch.cuda._sleep(20_000_000)
        state, egrads, aux = inner(state, emb, dense_x, labels)
        got.append(egrads.detach().clone())
        return state, egrads, aux

    orig = model.sparse_optimizer.apply_gradients

    def spy(keys, grads):
        applied.append(np.array(grads, copy=True))
        return orig(keys, grads)

    model.sparse_optimizer.apply_gradients = spy
    pipe = SparseTrainPipeline(model.table, model.sparse_optimizer,
                               slow_step, device=cuda, pipeline=True,
                               timing=True)
    pipe.run(None, data)
    assert len(applied) == len(got) == 10
    for a, g in zip(applied, got):
        assert a.tobytes() == g.reshape(a.shape).cpu().numpy().tobytes()
    rep = pipe.overlap_report()
    assert rep["device_s"] > 0 and rep["d2h_device_s"] > 0


def test_strict_on_the_card_matches_the_cpu_and_pipelined_trains(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _batches(5) * 4
    on_card = _run(cuda, data, False)
    on_cpu = _run("cpu", data, False)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4)
    piped = _run(cuda, data * 2, True)
    assert np.isfinite(piped).all()
    assert np.mean(piped[-5:]) < 0.6 * np.mean(piped[:5])
