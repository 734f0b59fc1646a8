"""DeepFM and the split-step pipeline of the PyTorch port against the
JAX package.

The JAX package's dense params are drawn by its own ``init_dense_params``
and loaded into the port's tower (``utils.convert.deepfm_dense_from_jax``);
the embedding tables of both packages start bit-equal (one C++ store,
the same seed).  The same numpy batches, made from a seed, then go
through both:

- ``loss_and_grads``: the loss, every dense gradient and the embedding
  gradients agree within a relative norm of 1e-5 (fp32; the required
  bound is 1e-4), at a small width and at the reference's
  default width (26 fields x 16, tower 429-128-64-1);
- ``SparseTrainPipeline`` trajectories: 20 steps, strict and
  pipelined, with GroupAdam on the host and Adam on the tower (the
  port's ``torch.optim.Adam`` against ``optax.adam``, the same
  formula): every loss within a relative 1e-4 of the JAX package's
  trajectory in the same mode, and the final tables within 1e-4 of its
  rows;
- staleness: the pipelined gather of step k+1 sees updates through k-1,
  the strict one through k; ``auto`` commits to a mode and applies every
  update; the table checkpoint pickles cross the packages.

The pinned, side-stream gradient copy of the pipeline on the card is
held in ``tests/test_torch_sparse_cuda.py`` (a file that imports no JAX:
the card machine has no flax).
"""

import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.common.storage import PosixDiskStorage as JaxStorage
from dlrover_tpu.models.deepfm import DeepFM as JaxDeepFM
from dlrover_tpu.models.deepfm import DeepFMConfig as JaxConfig
from dlrover_tpu.trainer import sparse_pipeline as jax_pipe
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from dlrover_tpu_torch.trainer.sparse_pipeline import (
    SparseTrainPipeline,
    make_deepfm_device_step,
)
from dlrover_tpu_torch.utils.convert import deepfm_dense_from_jax

SMALL = dict(num_sparse_fields=4, num_dense_features=3, embedding_dim=8,
             hidden_dims=(32,), seed=3)
DEFAULT = dict(seed=3)
REL = 1e-5
TRAJ_RTOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _pair(cfg, device="cpu"):
    """The JAX package's model and params, and the port's model with
    those params loaded."""
    jm = JaxDeepFM(JaxConfig(**cfg))
    params = jm.init_dense_params()
    tm = DeepFM(DeepFMConfig(**cfg), device=device)
    deepfm_dense_from_jax(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}, tm.dense)
    return jm, params, tm


def _batches(cfg, n, batch=64, vocab=300, seed=0):
    c = DeepFMConfig(**cfg)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sparse = rng.integers(0, vocab, (batch, c.num_sparse_fields)
                              ).astype(np.int64)
        dense = rng.normal(size=(batch, c.num_dense_features)
                           ).astype(np.float32)
        labels = (sparse[:, 0] % 2).astype(np.float32)
        out.append((sparse, dense, labels))
    return out


def test_the_tower_loads_the_jax_params_exactly():
    jm, params, tm = _pair(SMALL)
    own = dict(tm.dense.named_parameters())
    for layer, leaves in params.items():
        for name, value in leaves.items():
            port = own[f"{layer}.{ {'w': 'weight', 'b': 'bias'}[name]}"]
            assert port.detach().numpy().tobytes() == \
                np.asarray(value).tobytes()


@pytest.mark.parametrize("cfg", [SMALL, DEFAULT], ids=["small", "default"])
def test_loss_and_gradients_match(cfg):
    jm, params, tm = _pair(cfg)
    sparse, dense, labels = _batches(cfg, 1, batch=48)[0]
    lj, gj, ej = jm.loss_and_grads(params, sparse, dense, labels)
    lt, gt, et = tm.loss_and_grads(sparse, dense, labels)
    assert abs(float(lj) - float(lt)) <= REL * abs(float(lj))
    assert _rel(ej, et) <= REL
    for layer, leaves in gj.items():
        for name, g in leaves.items():
            port = {"w": "weight", "b": "bias"}[name]
            assert _rel(g, gt[f"{layer}.{port}"].numpy()) <= REL, layer


def test_training_reduces_loss_and_leaves_untouched_keys():
    cfg = SMALL
    _, _, tm = _pair(cfg)
    probe = np.array([99_999], dtype=np.int64)
    before = tm.table.gather(probe).copy()
    opt = torch.optim.Adam(tm.dense.parameters(), lr=1e-2)
    sparse, dense, labels = _batches(cfg, 1)[0]
    losses = []
    for _ in range(60):
        loss, dgrads, egrads = tm.loss_and_grads(sparse, dense, labels)
        losses.append(float(loss))
        for name, p in tm.dense.named_parameters():
            p.grad = dgrads[name]
        opt.step()
        tm.apply_sparse_gradients(sparse, egrads)
    assert losses[-1] < 0.6 * losses[0]
    after = tm.table.gather(probe, insert_missing=False, count_freq=False)
    np.testing.assert_array_equal(before, after)


def test_table_checkpoint_pickles_cross_the_packages(tmp_path):
    jm, _, tm = _pair(SMALL)
    keys = np.arange(50, dtype=np.int64)
    emb = tm.table.gather(keys)
    tm.save_table(PosixDiskStorage(), str(tmp_path / "port.pkl"))
    jm.table.gather(keys)
    jm.save_table(JaxStorage(), str(tmp_path / "jax.pkl"))
    fresh_j = JaxDeepFM(JaxConfig(**dict(SMALL, seed=9)))
    assert fresh_j.load_table(JaxStorage(), str(tmp_path / "port.pkl"))
    fresh_t = DeepFM(DeepFMConfig(**dict(SMALL, seed=9)), device="cpu")
    assert fresh_t.load_table(PosixDiskStorage(), str(tmp_path / "jax.pkl"))
    for t in (fresh_j.table, fresh_t.table):
        got = t.gather(keys, insert_missing=False, count_freq=False)
        assert got.tobytes() == emb.tobytes()


def _run_jax(cfg, data, pipeline):
    jm, params, _ = _pair(cfg)
    opt = optax.adam(1e-2)
    step = jax_pipe.make_deepfm_device_step(jm, opt)
    pipe = jax_pipe.SparseTrainPipeline(jm.table, jm.sparse_optimizer,
                                        step, pipeline=pipeline)
    losses = []
    pipe.run((params, opt.init(params)), data,
             on_aux=lambda a: losses.append(float(a["loss"])))
    return losses, jm.table


def _run_port(cfg, data, pipeline, device="cpu"):
    _, _, tm = _pair(cfg, device=device)
    opt = torch.optim.Adam(tm.dense.parameters(), lr=1e-2,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_deepfm_device_step(tm, opt)
    pipe = SparseTrainPipeline(tm.table, tm.sparse_optimizer, step,
                               device=device, pipeline=pipeline)
    losses = []
    pipe.run(None, data, on_aux=lambda a: losses.append(a["loss"]))
    return [float(x) for x in losses], tm.table, pipe


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["strict", "pipelined"])
def test_pipeline_trajectories_match_the_jax_package(pipeline):
    data = _batches(SMALL, 5) * 4
    lj, tj = _run_jax(SMALL, data, pipeline)
    lt, tt, pipe = _run_port(SMALL, data, pipeline)
    assert len(lt) == len(lj) == 20
    np.testing.assert_allclose(lt, lj, rtol=TRAJ_RTOL)
    assert lt[-1] < 0.8 * lt[0]
    kj, vj, fj = tj.export()
    kt, vt, ft = tt.export()
    oj, ot = np.argsort(kj), np.argsort(kt)
    np.testing.assert_array_equal(kj[oj], kt[ot])
    np.testing.assert_array_equal(fj[oj], ft[ot])
    assert _rel(vj[oj], vt[ot]) <= TRAJ_RTOL
    rep = pipe.overlap_report()
    assert rep["steps"] == 20 and rep["gather_s"] > 0
    assert rep["mode"] == ("pipelined" if pipeline else "strict")


def test_staleness_is_one_in_the_pipelined_mode():
    cfg = dict(num_sparse_fields=1, num_dense_features=1,
               embedding_dim=4, hidden_dims=(4,))
    for pipeline, expect in ((False, [0, 1, 2, 3]), (True, [0, 0, 1, 2])):
        tm = DeepFM(DeepFMConfig(**cfg), device="cpu")
        opt = torch.optim.Adam(tm.dense.parameters(), lr=1e-2)
        seen = []
        orig = tm.table.gather

        def spy(keys, *a, _o=orig, **kw):
            seen.append(tm.sparse_optimizer.step)
            return _o(keys, *a, **kw)

        tm.table.gather = spy
        pipe = SparseTrainPipeline(tm.table, tm.sparse_optimizer,
                                   make_deepfm_device_step(tm, opt),
                                   device="cpu", pipeline=pipeline)
        batch = (np.zeros((8, 1), np.int64), np.zeros((8, 1), np.float32),
                 np.ones(8, np.float32))
        pipe.run(None, [batch] * 4)
        assert seen == expect, (pipeline, seen)
        assert tm.sparse_optimizer.step == 4


def test_auto_mode_decides_and_applies_every_update():
    data = _batches(SMALL, 5) * 4
    _, tt, pipe = _run_port(SMALL, data, "auto")
    assert pipe.chosen_mode in ("pipelined", "strict")
    rep = pipe.overlap_report()
    assert rep["mode"] == pipe.chosen_mode and rep["steps"] == 20
    assert pipe.sparse_optimizer.step == 20


def test_the_tower_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepFM(DeepFMConfig(**SMALL))


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
