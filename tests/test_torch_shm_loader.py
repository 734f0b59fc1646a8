"""Twins of ``tests/test_shm_loader.py`` for the port's shm loader, and
the two packages' loaders held against each other.

The port's ``ShmDataLoader`` places each batch on its ``device`` as
torch tensors (the GPU unless told otherwise; ``"cpu"`` here, where the
reference's ``test_shm_loader_places_on_mesh`` has its mesh).  Both
packages' loaders read the same samples in spawned workers from one
seeded numpy read function; their batches are compared byte for byte,
in order.  The page-locked route (``cudaHostRegister`` of each slot
ring, the copy on a side stream, a slot freed when its copy's event has
completed, a refused registration that stops the loader) needs a card:
its tests are marked ``cuda``.  Every check is exact.
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.trainer.shm_loader import ShmDataLoader


def _read_sample(i: int):
    rng = np.random.default_rng(i)
    return {
        "x": rng.standard_normal(16).astype(np.float32),
        "y": np.int32(i),
    }


def _read_sample_failing_late(i: int):
    if i >= 2:
        raise IOError("disk on fire")
    return _read_sample(i)


def _read_sample_jittered(i: int):
    # early indices are SLOW: with 2 workers, batch 1 finishes before
    # batch 0 unless the parent reorders results by batch id
    import time as _time

    _time.sleep(0.2 if i < 4 else 0.0)
    return _read_sample(i)


def _read_mixed(i: int):
    sample = _read_sample(i)
    sample["tokens"] = np.random.default_rng(i).integers(
        0, 50257, 129).astype(np.int32)
    return sample


def test_shm_loader_cross_process_exactly_once():
    """2 spawned workers, 8 batches: every sample delivered exactly
    once with correct content through the shm slots."""
    N, B = 32, 4
    loader = ShmDataLoader(
        read_fn=_read_sample, batch_size=B, index_iter=range(N),
        num_workers=2, device="cpu",
    )
    try:
        seen = {}
        for batch in loader:
            assert set(batch) == {"x", "y"}
            assert batch["x"].shape == (B, 16)
            for row in range(B):
                i = int(batch["y"][row])
                assert i not in seen, "duplicate sample"
                seen[i] = batch["x"][row].numpy().copy()
        assert sorted(seen) == list(range(N))
        for i, x in seen.items():
            np.testing.assert_array_equal(x, _read_sample(i)["x"])
        stats = loader.stats()
        assert stats["batches"] == N // B
        assert stats["input_wait_s"] >= 0.0
        assert stats["route"] == "cpu"
    finally:
        loader.shutdown()


def test_shm_loader_places_on_mesh():
    """The port has no mesh here: batches land on the loader's device
    as torch tensors of the samples' dtypes, copies that no later slot
    write can reach (every batch is kept, then checked)."""
    loader = ShmDataLoader(
        read_fn=_read_sample, batch_size=8, index_iter=range(32),
        num_workers=1, slots_per_worker=2, device="cpu",
    )
    try:
        batches = list(loader)
        assert len(batches) == 4
        for k, b in enumerate(batches):
            assert isinstance(b["x"], torch.Tensor)
            assert b["x"].device == torch.device("cpu")
            assert b["x"].dtype == torch.float32
            assert b["y"].dtype == torch.int32
            assert b["y"].tolist() == list(range(8 * k, 8 * k + 8))
            np.testing.assert_array_equal(
                b["x"].numpy(),
                np.stack([_read_sample(i)["x"]
                          for i in range(8 * k, 8 * k + 8)]))
    finally:
        loader.shutdown()


def test_shm_loader_worker_error_surfaces():
    # fails only past the sizing probe, so the error comes from a
    # WORKER process and must propagate to the training loop
    loader = ShmDataLoader(
        read_fn=_read_sample_failing_late, batch_size=2,
        index_iter=range(6), num_workers=1, device="cpu",
    )
    with pytest.raises(RuntimeError, match="disk on fire"):
        list(loader)
    loader.shutdown()


def test_shm_loader_reports_batch_done():
    done = []
    loader = ShmDataLoader(
        read_fn=_read_sample, batch_size=4, index_iter=range(8),
        num_workers=1, on_batch_done=done.append, device="cpu",
    )
    try:
        list(loader)
        assert done == [4, 4]
    finally:
        loader.shutdown()


@pytest.mark.parametrize("n, acks", [(10, [4, 4, 2]), (3, [3])])
def test_shm_loader_acks_what_each_batch_holds(n, acks):
    """A short final batch, and a short probe batch (the sizing batch
    built in-process), are acked with their own sample counts, not the
    batch size."""
    done = []
    loader = ShmDataLoader(
        read_fn=_read_sample, batch_size=4, index_iter=range(n),
        num_workers=1, on_batch_done=done.append, device="cpu",
    )
    try:
        batches = list(loader)
        assert done == acks
        assert [len(b["y"]) for b in batches] == acks
    finally:
        loader.shutdown()


def test_shm_loader_delivers_in_order():
    """Batches arrive in batch-id order regardless of worker
    completion order."""
    loader = ShmDataLoader(
        read_fn=_read_sample_jittered, batch_size=4,
        index_iter=range(16), num_workers=2, device="cpu",
    )
    try:
        order = [int(batch["y"][0]) for batch in loader]
        assert order == [0, 4, 8, 12], order
    finally:
        loader.shutdown()


def test_batches_match_the_jax_loader_byte_for_byte():
    """The same read function and indices through both packages'
    loaders, two workers each: the same batches, byte for byte, in the
    same order (token rows as the shm example reads them, beside float
    and scalar fields)."""
    from dlrover_tpu.trainer.shm_loader import ShmDataLoader as JaxLoader

    n, b = 24, 4
    want = JaxLoader(read_fn=_read_mixed, batch_size=b,
                     index_iter=range(n), num_workers=2)
    got = ShmDataLoader(read_fn=_read_mixed, batch_size=b,
                        index_iter=range(n), num_workers=2, device="cpu")
    try:
        ref = [{k: np.asarray(v) for k, v in x.items()} for x in want]
        out = list(got)
    finally:
        want.shutdown()
        got.shutdown()
    assert len(out) == len(ref) == n // b
    for r, o in zip(ref, out):
        assert set(r) == set(o) == {"tokens", "x", "y"}
        for k in sorted(r):
            t = o[k].numpy()
            assert r[k].dtype == t.dtype and r[k].shape == t.shape
            assert r[k].tobytes() == t.tobytes()


def test_shm_loader_refuses_the_cpu_unasked(monkeypatch):
    """No device named and no GPU: the loader raises instead of quietly
    placing batches on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShmDataLoader(read_fn=_read_sample, batch_size=2,
                      index_iter=range(4))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_registered_slots_feed_the_card(cuda):
    """On the card each worker's slot ring is page-locked once and every
    batch is a DMA out of its slot: the route is ``registered`` and the
    batches equal the samples, slots recycled many times over (2
    workers x 3 slots, 16 batches)."""
    loader = ShmDataLoader(read_fn=_read_sample, batch_size=4,
                           index_iter=range(64), num_workers=2,
                           device=cuda)
    try:
        batches = [{k: v.cpu() for k, v in b.items()} for b in loader]
        assert loader.stats()["route"] == "registered"
    finally:
        loader.shutdown()
    for k, b in enumerate(batches):
        assert b["y"].tolist() == list(range(4 * k, 4 * k + 4))
        np.testing.assert_array_equal(
            b["x"].numpy(),
            np.stack([_read_sample(i)["x"] for i in range(4 * k, 4 * k + 4)]))


class _RefusingCudart:
    """``torch.cuda.cudart()`` whose ``cudaHostRegister`` fails."""

    def __init__(self, real):
        self._real = real

    def cudaHostRegister(self, ptr, size, flags):
        return 1  # cudaErrorInvalidValue

    def __getattr__(self, name):
        return getattr(self._real, name)


@pytest.mark.cuda
def test_a_refused_registration_stops_the_loader(cuda, monkeypatch):
    """No slower route stands in when CUDA refuses to page-lock a slot
    ring: the loader raises naming the error, and its workers and
    segments are gone."""
    real = torch.cuda.cudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: _RefusingCudart(real))
    loader = ShmDataLoader(read_fn=_read_sample, batch_size=4,
                           index_iter=range(16), num_workers=2, device=cuda)
    with pytest.raises(RuntimeError, match="cudaHostRegister .* failed: 1"):
        next(iter(loader))
    assert not loader._procs and not loader._shms
