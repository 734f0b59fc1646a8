"""Twins of ``tests/test_elastic_dataset.py`` and the sharding cases of
``tests/test_agent.py`` for the port's data side, and the two
packages held against each other.

The twins run the port's ``ElasticDataset``/``ElasticDataLoader`` and
``IndexShardingClient`` against the port's in-process master; the
loader places its batches on the device it is given (``"cpu"`` here,
where the reference has its mesh) and keeps ``set_batch_size`` between
steps.  Held against the JAX package, exactly:

- each package's ``IndexShardingClient`` against its own master, with
  the same dataset (shuffled and not), gives the same index stream,
  and after the same consumption the same ``get_checkpoint()`` string;
- a checkpoint string taken in one package and restored in the other
  gives the same remaining stream as the package that took it.

The port's loader acks the samples of the batch it yielded, where the
reference acks ``batch_size``, which a ``set_batch_size`` between the
batch's collation and its ack makes wrong (a shard is then never acked
and the epoch's tail waits on it).
"""

import json

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.sharding_client import IndexShardingClient
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.trainer.dataset import (
    DevicePlacer,
    ElasticDataLoader,
    ElasticDataset,
)


@pytest.fixture()
def master():
    m = JobMaster(port=0, node_num=1, job_name="ds-test")
    m.prepare()
    yield m
    m.stop()


@pytest.fixture()
def client(master):
    c = MasterClient(f"127.0.0.1:{master.port}", node_id=0,
                     node_type="worker")
    yield c
    c.close()


def _dataset(client, name, size=32, batch=4):
    sc = IndexShardingClient(
        dataset_name=name, batch_size=batch, num_epochs=1,
        dataset_size=size, master_client=client,
    )
    data = np.arange(size * 3, dtype=np.float32).reshape(size, 3)
    return ElasticDataset(
        dataset_name=name, dataset_size=size, batch_size=batch,
        read_fn=lambda i: {"x": data[i], "idx": np.int32(i)},
        sharding_client=sc,
    )


def test_dataset_yields_all_samples(client):
    ds = _dataset(client, "d1")
    seen = []
    for s in ds:
        seen.append(int(s["idx"]))
        ds.report_batch_done(1)  # ack so the master releases shards
    assert sorted(seen) == list(range(32))


def test_dataloader_batches_and_acks(client):
    ds = _dataset(client, "d2")
    loader = ElasticDataLoader(ds, batch_size=4, device="cpu")
    batches = list(loader)
    assert len(batches) == 8
    assert batches[0]["x"].shape == (4, 3)
    all_idx = sorted(int(i) for b in batches for i in b["idx"])
    assert all_idx == list(range(32))


def test_dataloader_places_on_mesh(client):
    """The port's twin places on the loader's device: torch tensors of
    the samples' dtypes, copies of the collated batch; the batch size
    follows ``set_batch_size`` between steps."""
    ds = _dataset(client, "d3", size=48, batch=8)
    loader = ElasticDataLoader(ds, device="cpu")
    it = iter(loader)
    batch = next(it)
    assert isinstance(batch["x"], torch.Tensor)
    assert batch["x"].device == torch.device("cpu")
    assert batch["x"].dtype == torch.float32 and batch["x"].shape == (8, 3)
    assert batch["idx"].dtype == torch.int32
    # batches collated before the change keep their size (the loader
    # prefetches two); every later one has the new size
    loader.set_batch_size(4)
    sizes = [8] + [b["x"].shape[0] for b in it]
    assert sum(sizes) == 48 and sizes[-2:] == [4, 4], sizes


def test_dataset_checkpoint_roundtrip(client):
    ds = _dataset(client, "d4", size=16, batch=4)
    it = iter(ds)
    for _ in range(4):
        next(it)
    ds.report_batch_done(4)
    content = ds.checkpoint()
    assert content
    ds.restore_checkpoint(content)


def test_loader_refuses_the_cpu_unasked(monkeypatch, client):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePlacer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticDataLoader(_dataset(client, "d5"))


# -- the two packages against each other -------------------------------


class _Side:
    """One package's master and index client over one dataset."""

    def __init__(self, pkg, name, size, batch, shuffle):
        if pkg == "jax":
            from dlrover_tpu.agent.master_client import MasterClient as MC
            from dlrover_tpu.agent.sharding_client import (
                IndexShardingClient as ISC,
            )
            from dlrover_tpu.master.master import JobMaster as JM
        else:
            MC, ISC, JM = MasterClient, IndexShardingClient, JobMaster
        self.master = JM(port=0, node_num=1, job_name=f"parity-{pkg}")
        self.master.prepare()
        self.client = MC(f"127.0.0.1:{self.master.port}", node_id=0,
                         node_type="worker")
        self._isc_cls = ISC
        self.args = dict(dataset_name=name, batch_size=batch, num_epochs=1,
                         dataset_size=size, shuffle=shuffle,
                         storage_type="text", master_client=self.client)
        self.isc = ISC(**self.args)

    def take(self, batches: int):
        """The next ``batches`` batches' indices, each acked after."""
        out = []
        for _ in range(batches):
            got = []
            for _ in range(self.args["batch_size"]):
                idx = self.isc.fetch_sample_index(timeout=30)
                if idx is None:
                    break
                got.append(idx)
            if not got:
                break
            self.isc.report_batch_done(len(got))
            out.append(got)
        return out

    def restore(self, content: str):
        """Restore ``content`` into the master, then a fresh index client
        (whose prefetch starts from the restored position)."""
        self.isc.stop()
        self.client.restore_dataset_checkpoint(
            self.args["dataset_name"], content)
        self.isc = self._isc_cls(**self.args)

    def close(self):
        self.isc.stop()
        self.client.close()
        self.master.stop()


@pytest.mark.parametrize("shuffle", [False, True])
def test_index_streams_and_checkpoints_match_jax(shuffle):
    """Shards of 2 batches (8 samples); the checkpoint is taken after 4
    batches, at a shard boundary.  A shuffled dataset's restore replays
    shard positions, not the shuffled sample indices, in both packages
    (ROADMAP §C 7)."""
    size, batch = 48, 4
    sides = {p: _Side(p, "parity-ds", size, batch, shuffle)
             for p in ("jax", "torch")}
    try:
        head = {p: s.take(4) for p, s in sides.items()}
        assert head["jax"] == head["torch"]
        flat = sum(head["jax"], [])
        assert (sorted(flat) != flat) == shuffle
        ckpt = {p: s.isc.get_checkpoint() for p, s in sides.items()}
        assert ckpt["jax"] == ckpt["torch"]
        state = json.loads(ckpt["torch"])
        assert state["dataset"] == "parity-ds"
        assert [tuple(t) for t in state["todo"]] == [
            (i, i + 8) for i in range(16, size, 8)]
        rest = {p: s.take(100) for p, s in sides.items()}
        assert rest["jax"] == rest["torch"]
        assert sorted(flat + sum(rest["jax"], [])) == list(range(size))
        # each package restores the other's string and replays the rest
        sides["jax"].restore(ckpt["torch"])
        sides["torch"].restore(ckpt["jax"])
        replay = {p: s.take(100) for p, s in sides.items()}
        assert replay["jax"] == replay["torch"]
        positions = [list(range(i, i + batch)) for i in range(16, size, batch)]
        assert replay["torch"] == positions
        assert (replay["torch"] == rest["torch"]) != shuffle
    finally:
        for s in sides.values():
            s.close()
