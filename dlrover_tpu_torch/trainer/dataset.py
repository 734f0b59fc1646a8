"""Elastic dataset + device-feeding loader.

Reference: ``ElasticDataset`` (``atorch/data/elastic_dataset.py:19``)
— a dataset whose sample indices come from the master's dynamic
sharding service, so a resized/restarted job never re-reads completed
shards — and ``ElasticDataLoader`` (``dlrover/trainer/torch/elastic/
dataloader.py:26``) whose batch size follows the runtime parallelism
config.

Copy of ``dlrover_tpu/trainer/dataset.py``.  The reference's loader
assembles numpy batches and ``device_put``s them with the mesh's batch
sharding, with a one-batch prefetch so host assembly overlaps device
compute.  Here :class:`DevicePlacer` does the placing, and the shm and
coworker loaders share it: the collated numpy batch is copied into
pinned host memory, then to the loader's ``device`` with
``non_blocking=True`` on a side stream, and the consumer's stream
waits on the copy's event before it uses the batch.  The device is the
GPU unless the caller names another (the tests pass ``"cpu"``); with no
GPU and no explicit device the loader raises.
"""

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np

from dlrover_tpu_torch.agent.sharding_client import IndexShardingClient
from dlrover_tpu_torch.common.log import default_logger as logger


class DevicePlacer:
    """Places collated numpy batches (a dict of arrays or one array) on
    ``device`` as torch tensors.

    On a CUDA device each array is copied into a pinned host buffer (a
    CPU copy that never aliases the caller's memory, so an shm slot is
    free again once :meth:`place` returns unless ``src_pinned``), then
    to the device with ``non_blocking=True`` on the placer's side
    stream; an event recorded after the copies is what the consumer's
    stream waits on (:meth:`place` does that wait on the current stream
    before it returns), and :meth:`place` also returns it so a caller
    that recycles the source can wait for the copy to have read it.
    On the CPU the arrays are copied (never aliased) into tensors.
    """

    def __init__(self, device=None):
        import torch

        from dlrover_tpu_torch.common.device import resolve_device

        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (
            torch.cuda.Stream(device=self.device) if self._cuda else None
        )

    def place(self, batch, src_pinned: bool = False):
        """``(placed batch, copy event or None)``.  With ``src_pinned``
        the arrays already lie in page-locked memory (an shm slot
        registered with ``cudaHostRegister``): the copy is a DMA
        straight out of them, and the source must stay untouched until
        the returned event has completed."""
        import torch

        if not self._cuda:
            return _map_batch(
                batch, lambda a: torch.from_numpy(np.array(a))
            ), None
        with torch.cuda.stream(self._stream):
            def copy(a):
                src = torch.from_numpy(np.ascontiguousarray(a))
                if not src_pinned:
                    src = src.pin_memory()
                # PyTorch's caching host allocator keeps the pinned
                # staging block until this copy has read it
                return src.to(self.device, non_blocking=True)

            placed = _map_batch(batch, copy)
            event = torch.cuda.Event()
            event.record(self._stream)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        # the caching allocator frees a tensor for the stream it was
        # made on: mark the consumer's use so a freed batch is not
        # reused by the side stream while the consumer still reads it
        _map_batch(placed, lambda t: t.record_stream(consumer))
        return placed, event


def _map_batch(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


class ElasticDataset:
    """Map-style dataset over master-assigned sample indices.

    Subclass and implement ``read_sample(index)`` (reference API
    parity: elastic_dataset.py ``ElasticDataset.read_sample``), or
    pass ``read_fn``.
    """

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        batch_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        read_fn: Optional[Callable[[int], Any]] = None,
        sharding_client: Optional[IndexShardingClient] = None,
    ):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self._read_fn = read_fn
        self._client = sharding_client or IndexShardingClient(
            dataset_name=dataset_name,
            batch_size=batch_size,
            num_epochs=num_epochs,
            dataset_size=dataset_size,
            shuffle=shuffle,
        )

    def read_sample(self, index: int):
        if self._read_fn is None:
            raise NotImplementedError(
                "implement read_sample or pass read_fn"
            )
        return self._read_fn(index)

    def __len__(self) -> int:
        return self.dataset_size

    def __iter__(self) -> Iterator[Any]:
        while True:
            idx = self._client.fetch_sample_index()
            if idx is None:
                return
            yield self.read_sample(idx)

    def report_batch_done(self, batch_size: Optional[int] = None):
        self._client.report_batch_done(batch_size)

    def checkpoint(self) -> str:
        return self._client.get_checkpoint()

    def restore_checkpoint(self, content: str):
        self._client.restore_checkpoint(content)


class ElasticDataLoader:
    """Batches an ElasticDataset and feeds the device: torch tensors on
    ``device`` (the GPU unless another is named)."""

    def __init__(
        self,
        dataset: ElasticDataset,
        batch_size: Optional[int] = None,
        collate_fn: Optional[Callable] = None,
        device=None,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size or dataset.batch_size
        self._collate = collate_fn or default_collate
        self._placer = DevicePlacer(device)
        self._prefetch = prefetch
        self._drop_last = drop_last

    def set_batch_size(self, batch_size: int):
        """Runtime-tunable batch size (reference: ElasticDataLoader
        reloading from the paral-config file)."""
        self.batch_size = batch_size

    def _place(self, batch):
        return self._placer.place(batch)[0]

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        DONE = object()

        def producer():
            samples = []
            try:
                for sample in self.dataset:
                    samples.append(sample)
                    if len(samples) >= self.batch_size:
                        q.put((len(samples), self._collate(samples)))
                        samples = []
                if samples and not self._drop_last:
                    q.put((len(samples), self._collate(samples)))
            except Exception as e:  # noqa: BLE001
                logger.error("dataloader producer failed: %s", e)
            finally:
                q.put(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is DONE:
                return
            n, batch = item
            yield self._place(batch)
            # the samples of the batch just trained (the reference acks
            # ``self.batch_size``, which a ``set_batch_size`` between
            # the batch's collation and this ack makes wrong)
            self.dataset.report_batch_done(n)


def default_collate(samples):
    """Stack dict-of-arrays or array samples into numpy batches (the
    default of every loader of the port)."""
    first = samples[0]
    if isinstance(first, dict):
        return {
            k: np.stack([np.asarray(s[k]) for s in samples])
            for k in first
        }
    return np.stack([np.asarray(s) for s in samples])
