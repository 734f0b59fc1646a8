"""Dataset splitters for dynamic data sharding.

Copy of ``dlrover_tpu/master/dataset_splitter.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/shard/dataset_splitter.py``: split a
dataset into index-range shards per epoch, optionally shuffled, so the
master can hand shards to whichever worker asks next and recycle shards
owned by dead workers.  Batch (table/text) and streaming flavours.
"""

import random
from dataclasses import dataclass, field
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class Shard:
    start: int
    end: int
    # optional per-sample indices (shuffled text datasets)
    indices: Optional[List[int]] = None


class DatasetSplitter:
    """Base splitter (reference ``DatasetSplitter:90``)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self.num_epochs = max(1, num_epochs)
        self.epoch = 0
        self._shards: List[Shard] = []

    def create_shards(self):
        raise NotImplementedError

    def get_shards(self) -> List[Shard]:
        return self._shards

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous record-range shards of a table (reference
    ``TableDatasetSplitter:144``)."""

    def create_shards(self):
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(start=start, end=end))
        self._shards = shards
        self.epoch += 1
        logger.info(
            "dataset %s: epoch %d with %d shards",
            self.dataset_name,
            self.epoch,
            len(shards),
        )


class TextDatasetSplitter(DatasetSplitter):
    """Index-list shards with optional global shuffle (reference
    ``TextDatasetSplitter:257``)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.shuffle = shuffle
        self._seed = seed

    def create_shards(self):
        indices = list(range(self.dataset_size))
        if self.shuffle:
            # deterministic per-epoch shuffle so a restored master
            # regenerates identical shards
            rng = random.Random(self._seed + self.epoch)
            rng.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(start=start, end=end, indices=indices[start:end])
            )
        self._shards = shards
        self.epoch += 1


@dataclass
class PartitionOffsets:
    """Consumption offsets of a streaming source (reference
    ``StreamingDatasetSplitter:359``)."""

    offsets: dict = field(default_factory=dict)  # {partition: next_offset}


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded stream: shards are emitted on demand from growing
    partition offsets; ``dataset_size`` < 0 means unbounded."""

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        partition_offsets: Optional[PartitionOffsets] = None,
        max_shard_count: int = 0,
    ):
        super().__init__(dataset_name, -1, shard_size, num_epochs=1)
        self.partition_offsets = partition_offsets or PartitionOffsets(
            offsets={0: 0}
        )
        self._max_shard_count = max_shard_count
        self._emitted = 0

    def create_shards(self):
        shards = []
        for partition, offset in self.partition_offsets.offsets.items():
            if self._max_shard_count and self._emitted >= self._max_shard_count:
                break
            shards.append(Shard(start=offset, end=offset + self.shard_size))
            self.partition_offsets.offsets[partition] = (
                offset + self.shard_size
            )
            self._emitted += 1
        self._shards = shards

    def epoch_finished(self) -> bool:
        return bool(
            self._max_shard_count and self._emitted >= self._max_shard_count
        )


def new_dataset_splitter(
    storage_type: str,
    shuffle: bool,
    batch_size: int,
    dataset_size: int,
    num_epochs: int,
    dataset_name: str,
    num_minibatches_per_shard: int = 2,
) -> DatasetSplitter:
    """Factory (reference ``new_dataset_splitter:325``)."""
    shard_size = max(1, batch_size * num_minibatches_per_shard)
    if storage_type == "table":
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(dataset_name, shard_size)
    return TextDatasetSplitter(
        dataset_name, dataset_size, shard_size, num_epochs, shuffle
    )
