"""Elastic distributed sampler with mid-epoch checkpoint/restore.

Reference: ``ElasticDistributedSampler``
(``dlrover/trainer/torch/elastic/sampler.py:25``, ``state_dict:118``):
a rank-strided sampler whose ``state_dict`` records the epoch and
consumed batches so a restarted (possibly re-sized) job resumes from
the same position — when the world size changes, the completed sample
count is preserved and the stride changes.

Copy of ``dlrover_tpu/trainer/sampler.py`` (numpy only): its index
streams and ``state_dict`` are the reference's, value for value.
"""

from typing import Dict, Iterator, List, Optional

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas:
            raise ValueError(
                f"rank {rank} >= num_replicas {num_replicas}"
            )
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # samples this rank has already consumed within the epoch
        self.completed_num = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(self.dataset_size)
        return np.arange(self.dataset_size)

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()
        # global offset: completed_num counts per-rank samples, so the
        # global restart position is completed_num * num_replicas
        start = self.completed_num * self.num_replicas
        for i in range(start + self.rank, len(indices), self.num_replicas):
            self.completed_num += 1
            yield int(indices[i])

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_size // self.num_replicas
        return (
            self.dataset_size + self.num_replicas - 1
        ) // self.num_replicas

    # -- checkpoint ---------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        """Reference: sampler.py:118 — records global progress so a
        different world size can resume."""
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num * self.num_replicas,
        }

    def load_state_dict(self, state: Dict[str, int]):
        self.epoch = int(state.get("epoch", 0))
        global_completed = int(state.get("completed_num", 0))
        self.completed_num = global_completed // self.num_replicas
