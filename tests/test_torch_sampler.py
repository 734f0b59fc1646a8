"""Twins of the sampler cases of ``tests/test_parallel_models.py`` for
the port's ``ElasticDistributedSampler``, and the two packages held
against each other: the same index streams, and a ``state_dict`` taken
at world 4 and loaded at world 3 (and back) gives the same resumed
streams and states in both packages.  Every check is exact."""

import numpy as np
import pytest

from dlrover_tpu.trainer.sampler import (
    ElasticDistributedSampler as JaxSampler,
)
from dlrover_tpu_torch.trainer import ElasticDistributedSampler


def test_sampler_strided_and_resumable():
    indices = list(ElasticDistributedSampler(
        20, num_replicas=2, rank=0, shuffle=False))
    assert indices == list(range(0, 20, 2))

    # consume 3, checkpoint, resume with a DIFFERENT world size
    s2 = ElasticDistributedSampler(20, num_replicas=2, rank=1,
                                   shuffle=False)
    it = iter(s2)
    for _ in range(3):
        next(it)
    state = s2.state_dict()
    s4 = ElasticDistributedSampler(20, num_replicas=4, rank=0,
                                   shuffle=False)
    s4.load_state_dict(state)
    resumed = list(s4)
    # 6 samples consumed globally (3 per each of 2 old ranks is 3*2);
    # new rank 0 of 4 starts at global position 4 (6//4*4) + rank
    assert resumed[0] >= 4


def test_sampler_shuffle_deterministic_per_epoch():
    a = list(ElasticDistributedSampler(16, 2, 0, shuffle=True, seed=3))
    b = list(ElasticDistributedSampler(16, 2, 0, shuffle=True, seed=3))
    assert a == b
    s = ElasticDistributedSampler(16, 2, 0, shuffle=True, seed=3)
    s.set_epoch(1)
    c = list(s)
    assert c != a


def _consume(cls, size, world, shuffle, seed, epoch, steps, state=None):
    """Each rank of ``world`` takes ``steps`` indices (after loading
    ``state``); returns the indices and every rank's state_dict."""
    taken, states = [], []
    for rank in range(world):
        s = cls(size, num_replicas=world, rank=rank, shuffle=shuffle,
                seed=seed)
        s.set_epoch(epoch)
        if state is not None:
            s.load_state_dict(state)
        it = iter(s)
        taken.append([next(it) for _ in range(steps)])
        states.append(s.state_dict())
    return taken, states


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("worlds", [(4, 3), (3, 4)])
def test_state_dict_across_world_sizes_matches_jax(shuffle, worlds):
    """A seeded dataset size and consumption; the state of rank 0 at the
    first world size resumes every rank of the second, in both
    packages: the same indices, the same states, the same lengths."""
    rng = np.random.default_rng(7)
    size = int(rng.integers(60, 120))
    steps = int(rng.integers(3, 9))
    seed, epoch = int(rng.integers(0, 100)), 2
    first, second = worlds
    got, want = {}, {}
    for name, cls, out in (("torch", ElasticDistributedSampler, got),
                           ("jax", JaxSampler, want)):
        taken, states = _consume(cls, size, first, shuffle, seed, epoch,
                                 steps)
        resumed, after = _consume(cls, size, second, shuffle, seed, epoch,
                                  2, state=states[0])
        lengths = [len(cls(size, second, r, shuffle=shuffle))
                   for r in range(second)]
        out.update(taken=taken, states=states, resumed=resumed,
                   after=after, lengths=lengths)
    assert got == want
    assert got["states"][0] == {"epoch": epoch,
                                "completed_num": steps * first}
    # the global count survives the change of world size: the new ranks
    # start at the old world's global position, rounded down to a
    # multiple of the new world
    start = (steps * first // second) * second
    order = (np.random.default_rng(seed + epoch).permutation(size)
             if shuffle else np.arange(size))
    assert [r[0] for r in got["resumed"]] == [
        int(order[start + r]) for r in range(second)]
