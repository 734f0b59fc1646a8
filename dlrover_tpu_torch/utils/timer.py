"""Named timers for step phases.

Copy of ``dlrover_tpu/utils/timer.py`` (reference: atorch/utils/timer.py).
Device-aware: ``stop(block_on=...)`` first waits for the CUDA devices
of the tensors it is given (a tensor, or a nested dict, list or tuple
of them), so a timed region includes the card's work, not just its
launch; the reference blocks on a JAX array the same way.
"""

import time
from contextlib import contextmanager
from typing import Dict, Optional


def block_until_ready(tree):
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    import torch

    from dlrover_tpu_torch.utils.numeric_checker import tree_leaves

    for device in {leaf.device for _, leaf in tree_leaves(tree)
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


class Timer:
    def __init__(self, name: str):
        self.name = name
        self._start: Optional[float] = None
        self.elapsed_total = 0.0
        self.count = 0

    def start(self):
        self._start = time.perf_counter()

    def stop(self, block_on=None):
        if block_on is not None:
            block_until_ready(block_on)
        if self._start is not None:
            self.elapsed_total += time.perf_counter() - self._start
            self.count += 1
            self._start = None

    @property
    def mean(self) -> float:
        return self.elapsed_total / self.count if self.count else 0.0


class Timers:
    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    @contextmanager
    def scope(self, name: str, block_on=None):
        t = self(name)
        t.start()
        try:
            yield t
        finally:
            t.stop(block_on)

    def summary(self) -> Dict[str, float]:
        return {n: t.mean for n, t in self._timers.items()}

    def log(self, logger):
        for name, mean in sorted(self.summary().items()):
            logger.info("timer %-24s mean %.4fs", name, mean)
