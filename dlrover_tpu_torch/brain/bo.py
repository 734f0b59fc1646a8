"""Gaussian-process Bayesian optimization.

Copy of ``dlrover_tpu/brain/bo.py`` (the strategy search of
:mod:`dlrover_tpu_torch.accel.strategy_search` picks what to dry-run
with it; the rest of ``brain/`` is ported beside it).
Reference capability: ``BayesianOptimizer``
(``dlrover/python/brain/hpsearch/bo.py:30``) — propose hyperparameter
candidates from observed (params, reward) history.  Implementation
here: an RBF-kernel GP posterior with expected-improvement
acquisition, maximized by random multi-start over the box bounds
(pure numpy; no GP library dependency).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Parameter:
    name: str
    low: float
    high: float
    is_int: bool = False

    def clip(self, value: float) -> float:
        v = float(np.clip(value, self.low, self.high))
        return round(v) if self.is_int else v


def _rbf(a: np.ndarray, b: np.ndarray, length: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / length**2)


class BayesianOptimizer:
    """Maximizes a black-box reward over a box domain."""

    def __init__(
        self,
        parameters: Sequence[Parameter],
        length_scale: float = 0.2,
        noise: float = 1e-6,
        explore: float = 0.01,
        seed: int = 0,
    ):
        self.parameters = list(parameters)
        self._length = length_scale
        self._noise = noise
        self._explore = explore
        self._rng = np.random.default_rng(seed)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []

    # normalized [0,1] coordinates internally
    def _to_unit(self, config: Dict[str, float]) -> np.ndarray:
        return np.array(
            [
                (config[p.name] - p.low) / max(p.high - p.low, 1e-12)
                for p in self.parameters
            ]
        )

    def _from_unit(self, u: np.ndarray) -> Dict[str, float]:
        return {
            p.name: p.clip(p.low + u[i] * (p.high - p.low))
            for i, p in enumerate(self.parameters)
        }

    def observe(self, config: Dict[str, float], reward: float):
        self._x.append(self._to_unit(config))
        self._y.append(float(reward))

    def _posterior(
        self, cand: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        x = np.stack(self._x)
        y = np.array(self._y)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std
        k = _rbf(x, x, self._length) + self._noise * np.eye(len(x))
        k_inv = np.linalg.inv(k)
        ks = _rbf(cand, x, self._length)
        mu = ks @ k_inv @ yn
        var = 1.0 - np.einsum("ij,jk,ik->i", ks, k_inv, ks)
        var = np.maximum(var, 1e-12)
        return mu * y_std + y_mean, np.sqrt(var) * y_std

    def suggest(self, n_candidates: int = 1) -> List[Dict[str, float]]:
        """Expected-improvement maximization via random multistart."""
        dim = len(self.parameters)
        if len(self._x) < 3:
            # cold start: random exploration
            return [
                self._from_unit(self._rng.random(dim))
                for _ in range(n_candidates)
            ]
        pool = self._rng.random((256, dim))
        mu, sigma = self._posterior(pool)
        best = max(self._y)
        z = (mu - best - self._explore) / sigma
        # EI = sigma * (z * Phi(z) + phi(z))
        phi = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        big_phi = 0.5 * (1 + _erf(z / np.sqrt(2)))
        ei = sigma * (z * big_phi + phi)
        order = np.argsort(-ei)
        return [
            self._from_unit(pool[i]) for i in order[:n_candidates]
        ]

    @property
    def best(self) -> Optional[Tuple[Dict[str, float], float]]:
        if not self._y:
            return None
        i = int(np.argmax(self._y))
        return self._from_unit(self._x[i]), self._y[i]


def _erf(x: np.ndarray) -> np.ndarray:
    # Abramowitz-Stegun rational approximation (max err ~1.5e-7)
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (
        ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
         - 0.284496736) * t + 0.254829592
    ) * t * np.exp(-x * x)
    return sign * y
