"""Brain (reference: ``dlrover_tpu/brain/``): only the Bayesian
optimizer so far, which the strategy search uses; the resource service
and its metrics store come with slice 9 of the port."""

from dlrover_tpu_torch.brain.bo import BayesianOptimizer

__all__ = ["BayesianOptimizer"]
