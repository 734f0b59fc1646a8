"""dlrover_tpu_torch: the PyTorch + CUDA port of ``dlrover_tpu``.

The package mirrors ``dlrover_tpu``'s layout (``dlrover_tpu/x/y.py``
has its counterpart at ``dlrover_tpu_torch/x/y.py``) and imports
nothing of it, nor JAX: modules it needs from the JAX package are
copied.  Every Pallas TPU kernel on a ported path is a hand-written
CUDA kernel for Hopper under ``csrc/``, built at first use.

This slice: GPT training on one GPU (``models.gpt``,
``trainer.elastic_trainer``, ``trainer.trainer``) over the flash
attention kernels in ``ops.flash_attention``.
"""
