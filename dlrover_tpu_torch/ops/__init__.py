"""Kernels of the port (``dlrover_tpu/ops``): CUDA C++ under ``csrc/``."""
