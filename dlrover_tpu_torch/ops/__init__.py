"""Kernels of the port (``dlrover_tpu/ops``): CUDA C++ under ``csrc/``;
``fp8`` is ``torch._scaled_mm`` (the reference's fp8 is jnp, no Pallas)."""
