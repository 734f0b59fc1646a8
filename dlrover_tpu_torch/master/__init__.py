"""Copy of ``dlrover_tpu/master/__init__.py`` (the port imports nothing
of the JAX package)."""

