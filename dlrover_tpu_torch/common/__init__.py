"""Shared helpers of the port (copies of ``dlrover_tpu/common``)."""
