"""Elastic agent: the per-host daemon between the job master and the
training processes (reference: ``dlrover/python/elastic_agent/``).

Copy of ``dlrover_tpu/agent/__init__.py`` (the port imports nothing of
the JAX package).
"""
