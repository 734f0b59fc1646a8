"""Telemetry of the port: copies of ``dlrover_tpu/telemetry/metrics.py``
and ``events.py``, so the agent's collectors read the port's
``train_step``/``step_phases`` events and metrics unchanged."""
