"""Runnable examples of the port (reference: ``examples/``)."""
