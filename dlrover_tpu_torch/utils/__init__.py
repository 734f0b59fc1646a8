"""Converters between the JAX package's flax params and the port's state dicts."""
