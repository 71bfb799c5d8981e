"""Synthetic XMC data (a numpy copy of the JAX package's generator)."""
