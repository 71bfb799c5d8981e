"""Synthetic data: XMC (a numpy copy of the JAX package's generator) and
the LM token pipeline."""
