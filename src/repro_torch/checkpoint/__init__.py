"""The BSR serving checkpoint formats (shared with the JAX package)."""
