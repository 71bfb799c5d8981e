"""Serving subsystem: request batching and the XMC top-k engine."""
