"""Serving subsystem: request batching, the XMC top-k engine and the async
request-path server.

  xmc       — XMC top-k label serving over a registry of predict backends
              (dense / bsr / int8 / shortlist / sharded;
              `register_backend` adds more). The spec-driven way to build
              an engine is
              `repro_torch.xmc_api.CheckpointHandle.engine()`.
  server    — continuous-batching async loop over an engine: deadline-
              launched buckets, double-buffered dispatch, admission
              control (`Rejected`), future-style results, hot swap and
              multi-model routing (`ModelRouter`). Spec-driven entry:
              `CheckpointHandle.server()`.
  shortlist — the coarse candidate stage of two-stage scoring.
  engine    — LM serving: greedy decode against the cache
              (`generate`, `serve_batch`).
  batching  — the size-bucketed micro-batch queue with arrival timestamps
              and deadline launch, latency accounting, and LM token
              padding.
"""

from repro_torch.serve.engine import generate, serve_batch
from repro_torch.serve.server import (ModelRouter, Rejected, XMCFuture,
                                      XMCServer)
from repro_torch.serve.shortlist import (ShortlistArtifact,
                                         build_learned_shortlist,
                                         build_shortlist,
                                         build_tree_shortlist, coarse_scores,
                                         cooccurrence_label_order)
from repro_torch.serve.xmc import (BsrBackend, DenseBackend, Int8Backend,
                                   PredictBackend, RelabelBackend,
                                   ShardedBackend, ShortlistBackend,
                                   XMCEngine, XMCResult,
                                   available_backends, make_backend,
                                   register_backend, reset_warmup_cache,
                                   unregister_backend, warmup_cache_stats)

__all__ = ["XMCEngine", "XMCResult", "XMCServer", "XMCFuture",
           "ModelRouter", "Rejected", "PredictBackend", "DenseBackend",
           "BsrBackend", "Int8Backend", "ShortlistBackend", "RelabelBackend",
           "ShardedBackend",
           "ShortlistArtifact", "build_shortlist", "build_learned_shortlist",
           "build_tree_shortlist", "coarse_scores",
           "cooccurrence_label_order", "make_backend", "register_backend",
           "unregister_backend", "available_backends", "reset_warmup_cache",
           "warmup_cache_stats", "generate", "serve_batch"]
