"""ServeSpec: how a trained checkpoint is turned into a serving engine.

The same fields and validation as the JAX package's `ServeSpec`, so the
serving half of a manifest's embedded spec reads back here and writes
back unchanged. Serving choices never affect the solved weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.specs.base import Spec

# Mirrors repro_torch.serve.batching.DEFAULT_BUCKETS, so this package stays
# importable without torch.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class ServeSpec(Spec):
    """One serving configuration over a sparse checkpoint.

    backend   : predict-backend registry kind ("dense", "bsr", "int8",
                "shortlist" or "sharded", the JAX package's five).
    k         : top-k labels returned per instance.
    buckets   : micro-batch bucket sizes.
    interpret : the JAX package's Pallas execution mode. Kept so that
                manifests round-trip; the port has no interpreter mode and
                ignores it (its kernels run on the card, their plain
                versions on the CPU).
    warmup    : run every bucket once at engine construction.
    shortlist_blocks : shortlist width B in row blocks (None: the
                artifact's default, 1/8 of them).
    int8      : serve the int8 artifact (bsr and shortlist backends).
    shortlist_kind : the coarse stage `fit` builds ("centroid", "learned"
                or "tree").
    shortlist_per_query : one selection per query instead of one per
                micro-batch (fp32 or int8).
    max_batch_delay_ms / max_queue : the async server's launch deadline
                and admission bound (`CheckpointHandle.server()`, None:
                unbounded).
    """
    backend: str = "bsr"
    k: int = 5
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    interpret: Optional[bool] = None
    warmup: bool = True
    shortlist_blocks: Optional[int] = None
    int8: bool = False
    max_batch_delay_ms: float = 2.0
    max_queue: Optional[int] = None
    shortlist_kind: str = "centroid"
    shortlist_per_query: bool = False

    def validate(self) -> "ServeSpec":
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not self.buckets or any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be non-empty positive sizes, "
                             f"got {self.buckets}")
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"buckets must be ascending, got {self.buckets}")
        if self.shortlist_blocks is not None and self.shortlist_blocks < 1:
            raise ValueError(f"shortlist_blocks must be >= 1 (or None for "
                             f"the artifact default), got "
                             f"{self.shortlist_blocks}")
        if self.max_batch_delay_ms < 0:
            raise ValueError(f"max_batch_delay_ms must be >= 0, got "
                             f"{self.max_batch_delay_ms}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for "
                             f"unbounded), got {self.max_queue}")
        if self.shortlist_kind not in ("centroid", "learned", "tree"):
            raise ValueError(
                f"shortlist_kind must be 'centroid', 'learned' or 'tree', "
                f"got {self.shortlist_kind!r}")
        return self
