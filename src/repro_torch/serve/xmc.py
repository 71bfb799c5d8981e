"""XMC serving engine: top-k label queries over a pruned DiSMEC model.

The paper's distributed prediction (§2.2.1) as a serving subsystem, in
PyTorch. A `ServeSpec` rides inside every checkpoint manifest, and

    from repro_torch.xmc_api import CheckpointHandle
    engine = CheckpointHandle.open(ckpt_dir).engine()

builds this engine as the spec describes, on the card. Backends live in a
decorator registry (`@register_backend("kind")`); `make_backend` is a thin
lookup. Two backends are built in:

  dense — X @ W.T (`torch.matmul`) on the densified model, then a stable
          sort. Baseline and reference semantics.
  bsr   — the block-sparse predict kernel followed by the blocked top-k
          kernel (kernels/bsr_predict.ops.bsr_predict_topk); the model
          stays in packed BSR form, compute scales with block density.

Both return identical top-k label ids on the same pruned model, tie order
included (descending score, then ascending id): padding labels are masked
below any real score before the merge, and fully pruned real labels keep
their exact-zero score. A checkpoint packed under a `label_order`
permutation is served through `RelabelBackend`, which maps ids back.

Requests go through `serve.batching.MicroBatchQueue` (size-bucketed padding
of ragged streams); each bucket is run once at warm-up, and per-request
latency percentiles are kept (enqueue -> completion).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.prediction import predict_topk
from repro_torch.core.pruning import BlockSparseModel
from repro_torch.device import synchronize
from repro_torch.serve.batching import (DEFAULT_BUCKETS, LatencyStats,
                                        MicroBatchQueue)


class PredictBackend(Protocol):
    """What the engine needs from a scoring implementation."""

    name: str
    n_labels: int
    k: int
    device: torch.device

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (n, D) -> (scores, label ids), each (n, k)."""
        ...


class DenseBackend:
    """Reference semantics: dense scores + a stable-sort top-k."""

    name = "dense"

    def __init__(self, W: torch.Tensor, k: int, *,
                 n_labels: int | None = None):
        self.k = k
        self.n_labels = int(n_labels if n_labels is not None else W.shape[0])
        self._W = W[:self.n_labels].contiguous()   # drop any padding rows
        self.device = self._W.device

    def warmup_key(self):
        return ("dense", tuple(self._W.shape), str(self._W.dtype), self.k,
                str(self.device))

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return predict_topk(x, self._W, self.k)


class BsrBackend:
    """Packed block-sparse model through the predict and top-k kernels."""

    name = "bsr"

    def __init__(self, model: BlockSparseModel, k: int, *,
                 n_labels: int | None = None):
        self.k = k
        self.n_labels = int(n_labels if n_labels is not None
                            else model.n_labels)
        self.model = model
        self.device = model.device

    def warmup_key(self):
        m = self.model
        return ("bsr", tuple(m.blocks.shape), str(m.blocks.dtype), m.shape,
                m.block_shape, m.orig_shape, self.k, self.n_labels,
                str(self.device))

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.bsr_predict import ops as bsr_ops
        return bsr_ops.bsr_predict_topk(x, self.model, self.k,
                                        n_labels=self.n_labels)


class RelabelBackend:
    """Pack-time reorder unmapping: wraps any backend serving a checkpoint
    packed under a `label_order` permutation and maps its packed top-k ids
    back to original label ids (`order[packed_id]`), scores untouched.
    `__getattr__` delegates everything else to the inner backend."""

    def __init__(self, inner: PredictBackend, label_order):
        order = np.asarray(label_order, np.int64).reshape(-1)
        n = int(getattr(inner, "n_labels", order.shape[0]))
        if (order.shape[0] != n
                or not np.array_equal(np.sort(order), np.arange(n))):
            raise ValueError(
                f"label_order must be a permutation of range({n})")
        self.inner = inner
        self.name = inner.name
        self.k = inner.k
        self.n_labels = n
        self.device = inner.device
        self._order = torch.as_tensor(order.astype(np.int32),
                                      device=inner.device)
        self._digest = hashlib.sha1(order.tobytes()).hexdigest()[:16]

    def warmup_key(self):
        key = getattr(self.inner, "warmup_key", lambda: None)()
        # Two engines over one inner geometry but different permutations
        # must not mark each other warm, hence the order digest.
        return None if key is None else ("relabel", self._digest, key)

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        scores, labels = self.inner.topk(x)
        return scores, self._order[labels.long()]

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---------------------------------------------------------------------------
# Backend registry: kind -> factory(bsr, k, *, n_labels) -> PredictBackend.
# ---------------------------------------------------------------------------

_BACKEND_REGISTRY: dict[str, "object"] = {}


def register_backend(kind: str):
    """Decorator: plug a new predict backend into the serving registry.
    The factory receives the packed model and returns a `PredictBackend`::

        @register_backend("quantized")
        def _make_quantized(bsr, k, *, n_labels):
            return QuantizedBackend(bsr, k, n_labels=n_labels)
    """
    def deco(factory):
        if kind in _BACKEND_REGISTRY:
            raise ValueError(f"backend {kind!r} already registered")
        _BACKEND_REGISTRY[kind] = factory
        return factory
    return deco


def available_backends() -> tuple[str, ...]:
    """Every registered backend kind, sorted."""
    return tuple(sorted(_BACKEND_REGISTRY))


@register_backend("dense")
def _make_dense_backend(bsr: BlockSparseModel, k: int, *, n_labels: int):
    return DenseBackend(bsr.to_dense()[:n_labels, :bsr.n_features], k,
                        n_labels=n_labels)


@register_backend("bsr")
def _make_bsr_backend(bsr: BlockSparseModel, k: int, *, n_labels: int):
    return BsrBackend(bsr, k, n_labels=n_labels)


def make_backend(kind: str, bsr: BlockSparseModel, k: int, *,
                 n_labels: int | None = None,
                 label_order=None) -> PredictBackend:
    """Build a registered backend from the packed model (a thin lookup).

    dense densifies in memory, sliced back to the true (L, D); bsr serves
    the packed form directly. `label_order` (the pack-time permutation
    recorded in the checkpoint) wraps the backend in `RelabelBackend`.
    """
    try:
        factory = _BACKEND_REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown backend {kind!r}; expected one of "
                         f"{available_backends()}") from None
    n_labels = int(n_labels if n_labels is not None else bsr.n_labels)
    be = factory(bsr, k, n_labels=n_labels)
    if label_order is not None:
        be = RelabelBackend(be, label_order)
    return be


# ---------------------------------------------------------------------------
# Process-wide warm-up ledger: a (warmup_key, bucket, n_features) triple
# already warmed by any engine is skipped. Backends whose key is None
# always run their warm-up.
# ---------------------------------------------------------------------------

_WARMUP_SEEN: set = set()
_WARMUP_STATS = {"dispatches": 0, "shared_hits": 0}


def reset_warmup_cache() -> None:
    """Forget all shared warm-up state (tests / benchmark isolation)."""
    _WARMUP_SEEN.clear()
    _WARMUP_STATS["dispatches"] = 0
    _WARMUP_STATS["shared_hits"] = 0


def warmup_cache_stats() -> dict[str, int]:
    """Counters since the last reset: `dispatches` (warm-up calls issued)
    and `shared_hits` (bucket warm-ups skipped because an equal backend
    was already warmed by another engine in this process)."""
    return dict(_WARMUP_STATS)


@dataclasses.dataclass
class XMCResult:
    """Answer to one request: top-k labels for each of its instances."""
    request_id: int
    scores: np.ndarray                 # (n_i, k)
    labels: np.ndarray                 # (n_i, k) true label ids


class XMCEngine:
    """Micro-batched top-k label serving over a `PredictBackend`.

    The engine owns the request queue, bucket padding, per-bucket warm-up
    and latency accounting; the backend owns the math and the device.
    """

    def __init__(self, backend: PredictBackend,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 *, warmup: bool = True, n_features: int | None = None):
        self.backend = backend
        self.queue = MicroBatchQueue(buckets)
        self.stats = LatencyStats()
        self._warm: set[int] = set()
        self._n_features = n_features
        if warmup and n_features is not None:
            self.warmup()

    @property
    def n_features(self) -> int | None:
        """Feature dim the engine serves (from checkpoint meta or the first
        submitted request); None until either is known."""
        return self._n_features

    @classmethod
    def from_checkpoint(cls, directory: str, *, backend: str = "bsr",
                        k: int = 5, buckets: Sequence[int] = DEFAULT_BUCKETS,
                        warmup: bool = True, device=None) -> "XMCEngine":
        """Serve the sparse artifact written by `save_block_sparse` (either
        package's), with the model on `device` (None: the card, raising
        when none is present). A checkpoint packed under a `label_order`
        permutation is unmapped here: every backend returns original ids.
        """
        from repro_torch.checkpoint.io import (load_block_sparse,
                                               load_block_sparse_meta)
        bsr, meta = load_block_sparse(directory, device=device)
        n_labels = int(meta.get("n_labels", bsr.n_labels))
        be = make_backend(backend, bsr, k, n_labels=n_labels,
                          label_order=load_block_sparse_meta(
                              directory).get("label_order"))
        return cls(be, buckets, warmup=warmup,
                   n_features=int(meta.get("n_features", bsr.n_features)))

    # -- serving ------------------------------------------------------------

    def ensure_warm(self, bucket: int) -> None:
        """Warm one bucket if this engine has not yet."""
        if bucket not in self._warm:
            self.warmup([bucket])

    def warmup(self, buckets: Sequence[int] | None = None) -> int:
        """Run the backend once per bucket shape (kernel builds, library
        loads and first allocations paid up front, not by the first
        request). Returns the number of buckets newly warmed for this
        engine; buckets another engine already warmed process-wide (same
        `warmup_key`) count but are not run again."""
        if self._n_features is None:
            raise ValueError("n_features needed for warmup")
        key = getattr(self.backend, "warmup_key", lambda: None)()
        done = 0
        for b in (buckets or self.queue.buckets):
            if b in self._warm:
                continue
            gkey = None if key is None else (key, b, self._n_features)
            if gkey is not None and gkey in _WARMUP_SEEN:
                _WARMUP_STATS["shared_hits"] += 1
            else:
                x = torch.zeros((b, self._n_features), dtype=torch.float32,
                                device=self.backend.device)
                self.backend.topk(x)
                synchronize(self.backend.device)
                _WARMUP_STATS["dispatches"] += 1
                if gkey is not None:
                    _WARMUP_SEEN.add(gkey)
            self._warm.add(b)
            done += 1
        return done

    def submit(self, x: np.ndarray) -> int:
        """Enqueue one request of (n_i, D) instances; returns request id.
        Shape-checked here, so a mismatched request never reaches step()."""
        if self._n_features is None:
            self._n_features = int(x.shape[1])
        elif x.shape[1] != self._n_features:
            raise ValueError(
                f"request feature dim {x.shape[1]} != engine feature dim "
                f"{self._n_features}")
        return self.queue.submit(np.asarray(x, np.float32))

    def step(self) -> list[XMCResult]:
        """Drain the queue: run every micro-batch, un-pad, return results.

        One `XMCResult` per request id; a request the queue split across
        micro-batches has its rows re-joined in order. Latency runs from a
        request's enqueue to the completion of its last micro-batch (the
        results back on the host).
        """
        out: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
        arrival_by_rid: dict[int, float] = {}
        done_by_rid: dict[int, float] = {}
        for mb in self.queue.drain():
            self.ensure_warm(mb.bucket)
            x = torch.from_numpy(mb.x).to(self.backend.device)
            scores, labels = self.backend.topk(x)
            scores, labels = scores.cpu().numpy(), labels.cpu().numpy()
            t_done = time.monotonic()
            for rid, arrival in zip(mb.request_ids, mb.arrivals):
                arrival_by_rid[rid] = arrival
                done_by_rid[rid] = t_done
            for (rid, s), (_, l) in zip(mb.split(scores), mb.split(labels)):
                out.setdefault(rid, []).append((s, l))
        for rid in sorted(done_by_rid):
            self.stats.record_span(arrival_by_rid[rid], done_by_rid[rid])
        return [XMCResult(request_id=rid,
                          scores=np.concatenate([p[0] for p in parts]),
                          labels=np.concatenate([p[1] for p in parts]))
                for rid, parts in sorted(out.items())]

    def serve(self, requests: Iterable[np.ndarray]) -> list[XMCResult]:
        """Submit a whole request stream and drain it. Results are ordered
        by request id (== submission order)."""
        for x in requests:
            self.submit(x)
        return self.step()

    def latency_summary(self) -> dict[str, float]:
        return self.stats.summary()
