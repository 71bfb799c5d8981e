"""XMC serving engine: top-k label queries over a pruned DiSMEC model.

The paper's distributed prediction (§2.2.1) as a serving subsystem, in
PyTorch. A `ServeSpec` rides inside every checkpoint manifest, and

    from repro_torch.xmc_api import CheckpointHandle
    engine = CheckpointHandle.open(ckpt_dir).engine()

builds this engine as the spec describes, on the card. Backends live in a
decorator registry (`@register_backend("kind")`); `make_backend` is a thin
lookup. Five backends are built in:

  dense     — X @ W.T (`torch.matmul`) on the densified model, then a
              stable sort. Baseline and reference semantics.
  bsr       — the block-sparse predict kernel followed by the blocked top-k
              kernel (kernels/bsr_predict.ops.bsr_predict_topk); the model
              stays in packed BSR form, compute scales with block density.
              `int8=True` serves the int8 artifact, as `int8` does.
  int8      — the bsr path over the symmetric per-block int8 artifact
              (`core.pruning.Int8BlockSparseModel`): int8 blocks widened in
              registers, each block's fp32 dot multiplied by its scale.
              Scores within the quantization bound, so top-k agreement,
              not bit equality.
  shortlist — two-stage sub-linear scoring: the checkpoint's coarse stage
              (serve/shortlist.py: block centroids, a learned one-vs-rest
              classifier or a routing tree) selects the top-B row blocks,
              then the gathered kernel scores only their packed blocks.
              Selection is shared by the micro-batch, or per query
              (`shortlist_per_query`); `int8=True` gathers int8 blocks
              for either. Without an artifact it serves as bsr (or int8).
  sharded   — the densified model label-sharded over a mesh's label
              axis (`launch/mesh.py`; its second, `model` by default),
              each shard densified on its own device from the packed
              rows it holds: each shard scores its rows on its
              own device, takes a local top-k with the blocked top-k
              kernel and the k x n_shards candidates are merged on the
              mesh's first device (core.prediction.predict_topk_sharded).

dense, bsr, sharded and shortlist return identical top-k label ids on the same
pruned model, tie order included (descending score, then ascending id;
shortlist whenever its candidates cover the top-k, and exactly when B is
the row-block count): padding labels are masked below any real score
before the merge, and fully pruned real labels keep their exact-zero
score. A checkpoint packed under a `label_order` permutation is served
through `RelabelBackend`, which maps ids back.

Requests go through `serve.batching.MicroBatchQueue` (size-bucketed padding
of ragged streams); each bucket is run once at warm-up, and per-request
latency percentiles are kept (enqueue -> completion). `XMCEngine.step()`
drains the queue synchronously, each micro-batch's pack, copy, launch and
copy back a span (`repro_torch.obs`) while a profiler records;
`XMCEngine.server()` wraps the engine in the async request path
(`serve/server.py`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import itertools
import time
from typing import Iterable, Protocol, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.prediction import predict_topk, predict_topk_sharded
from repro_torch.core.pruning import (BlockSparseModel, Int8BlockSparseModel,
                                      quantize_block_sparse, to_block_sparse)
from repro_torch.device import synchronize, to_device
from repro_torch.serve.batching import (DEFAULT_BUCKETS, LatencyStats,
                                        MicroBatchQueue)
from repro_torch.serve.shortlist import ShortlistArtifact, build_shortlist


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


class Int8Backend:
    """Exhaustive BSR scoring over the int8 per-block-scaled artifact.
    Takes the quantized artifact, or a fp32 `BlockSparseModel` that it
    quantizes (the bytes a checkpoint persists)."""

    name = "int8"

    def __init__(self, model, k: int, *, n_labels: int | None = None):
        if isinstance(model, BlockSparseModel):
            model = quantize_block_sparse(model)
        self.k = k
        self.n_labels = int(n_labels if n_labels is not None
                            else model.n_labels)
        self.model = model
        self.device = model.device

    def warmup_key(self):
        # The kind tag and the int8 dtype keep an int8 backend over the
        # geometry of a fp32 bsr backend from marking its buckets warm.
        m = self.model
        return ("int8", tuple(m.blocks.shape), str(m.blocks.dtype), m.shape,
                m.block_shape, m.orig_shape, self.k, self.n_labels,
                str(self.device))

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.bsr_predict import ops as bsr_ops
        return bsr_ops.bsr_predict_int8_topk(x, self.model, self.k,
                                             n_labels=self.n_labels)


def _coarse_input(x: torch.Tensor, Dp: int) -> torch.Tensor:
    xf = x.float()
    if xf.shape[1] < Dp:
        xf = torch.nn.functional.pad(xf, (0, Dp - xf.shape[1]))
    return xf


def _top_b(coarse: torch.Tensor, B: int) -> torch.Tensor:
    """The B largest along the last axis, the lowest index first among
    equal scores (`lax.top_k`'s order), then sorted ascending; on the
    device, with no host sync."""
    order = torch.sort(coarse, dim=-1, descending=True, stable=True)[1]
    return torch.sort(order[..., :B], dim=-1)[0].to(torch.int32)


def _select_shared_from(coarse: torch.Tensor, B: int) -> torch.Tensor:
    """Shared top-B selection (B,) from (n, R) coarse scores: the max over
    the micro-batch's rows, padding rows included."""
    return _top_b(coarse.max(dim=0)[0], B)


def _select_pq_from(coarse: torch.Tensor, B: int) -> torch.Tensor:
    """Per-query top-B selection (n, B), each row sorted."""
    return _top_b(coarse, B)


def _shortlist_select(x: torch.Tensor, centroids: torch.Tensor,
                      B: int) -> torch.Tensor:
    """Matrix coarse stage, shared: x @ centroids.T (`torch.matmul`), max
    over the batch, top B sorted ascending, so that B = R is the
    exhaustive path."""
    xf = _coarse_input(x, centroids.shape[1])
    return _select_shared_from(xf @ centroids.T, B)


def _shortlist_select_pq(x: torch.Tensor, centroids: torch.Tensor,
                         B: int) -> torch.Tensor:
    """Matrix coarse stage, per query: each row's own sorted top B."""
    xf = _coarse_input(x, centroids.shape[1])
    return _select_pq_from(xf @ centroids.T, B)


def _tree_coarse(x: torch.Tensor, nodes: torch.Tensor,
                 leaf_scores: torch.Tensor, depth: int) -> torch.Tensor:
    """Tree coarse scores (n, R): descend the complete tree of hyperplanes
    (right iff x @ w >= 0) for `depth` steps, read the leaf's row."""
    xf = _coarse_input(x, nodes.shape[1])
    idx = torch.zeros(xf.shape[0], dtype=torch.long, device=xf.device)
    for _ in range(depth):
        go_right = ((xf * nodes[idx]).sum(dim=1) >= 0.0).long()
        idx = 2 * idx + 1 + go_right
    return leaf_scores[idx - (2 ** depth - 1)]


class ShortlistBackend:
    """Two-stage sub-linear scoring: a coarse shortlist of row blocks, then
    the gathered fine stage over the packed blocks of those row blocks.

    The coarse stage is the artifact's: "centroid" and "learned" are one
    (n, Dp) x (Dp, R) product, "tree" routes each query to a leaf's
    per-block scores. The selection is shared by the micro-batch (the max
    over its rows, padding rows included: a padding row scores exactly 0,
    which on a model whose coarse scores are all negative can steer the
    selection) or, with `per_query`, each row's own. B is fixed per
    backend, candidate fraction B / R. At B == R every sorted per-query
    list is the full list, so full width always uses the shared kernel,
    which gives the exhaustive path bit for bit. `int8=True` keeps the
    fp32 model and gathers from the int8 one (`int8_model`, or quantized
    here), shared or per query.
    """

    name = "shortlist"

    def __init__(self, model: BlockSparseModel, artifact: ShortlistArtifact,
                 k: int, *, n_labels: int | None = None,
                 blocks: int | None = None, int8: bool = False,
                 int8_model: Int8BlockSparseModel | None = None,
                 per_query: bool = False):
        from repro_torch.kernels.bsr_predict import ops as bsr_ops
        artifact.validate_against(model)
        self.k = k
        self.n_labels = int(n_labels if n_labels is not None
                            else model.n_labels)
        self.model = model
        self.device = model.device
        self.artifact = artifact
        self.kind = artifact.kind
        R = artifact.n_row_blocks
        self.B = min(int(blocks if blocks is not None
                         else artifact.default_blocks()), R)
        if self.B < 1:
            raise ValueError(f"shortlist width must be >= 1, got {self.B}")
        self.per_query = bool(per_query) and self.B < R
        self.int8 = bool(int8)
        def put(a):
            return to_device(torch.as_tensor(a), self.device)
        self._centroids = put(artifact.centroids)
        self._tree = None
        if self.kind == "tree":
            self._tree = (put(artifact.tree_nodes),
                          put(artifact.tree_leaf_scores),
                          int(artifact.tree_depth))
        self._max_per_row = bsr_ops.max_blocks_per_row(model)
        self.int8_model = None
        if self.int8:
            self.int8_model = (int8_model if int8_model is not None
                               else quantize_block_sparse(model))

    @property
    def candidate_fraction(self) -> float:
        """Fraction of row blocks the fine stage scores per query."""
        return self.B / self.artifact.n_row_blocks

    def warmup_key(self):
        # int8 vs fp32, tree vs matrix and per-query vs shared are other
        # computations over the same geometry: part of the key.
        m = self.model
        return ("shortlist", self.kind, self.per_query, self.int8,
                tuple(m.blocks.shape), str(m.blocks.dtype), m.shape,
                m.block_shape, m.orig_shape, tuple(self._centroids.shape),
                self.B, self._max_per_row, self.k, self.n_labels,
                str(self.device))

    def _select(self, x: torch.Tensor) -> torch.Tensor:
        """The selection the fine stage scores: (B,) shared or (n, B) per
        query, sorted either way."""
        if self.kind == "tree":
            coarse = _tree_coarse(x, *self._tree)
            return (_select_pq_from if self.per_query
                    else _select_shared_from)(coarse, self.B)
        return (_shortlist_select_pq if self.per_query
                else _shortlist_select)(x, self._centroids, self.B)

    def select_blocks(self, x) -> np.ndarray:
        """The sorted row-block ids the fine stage would score for this
        batch: (B,) shared or (n, B) per query."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self._select(x).cpu().numpy()

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.bsr_predict import ops as bsr_ops
        sel = self._select(x)
        fn = (bsr_ops.bsr_predict_gather_pq_topk if self.per_query
              else bsr_ops.bsr_predict_gather_topk)
        return fn(x, self.int8_model if self.int8 else self.model, sel,
                  self.k, n_labels=self.n_labels)


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


class ShardedBackend:
    """Mesh label-sharded local top-k + merge (paper §2.2.1): the model
    lives as one row shard per label shard (the mesh's `axis_names[1]`),
    each on its device, the shards of equal height (the last padded with
    zero rows); ids >= `n_labels` are never served."""

    name = "sharded"

    def __init__(self, shards, k: int, mesh, *, n_labels: int):
        self.k = k
        self.n_labels = int(n_labels)
        self.mesh = mesh
        self.device = mesh.first
        self._shards = list(shards)

    def warmup_key(self):
        return None        # mesh-bound: never share warm-up state

    def topk(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return predict_topk_sharded(x, self._shards, self.k, self.mesh,
                                    label_axis=self.mesh.axis_names[1],
                                    n_labels=self.n_labels)


# ---------------------------------------------------------------------------
# Backend registry: kind -> factory(bsr, k, *, n_labels, ...) ->
# PredictBackend.
# ---------------------------------------------------------------------------

_BACKEND_REGISTRY: dict[str, "object"] = {}


def register_backend(kind: str):
    """Decorator: plug a new predict backend into the serving registry.
    The factory receives the packed model and returns a `PredictBackend`::

        @register_backend("quantized")
        def _make_quantized(bsr, k, *, n_labels):
            return QuantizedBackend(bsr, k, n_labels=n_labels)

    It is given only the keywords of `make_backend` its signature names
    (all of them with **kwargs).
    """
    def deco(factory):
        if kind in _BACKEND_REGISTRY:
            raise ValueError(f"backend {kind!r} already registered")
        _BACKEND_REGISTRY[kind] = factory
        return factory
    return deco


def unregister_backend(kind: str) -> None:
    """Remove a registered backend kind (plugin teardown, tests)."""
    _BACKEND_REGISTRY.pop(kind, None)


def available_backends() -> tuple[str, ...]:
    """Every registered backend kind, sorted."""
    return tuple(sorted(_BACKEND_REGISTRY))


@register_backend("dense")
def _make_dense_backend(bsr: BlockSparseModel, k: int, *, n_labels: int):
    return DenseBackend(bsr.to_dense()[:n_labels, :bsr.n_features], k,
                        n_labels=n_labels)


@register_backend("bsr")
def _make_bsr_backend(bsr: BlockSparseModel, k: int, *, n_labels: int,
                      int8=False, int8_model=None):
    if int8:      # ServeSpec(backend="bsr", int8=True) is the "int8" kind
        return Int8Backend(int8_model if int8_model is not None else bsr,
                           k, n_labels=n_labels)
    return BsrBackend(bsr, k, n_labels=n_labels)


@register_backend("sharded")
def _make_sharded_backend(bsr: BlockSparseModel, k: int, *, n_labels: int,
                          mesh=None):
    if mesh is None:     # every card from the model's on, or the CPU
        from repro_torch.launch.mesh import make_host_mesh
        if bsr.device.type == "cuda":
            devices = list(range(bsr.device.index or 0,
                                 torch.cuda.device_count()))
            mesh = make_host_mesh(1, len(devices),
                                  devices=[f"cuda:{i}" for i in devices])
        else:
            mesh = make_host_mesh(1, 1, devices=[bsr.device])
    # Each shard densified straight from its rows of the packed model on
    # its own device: no dense copy of the whole model is ever made.
    label_axis = mesh.axis_names[1]
    n_shards = mesh.shape[label_axis]
    per = -(-n_labels // n_shards)
    shards = [bsr.dense_rows(j * per, (j + 1) * per, n_rows=n_labels,
                             n_cols=bsr.n_features,
                             device=mesh.device(**{label_axis: j}))
              for j in range(n_shards)]
    return ShardedBackend(shards, k, mesh, n_labels=n_labels)


@register_backend("int8")
def _make_int8_backend(bsr: BlockSparseModel, k: int, *, n_labels: int,
                       int8_model=None):
    return Int8Backend(int8_model if int8_model is not None else bsr, k,
                       n_labels=n_labels)


@register_backend("shortlist")
def _make_shortlist_backend(bsr: BlockSparseModel, k: int, *, n_labels: int,
                            shortlist=None, shortlist_blocks=None,
                            int8=False, int8_model=None,
                            shortlist_per_query=False):
    if shortlist is None:            # no artifact: exhaustive scoring
        return _make_bsr_backend(bsr, k, n_labels=n_labels, int8=int8,
                                 int8_model=int8_model)
    return ShortlistBackend(bsr, shortlist, k, n_labels=n_labels,
                            blocks=shortlist_blocks, int8=int8,
                            int8_model=int8_model,
                            per_query=shortlist_per_query)


def make_backend(kind: str, bsr: BlockSparseModel, k: int, *,
                 n_labels: int | None = None,
                 shortlist: ShortlistArtifact | None = None,
                 shortlist_blocks: int | None = None, int8: bool = False,
                 int8_model: Int8BlockSparseModel | None = None,
                 shortlist_per_query: bool = False,
                 label_order=None, mesh=None) -> PredictBackend:
    """Build a registered backend from the packed model (a thin lookup).

    dense densifies in memory, sliced back to the true (L, D); bsr serves
    the packed form directly; shortlist adds the coarse stage when given
    an artifact. kind="int8" (or bsr/shortlist with int8=True) serves the
    int8 artifact: `int8_model` (a checkpoint's persisted arrays), else
    the fp32 blocks quantized here (the same bytes). sharded spreads the
    densified model over `mesh` (default: every card from the model's
    on). Each factory is given the keywords its signature names.
    `label_order` (the pack-time permutation recorded in the checkpoint)
    wraps the backend in `RelabelBackend`.
    """
    try:
        factory = _BACKEND_REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown backend {kind!r}; expected one of "
                         f"{available_backends()}") from None
    n_labels = int(n_labels if n_labels is not None else bsr.n_labels)
    kwargs = dict(n_labels=n_labels, shortlist=shortlist,
                  shortlist_blocks=shortlist_blocks, int8=int8,
                  int8_model=int8_model,
                  shortlist_per_query=shortlist_per_query, mesh=mesh)
    params = inspect.signature(factory).parameters
    if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
        kwargs = {key: v for key, v in kwargs.items() if key in params}
    be = factory(bsr, k, **kwargs)
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

    def adopt_n_features(self, n_features: int) -> None:
        """Pin the feature dim on an engine that does not know it yet (no
        checkpoint meta, no request seen). `XMCServer.swap` uses this so an
        in-memory replacement engine can be warmed for the server's buckets
        before the flip; adopting a conflicting dim is refused like a
        mismatched request would be."""
        n_features = int(n_features)
        if self._n_features is not None and self._n_features != n_features:
            raise ValueError(f"engine already serves feature dim "
                             f"{self._n_features}, cannot adopt {n_features}")
        self._n_features = n_features

    @classmethod
    def from_checkpoint(cls, directory: str, *, backend: str = "bsr",
                        k: int = 5, buckets: Sequence[int] = DEFAULT_BUCKETS,
                        warmup: bool = True, device=None,
                        shortlist_blocks: int | None = None,
                        int8: bool = False,
                        shortlist_per_query: bool = False,
                        mesh=None) -> "XMCEngine":
        """Serve the sparse artifact written by `save_block_sparse` (either
        package's), with the model on `device` (None: the card, raising
        when none is present); `mesh` goes to mesh-sharded backends. The
        shortlist artifact beside the arrays is picked up when present;
        backend="int8" (or `int8=True`) serves the persisted int8 arrays,
        quantizing when the checkpoint predates them. A checkpoint packed
        under a `label_order` permutation is unmapped here: every backend
        returns original ids.
        """
        from repro_torch.checkpoint.io import (load_block_sparse,
                                               load_block_sparse_int8,
                                               load_block_sparse_meta,
                                               load_shortlist)
        bsr, meta = load_block_sparse(directory, device=device)
        n_labels = int(meta.get("n_labels", bsr.n_labels))
        int8_model = None
        if int8 or backend == "int8":
            int8_model, _ = load_block_sparse_int8(directory, model=bsr)
        be = make_backend(backend, bsr, k, n_labels=n_labels,
                          shortlist=load_shortlist(directory),
                          shortlist_blocks=shortlist_blocks, int8=int8,
                          int8_model=int8_model,
                          shortlist_per_query=shortlist_per_query,
                          label_order=load_block_sparse_meta(
                              directory).get("label_order"), mesh=mesh)
        return cls(be, buckets, warmup=warmup,
                   n_features=int(meta.get("n_features", bsr.n_features)))

    @classmethod
    def from_dismec(cls, model, *, backend: str = "dense", k: int = 5,
                    block_shape: tuple[int, int] = (128, 128),
                    buckets: Sequence[int] = DEFAULT_BUCKETS,
                    warmup: bool = False,
                    shortlist_blocks: int | None = None,
                    int8: bool = False,
                    shortlist_per_query: bool = False) -> "XMCEngine":
        """An engine straight from an in-memory `DiSMECModel`, on the
        device of its W (the centroid shortlist artifact is built here; no
        checkpoint needed)."""
        bsr = to_block_sparse(model.W, block_shape, device=model.W.device)
        be = make_backend(backend, bsr, k, n_labels=model.W.shape[0],
                          shortlist=build_shortlist(bsr),
                          shortlist_blocks=shortlist_blocks, int8=int8,
                          shortlist_per_query=shortlist_per_query)
        return cls(be, buckets, warmup=warmup,
                   n_features=int(model.W.shape[1]))

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
        batches = self.queue.drain()
        for b in itertools.count():
            with obs.span("serve.pack", batch=b):
                mb = next(batches, None)
            if mb is None:
                break
            self.ensure_warm(mb.bucket)
            with obs.span("serve.h2d", batch=b, bytes=mb.x.nbytes):
                x = torch.from_numpy(mb.x).to(self.backend.device)
            with obs.span("serve.launch", batch=b):
                scores, labels = self.backend.topk(x)
            with obs.span("serve.d2h", batch=b):
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

    def server(self, **kwargs):
        """Wrap this engine in the async continuous-batching loop
        (`serve.server.XMCServer`): `submit` returns futures, buckets
        launch on fill or deadline, admission control sheds overload. The
        synchronous `step()` path stays available and bit-identical.
        Keyword args go to `XMCServer` (max_batch_delay_ms, max_queue,
        max_inflight, name, start)."""
        from repro_torch.serve.server import XMCServer   # deferred: no cycle
        return XMCServer(self, **kwargs)

    def latency_summary(self) -> dict[str, float]:
        return self.stats.summary()
