"""Shortlist layer: the coarse stage of two-stage, sub-linear serving.

The unit of shortlisting is the BSR row block (bl consecutive labels): the
coarse stage scores the R row blocks, the top B are selected, and the fine
stage (`kernels/bsr_predict.ops.bsr_predict_gather_topk`) scores only
their packed blocks. The coarse model is `ShortlistArtifact.kind`:

  "centroid"  one (R, Dp) matrix of row-block centroids, row r the mean of
              block r's bl label weight rows, built from the packed blocks.
  "learned"   a one-vs-rest linear classifier per row block ("does this
              document have a positive label in block r?"), solved by the
              same `make_batch_solver` as the fine model, unpruned.
  "tree"      a fixed-depth routing tree of mean-difference hyperplanes
              over the training documents; its leaves score row blocks by
              positive-block frequency.

The artifact is `shortlist.npz` beside the BSR arrays (checkpoint/io.py),
in the JAX package's v2 format; `fit` replaces the free centroid artifact
by a learned or tree one while the training data is in hand. This module
also owns the pack-time label order (`cooccurrence_label_order`).

Everything here is numpy on the host, as in the JAX package, so both
packages write the same bytes; only the learned builder solves on a
device (the model's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.device import to_numpy

#: On-disk format version written by checkpoint/io.py::save_shortlist.
#: v1 had no version/kind keys and is always a centroid artifact.
SHORTLIST_VERSION = 2

SHORTLIST_KINDS = ("centroid", "learned", "tree")


@dataclasses.dataclass
class ShortlistArtifact:
    """The coarse stage of two-stage scoring, built from a packed BSR model.

    centroids   : (R, Dp) float32 coarse scoring matrix: block means
                  (kind="centroid"), the trained one-vs-rest rows
                  (kind="learned"), or the centroid fallback kept by a tree.
    block_rows  : bl, the row-block height the coarse stage summarizes.
    n_labels    : true (pre-padding) label count of the source model.
    stat        : "mean", "ovr" or "fastxml".
    kind        : "centroid" | "learned" | "tree".
    tree_nodes  : (2^depth - 1, Dp) level-order hyperplanes (tree only;
                  node i's children are 2i+1 / 2i+2; x goes right iff
                  x @ w >= 0).
    tree_leaf_scores : (2^depth, R) per-leaf row-block scores (tree only).
    tree_depth  : routing depth (0 unless kind == "tree").
    """
    centroids: np.ndarray
    block_rows: int
    n_labels: int
    stat: str = "mean"
    kind: str = "centroid"
    tree_nodes: Optional[np.ndarray] = None
    tree_leaf_scores: Optional[np.ndarray] = None
    tree_depth: int = 0

    @property
    def n_row_blocks(self) -> int:
        return int(self.centroids.shape[0])

    def default_blocks(self) -> int:
        """Shortlist width B when `ServeSpec.shortlist_blocks` is unset:
        1/8 of the row blocks, at least 1."""
        return max(1, -(-self.n_row_blocks // 8))

    def validate_against(self, model) -> "ShortlistArtifact":
        """Shape-check against the `BlockSparseModel` it will gate."""
        bl = model.block_shape[0]
        R = model.shape[0] // bl
        if self.block_rows != bl or self.centroids.shape != (R,
                                                             model.shape[1]):
            raise ValueError(
                f"shortlist artifact ({self.centroids.shape} centroids, "
                f"block_rows={self.block_rows}) does not match model "
                f"(shape {model.shape}, block height {bl}); rebuild it with "
                "build_shortlist(model)")
        if self.kind not in SHORTLIST_KINDS:
            raise ValueError(f"unknown shortlist kind {self.kind!r}; "
                             f"expected one of {SHORTLIST_KINDS}")
        if self.kind == "tree":
            d = int(self.tree_depth)
            nodes, leaves = self.tree_nodes, self.tree_leaf_scores
            if (nodes is None or leaves is None or d < 1
                    or nodes.shape != (2 ** d - 1, model.shape[1])
                    or leaves.shape != (2 ** d, R)):
                raise ValueError(
                    f"tree shortlist artifact is inconsistent: depth {d}, "
                    f"nodes {None if nodes is None else nodes.shape}, "
                    f"leaf_scores {None if leaves is None else leaves.shape}"
                    f" for model shape {model.shape}")
        return self


def build_shortlist(model) -> ShortlistArtifact:
    """Build the coarse centroid matrix from a packed `BlockSparseModel`.

    Each surviving (bl, bd) block adds its column sums to its row block's
    centroid slice, then every centroid is divided by bl, in the JAX
    package's order, so both packages write the same bytes.
    """
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    R = Lp // bl
    row_ptr = to_numpy(model.row_ptr)
    rows = to_numpy(model.block_rows)
    cols = to_numpy(model.block_cols)
    blocks = to_numpy(model.blocks).astype(np.float32, copy=False)
    C = np.zeros((R, Dp), np.float32)
    # row_ptr[-1] is the packed-block count; the all-pruned sentinel model
    # carries one zero block with row_ptr all zeros, which this skips.
    for k in range(int(row_ptr[-1])):
        r, c = int(rows[k]), int(cols[k])
        C[r, c * bd:(c + 1) * bd] += blocks[k].sum(axis=0)
    C /= float(bl)
    return ShortlistArtifact(centroids=C, block_rows=bl,
                             n_labels=model.n_labels, stat="mean")


def block_membership(Y, *, block_rows: int, n_row_blocks: int) -> np.ndarray:
    """(N, L) label matrix -> (N, R) 0/1 block-membership targets: document
    i is positive for row block r iff one of its positive labels lies in
    packed rows [r*bl, (r+1)*bl). Y must be in packed label order."""
    Yn = to_numpy(Y)
    N, L = Yn.shape
    Yb = np.zeros((N, n_row_blocks), np.float32)
    for r in range(n_row_blocks):
        lo, hi = r * block_rows, min((r + 1) * block_rows, L)
        if lo < L:
            Yb[:, r] = (Yn[:, lo:hi] > 0).any(axis=1)
    return Yb


def build_learned_shortlist(model, X, Y, *, C: float = 1.0,
                            max_newton: int = 20,
                            eps: float = 0.01) -> ShortlistArtifact:
    """Train the one-vs-rest coarse classifier over row blocks: R binary
    problems solved as one batch by the fine model's TRON batch solver
    (`DiSMECConfig(C, delta=0, eps, max_newton)`, default ops), on the
    model's device, then padded to the model's feature width. Y must be in
    packed label order."""
    import torch

    from repro_torch.core.dismec import DiSMECConfig, make_batch_solver
    bl = model.block_shape[0]
    Lp, Dp = model.shape
    R = Lp // bl
    Xn = to_numpy(X).astype(np.float32, copy=False)
    Yb = block_membership(Y, block_rows=bl, n_row_blocks=R)
    signs = (2.0 * Yb.T - 1.0).astype(np.float32)          # (R, N)
    cfg = DiSMECConfig(C=C, delta=0.0, eps=eps, max_newton=max_newton)
    solver = make_batch_solver(torch.as_tensor(Xn, device=model.device), cfg)
    W = to_numpy(solver(torch.as_tensor(signs, device=model.device), None))
    Wp = np.zeros((R, Dp), np.float32)
    Wp[:, :W.shape[1]] = W
    return ShortlistArtifact(centroids=Wp, block_rows=bl,
                             n_labels=model.n_labels, stat="ovr",
                             kind="learned")


def build_tree_shortlist(model, X, Y, *, depth: int = 3,
                         seed: int = 0) -> ShortlistArtifact:
    """Build the fixed-depth routing tree coarse stage (fastxml-style).

    Each internal node starts from a seeded random hyperplane, refined by
    three mean-difference iterations (w = mu_right - mu_left over the
    node's documents); leaves score row blocks by the positive-block
    frequency of the documents routed there. A leaf that receives no
    documents inherits its nearest ancestor's scores. Deterministic for
    fixed (X, Y, depth, seed); keeps the centroid matrix as `centroids`.
    """
    bl = model.block_shape[0]
    Lp, Dp = model.shape
    R = Lp // bl
    Xn = to_numpy(X).astype(np.float32, copy=False)
    N, D = Xn.shape
    Yb = block_membership(Y, block_rows=bl, n_row_blocks=R)
    rng = np.random.default_rng(seed)

    n_nodes = 2 ** depth - 1
    n_leaves = 2 ** depth
    nodes = np.zeros((n_nodes, Dp), np.float32)
    members: dict[int, np.ndarray] = {0: np.arange(N)}
    scores: dict[int, np.ndarray] = {}
    for i in range(n_nodes + n_leaves):
        idx = members.get(i, np.arange(0))
        if idx.size:
            freq = Yb[idx].sum(axis=0)
            scores[i] = (freq / max(float(freq.max()), 1.0)).astype(
                np.float32)
        else:
            scores[i] = scores[(i - 1) // 2]         # inherit from the parent
        if i >= n_nodes:
            continue                                   # leaf: no split
        w = rng.standard_normal(D).astype(np.float32)  # drawn per node, in
        if idx.size >= 2:                              # level order
            for _ in range(3):
                side = Xn[idx] @ w >= 0.0
                if side.all() or not side.any():
                    break
                w = (Xn[idx[side]].mean(axis=0)
                     - Xn[idx[~side]].mean(axis=0)).astype(np.float32)
            side = Xn[idx] @ w >= 0.0
            if side.all() or not side.any():
                w = np.zeros(D, np.float32)            # degenerate: all right
                side = np.ones(idx.size, bool)
            nodes[i, :D] = w
            members[2 * i + 1] = idx[~side]
            members[2 * i + 2] = idx[side]
        else:
            members[2 * i + 1] = np.arange(0)
            members[2 * i + 2] = idx                   # w = 0 routes right
    leaf_scores = np.stack([scores[n_nodes + j] for j in range(n_leaves)])
    base = build_shortlist(model)
    return ShortlistArtifact(centroids=base.centroids, block_rows=bl,
                             n_labels=model.n_labels, stat="fastxml",
                             kind="tree", tree_nodes=nodes,
                             tree_leaf_scores=leaf_scores.astype(np.float32),
                             tree_depth=int(depth))


def coarse_scores(artifact: ShortlistArtifact, x) -> np.ndarray:
    """(n, D*) queries -> (n, R) coarse row-block scores on the host (the
    reference the serving paths mirror). Pads or cuts x to the artifact's
    feature width."""
    xn = to_numpy(x).astype(np.float32, copy=False)
    Dp = artifact.centroids.shape[1]
    if xn.shape[1] < Dp:
        xn = np.concatenate(
            [xn, np.zeros((xn.shape[0], Dp - xn.shape[1]), np.float32)],
            axis=1)
    xn = xn[:, :Dp]
    if artifact.kind == "tree":
        idx = np.zeros(xn.shape[0], np.int64)
        for _ in range(int(artifact.tree_depth)):
            go_right = (xn * artifact.tree_nodes[idx]).sum(axis=1) >= 0.0
            idx = 2 * idx + 1 + go_right
        leaf = idx - (2 ** int(artifact.tree_depth) - 1)
        return artifact.tree_leaf_scores[leaf]
    return xn @ artifact.centroids.T


def cooccurrence_label_order(Y, *, block_rows: int) -> np.ndarray:
    """Deterministic co-occurrence clustering permutation over labels.

    Greedy block seriation: seed each row block with the most frequent
    unplaced label, then append the unplaced label with the highest
    co-occurrence count against the block's members (smallest id on ties)
    until the block holds `block_rows` labels or nothing co-occurs.
    Returns `order` (L,) int64 with `order[packed_pos] = original_label`:
    train under `Y[:, order]`, serve packed ids through `order[idx]`.
    O(L^2) memory and time.
    """
    Yn = (to_numpy(Y) > 0).astype(np.float32)
    L = Yn.shape[1]
    co = Yn.T @ Yn                                    # (L, L) co-occurrence
    freq = np.diag(co).copy()
    np.fill_diagonal(co, 0.0)
    placed = np.zeros(L, bool)
    order = np.empty(L, np.int64)
    pos = 0
    while pos < L:
        seed = int(np.argmax(np.where(placed, -1.0, freq)))
        order[pos] = seed
        placed[seed] = True
        pos += 1
        affinity = co[seed].copy()
        for _ in range(min(block_rows - 1, L - pos)):
            cand = np.where(placed, -1.0, affinity)
            if cand.max() <= 0.0:          # nothing co-occurs: next seed
                break
            nxt = int(np.argmax(cand))
            order[pos] = nxt
            placed[nxt] = True
            pos += 1
            affinity += co[nxt]
    return order
