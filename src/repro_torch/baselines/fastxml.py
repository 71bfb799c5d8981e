"""FastXML-lite: ensemble of random feature-space partition trees
(paper §3.3, [21]).

Each tree recursively splits the feature space with a random linear
separator refined toward the difference of its two sides' means; a leaf
stores the label frequencies of its training points, scaled to a maximum
of 1. Prediction averages the leaves reached over the ensemble. Exhibits
the paper's critique: cascaded hard partitions lose tail labels.

A tree is flat tensors (`Tree`): the split vectors of its internal nodes,
their children and the leaves' score rows, numbered in the depth-first
order in which the JAX package builds its nodes. The build works on the
index set of each node's rows (one gather per node); prediction routes
every row down the tree a level at a time on the device and reaches the
leaves the JAX package's per-row loop reaches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.topk.ops import topk


@dataclasses.dataclass
class Tree:
    """splits (S, D) float32: the plane of internal node s (x @ w > 0 goes
    right); children (S, 2) int64: the left and right child of node s,
    as codes; leaves (n_leaves, L) float32. A code c >= 0 is internal node
    c, c < 0 leaf -1 - c; `root` is the root's code, `depth` the longest
    path in splits."""
    splits: torch.Tensor
    children: torch.Tensor
    leaves: torch.Tensor
    root: int
    depth: int

    def route(self, X: torch.Tensor) -> torch.Tensor:
        """The leaf each row of X (n, D) reaches (int64 (n,))."""
        code = torch.full((X.shape[0],), self.root, dtype=torch.int64,
                          device=X.device)
        if self.depth:
            proj = X @ self.splits.T                          # (n, S)
            for _ in range(self.depth):
                node = code.clamp_min(0)
                right = proj.gather(1, node[:, None])[:, 0] > 0
                code = torch.where(code >= 0,
                                   self.children[node, right.long()], code)
        return -1 - code


@dataclasses.dataclass
class FastXMLModel:
    trees: list
    n_labels: int

    def scores(self, X) -> torch.Tensor:
        X = as_f32(X, self.trees[0].leaves.device)
        scores = torch.zeros((X.shape[0], self.n_labels),
                             dtype=torch.float32, device=X.device)
        for tree in self.trees:
            scores += tree.leaves[tree.route(X)]
        return scores / len(self.trees)

    def predict_topk(self, X, k: int = 5):
        return topk(self.scores(X), k)


def _build(X: torch.Tensor, Y: torch.Tensor, rng: np.random.Generator,
           max_depth: int, min_leaf: int) -> Tree:
    """One tree from the numpy generator `rng`, drawing one random plane
    per node that is not a leaf outright, in depth-first order (the JAX
    package's draws)."""
    device = X.device
    splits, children, leaves = [], [], []
    deepest = [0]

    def leaf(rows) -> int:
        freq = Y[rows].sum(0)
        leaves.append(freq / freq.max().clamp_min(1.0))
        return -len(leaves)

    def node(rows: torch.Tensor, depth: int) -> int:
        if depth >= max_depth or rows.numel() <= min_leaf or \
                not bool(Y[rows].any()):
            return leaf(rows)
        Xn = X if rows.numel() == X.shape[0] else X[rows]
        # A random plane, refined 3 times toward the difference of the
        # two sides' means.
        w = torch.from_numpy(rng.standard_normal(X.shape[1])
                             .astype(np.float32)).to(device)
        for _ in range(3):
            side = Xn @ w > 0
            n_right = int(side.sum())
            if n_right in (0, rows.numel()):
                break
            both = torch.stack([side, ~side]).float()      # (2, n)
            sums = both @ Xn
            w = (sums[0] / n_right - sums[1] / (rows.numel() - n_right))
        side = Xn @ w > 0
        n_right = int(side.sum())
        if n_right in (0, rows.numel()):                 # unsplittable
            return leaf(rows)
        s = len(splits)
        splits.append(w)
        children.append(None)
        deepest[0] = max(deepest[0], depth + 1)
        children[s] = (node(rows[~side], depth + 1),
                       node(rows[side], depth + 1))
        return s

    root = node(torch.arange(X.shape[0], device=device), 0)
    D = X.shape[1]
    return Tree(
        splits=torch.stack(splits) if splits else
        torch.zeros((0, D), device=device),
        children=torch.tensor(children, dtype=torch.int64,
                              device=device).reshape(-1, 2),
        leaves=torch.stack(leaves), root=root, depth=deepest[0])


def train_fastxml(X, Y, *, n_trees: int = 5, max_depth: int = 8,
                  min_leaf: int = 16, seed: int = 0,
                  device=None) -> FastXMLModel:
    """X (N, D), Y (N, L) multi-hot -> FastXMLModel on `device` (None: the
    card); tree t draws from numpy's `default_rng(seed + t)`."""
    device = resolve_device(device)
    X = as_f32(X, device)
    Yf = as_f32(Y, device)
    trees = [_build(X, Yf, np.random.default_rng(seed + t), max_depth,
                    min_leaf) for t in range(n_trees)]
    return FastXMLModel(trees=trees, n_labels=Yf.shape[1])
