"""The coarse-stage artifact a BSR checkpoint carries (`shortlist.npz`).

Only what the checkpoint writer needs: the artifact's dataclass and the
free centroid builder, so that a checkpoint written by the port carries the
same `shortlist.npz` the JAX package writes. The coarse stages and the
shortlist backend that serve from it are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: On-disk format version written by checkpoint/io.py::save_shortlist.
#: v1 had no version/kind keys and is always a centroid artifact.
SHORTLIST_VERSION = 2


@dataclasses.dataclass
class ShortlistArtifact:
    """The coarse stage of two-stage scoring, built from a packed BSR model.

    centroids   : (R, Dp) float32 coarse scoring matrix. For
                  kind="centroid" row r is the mean weight vector of the bl
                  labels in BSR row block r.
    block_rows  : bl, the row-block height the coarse stage summarizes.
    n_labels    : true (pre-padding) label count of the source model.
    stat        : reducer/trainer tag ("mean" for centroids).
    kind        : "centroid" | "learned" | "tree".
    tree_nodes / tree_leaf_scores / tree_depth : routing tree arrays
                  (kind="tree" only).
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


def build_shortlist(model) -> ShortlistArtifact:
    """Build the coarse centroid matrix from a packed `BlockSparseModel`.

    Each surviving (bl, bd) block adds its column sums to its row block's
    centroid slice, then every centroid is divided by bl, in the JAX
    package's order, so both packages write the same bytes.
    """
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    R = Lp // bl
    row_ptr = model.row_ptr.cpu().numpy()
    rows = model.block_rows.cpu().numpy()
    cols = model.block_cols.cpu().numpy()
    blocks = model.blocks.cpu().numpy().astype(np.float32, copy=False)
    C = np.zeros((R, Dp), np.float32)
    # row_ptr[-1] is the packed-block count; the all-pruned sentinel model
    # carries one zero block with row_ptr all zeros, which this skips.
    for k in range(int(row_ptr[-1])):
        r, c = int(rows[k]), int(cols[k])
        C[r, c * bd:(c + 1) * bd] += blocks[k].sum(axis=0)
    C /= float(bl)
    return ShortlistArtifact(centroids=C, block_rows=bl,
                             n_labels=model.n_labels, stat="mean")
