"""Backend-agnostic XMC scoring and ranking metrics (paper §2.2.1, §3.2).

Pure functions from (X, W) to scores / top-k. `predict_topk` backs the
dense backend, `predict_topk_sharded` the mesh-sharded one; the
block-sparse path lives in `repro_torch.kernels`. The top-k orders by
descending score, then ascending label id, as the JAX package's
`lax.top_k` does.

The paper stores the per-batch block matrices W^1..W^B on separate nodes,
scores every block in parallel and merges to a top-k. On a mesh, W is
label-sharded over the `model` axis: each shard scores its own rows on its
own device, takes a local top-k, and only the k x n_shards candidates are
gathered and merged, never the full L-wide score row.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import ref as topk_ref


def predict_scores(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Dense score matrix (n, L) = X @ W^T."""
    return X @ W.T


def predict_topk(X: torch.Tensor, W: torch.Tensor,
                 k: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k labels per test instance. Returns (scores, indices), (n, k)."""
    return topk_ref.topk(predict_scores(X, W), k)


def shard_rows(W: torch.Tensor, mesh, *, label_axis: str = "model"
               ) -> list[torch.Tensor]:
    """W (L, D), L a multiple of the label-axis extent, as one contiguous
    row shard per label shard, each on its device (the mesh's cell at data
    index 0)."""
    n_shards = mesh.shape[label_axis]
    if W.shape[0] % n_shards:
        raise ValueError(f"pad the {W.shape[0]} labels to a multiple of "
                         f"the {n_shards} label shards first")
    per = W.shape[0] // n_shards
    return [W[j * per:(j + 1) * per].to(mesh.device(**{label_axis: j}))
            .contiguous() for j in range(n_shards)]


def predict_topk_sharded(X: torch.Tensor,
                         W: Union[torch.Tensor, Sequence[torch.Tensor]],
                         k: int, mesh, *, label_axis: str = "model",
                         n_labels: Optional[int] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Label-sharded prediction with a local top-k and a global merge.

    X (n, D) goes to every shard's device. W is (L, D) with L a multiple
    of the label shard count, or its row shards already placed
    (`shard_rows`). Each shard's scores are `X @ W_s.T`; ids >= `n_labels`
    score NEG_INF, so a padded W serves no phantom label. The local and
    the merge top-k go through `kernels.topk.ops.topk` (the blocked top-k
    kernel on the card): the candidates are gathered in shard order on
    the mesh's first device, so ties keep the lowest global id. Returns
    (scores, ids (int32)) each (n, k) there.
    """
    shards = (shard_rows(W, mesh, label_axis=label_axis)
              if isinstance(W, torch.Tensor) else list(W))
    if len(shards) != mesh.shape[label_axis]:
        raise ValueError(f"{len(shards)} row shards for "
                         f"{mesh.shape[label_axis]} label shards")
    per = shards[0].shape[0]
    if per < k:
        raise ValueError(f"label shards of {per} rows cannot give a top-{k}")
    home = mesh.first
    vals, ids = [], []
    for j, W_s in enumerate(shards):
        scores = X.to(W_s.device) @ W_s.T                 # (n, L / shards)
        offset = j * per
        if n_labels is not None and n_labels < offset + per:
            local = torch.arange(per, device=W_s.device) + offset
            scores = torch.where(local[None, :] < n_labels, scores,
                                 topk_ref.NEG_INF)
        v, i = topk_ops.topk(scores, k)                   # local top-k
        vals.append(v.to(home))
        ids.append((i + offset).to(home))
    v_all, i_all = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
    top, pos = topk_ops.topk(v_all, k)                    # the merge
    return top, torch.gather(i_all, 1, pos.long())


# ---------------------------------------------------------------------------
# Metrics (paper §3.2). Y_true is (n, L) multi-hot; topk_idx is (n, k).
# ---------------------------------------------------------------------------

def _hits(Y_true: torch.Tensor, topk_idx: torch.Tensor,
          k: int) -> torch.Tensor:
    return torch.gather(Y_true.float(), 1, topk_idx[:, :k].long())


def precision_at_k(Y_true: torch.Tensor, topk_idx: torch.Tensor,
                   k: int) -> torch.Tensor:
    """P@k = (1/k) sum_{l in rank_k(yhat)} y_l (averaged over instances)."""
    return torch.mean(_hits(Y_true, topk_idx, k).sum(dim=1) / k)


def ndcg_at_k(Y_true: torch.Tensor, topk_idx: torch.Tensor,
              k: int) -> torch.Tensor:
    """nDCG@k with the paper's normalization:
    DCG@k / sum_{l=1..min(k,|y|)} 1/log2(l+1)."""
    hits = _hits(Y_true, topk_idx, k)                        # (n, k)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=hits.device)
    discount = 1.0 / torch.log2(ranks + 1.0)
    dcg = torch.sum(hits * discount, dim=1)
    n_pos = Y_true.float().sum(dim=1)
    cum = torch.cumsum(discount, dim=0)
    idx = torch.clamp(n_pos.clamp(max=k).long() - 1, 0, k - 1)
    norm = cum[idx]
    return torch.mean(torch.where(n_pos > 0, dcg / norm, 0.0))


def evaluate(Y_true: torch.Tensor, topk_idx: torch.Tensor,
             ks: tuple[int, ...] = (1, 3, 5)) -> dict[str, float]:
    out = {}
    for k in ks:
        out[f"P@{k}"] = float(precision_at_k(Y_true, topk_idx, k))
        out[f"nDCG@{k}"] = float(ndcg_at_k(Y_true, topk_idx, k))
    return out
