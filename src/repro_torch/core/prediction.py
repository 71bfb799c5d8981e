"""Backend-agnostic XMC scoring and ranking metrics (paper §2.2.1, §3.2).

Pure functions from (X, W) to scores / top-k. `predict_topk` backs the
dense backend; the block-sparse path lives in `repro_torch.kernels`. The
top-k orders by descending score, then ascending label id, as the JAX
package's `lax.top_k` does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.topk import ref as topk_ref


def predict_scores(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Dense score matrix (n, L) = X @ W^T."""
    return X @ W.T


def predict_topk(X: torch.Tensor, W: torch.Tensor,
                 k: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k labels per test instance. Returns (scores, indices), (n, k)."""
    return topk_ref.topk(predict_scores(X, W), k)


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
