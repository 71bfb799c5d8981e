"""PD-Sparse-lite (paper §3.3, [30]): multiclass separation-ranking loss
with l1 regularization, by subgradient-prox steps.

Each step pushes every active row's highest-scoring negative label down
and its lowest-scoring positive label up. The JAX package scatters those
rows into G with `.at[].add`; on the card `index_add_` adds with atomics,
whose order (and so whose bits) changes from run to run. Here each step
builds M (L, N), one +coef and one -coef per row at two distinct labels,
and takes G = M @ X: the same sums, in a fixed order.
"""

from __future__ import annotations

import torch

from repro_torch.baselines.l1_svm import LinearModel
from repro_torch.core.losses import soft_threshold
from repro_torch.device import as_f32, resolve_device

def _step(W: torch.Tensor, X: torch.Tensor, pos: torch.Tensor, lam: float,
          lr: float, M: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """One subgradient-prox step from W (L, D); `pos` = Y > 0 (N, L); M
    (L, N) and G (L, D) buffers, overwritten."""
    big = 1e30
    Z = X @ W.T                                     # (N, L)
    z_pos = torch.where(pos, Z, big)
    z_neg = torch.where(pos, -big, Z)
    margin = 1.0 - (z_pos.amin(1) - z_neg.amax(1))  # hinge on separation
    # argmax / argmin take the first index on ties, as jnp's do.
    i_neg = z_neg.argmax(1)
    i_pos = z_pos.argmin(1)
    coef = (margin > 0).float() * margin.clamp_min(0.0)
    # A row with coef > 0 has a positive and a negative label, so its two
    # entries never meet; a row with none writes zeros.
    M.zero_()
    M.scatter_(0, i_neg[None], coef[None])
    M.scatter_(0, i_pos[None], -coef[None])
    torch.matmul(M, X, out=G)
    G.mul_(lr).div_(X.shape[0])             # (lr * G) / N, as the JAX package
    return soft_threshold(torch.sub(W, G, out=G), lr * lam)


def _train(X: torch.Tensor, Y: torch.Tensor, lam: float, lr: float,
           n_steps: int) -> torch.Tensor:
    N, D = X.shape
    L = Y.shape[1]
    W = torch.zeros((L, D), dtype=torch.float32, device=X.device)
    M = torch.zeros((L, N), dtype=torch.float32, device=X.device)
    G = torch.empty_like(W)
    pos = Y > 0
    for _ in range(n_steps):
        W = _step(W, X, pos, lam, lr, M, G)
    return W


def train_pd_sparse(X, Y, *, lam: float = 0.0005, lr: float = 10.0,
                    n_steps: int = 1500, device=None) -> LinearModel:
    """X (N, D), Y (N, L) multi-hot -> a sparse `LinearModel` (L1-SVM's
    model class) on `device` (None: the card)."""
    device = resolve_device(device)
    return LinearModel(W=_train(as_f32(X, device), as_f32(Y, device), lam,
                                lr, n_steps))
