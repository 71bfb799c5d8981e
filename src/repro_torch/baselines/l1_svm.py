"""L1-SVM baseline (paper §3.3): l1-regularized OvR squared hinge via FISTA.

The paper's point (Fig. 4, §4.1): l1 gives sparser models but underfits
against l2 + Delta-pruning.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.losses import l1_grad_smooth_part, soft_threshold
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.topk.ops import topk


@dataclasses.dataclass
class LinearModel:
    """W (L, D): scores X @ W^T. Also PD-Sparse's model."""
    W: torch.Tensor

    def scores(self, X) -> torch.Tensor:
        return as_f32(X, self.W.device) @ self.W.T

    def predict_topk(self, X, k: int = 5):
        return topk(self.scores(X), k)

    @property
    def nnz(self) -> int:
        return int((self.W != 0.0).sum())


def _fista(X: torch.Tensor, S: torch.Tensor, C: float, lam: float,
           step: torch.Tensor, n_steps: int) -> torch.Tensor:
    """n_steps of FISTA on C * sum hinge^2 + lam * ||W||_1 from W = 0; `t`
    and `step` stay float32 tensors, as in the JAX package's scan."""
    W = torch.zeros((S.shape[0], X.shape[1]), dtype=torch.float32,
                    device=X.device)
    Z = W
    t = torch.ones((), dtype=torch.float32, device=X.device)
    for _ in range(n_steps):
        g = l1_grad_smooth_part(Z, X, S, C)
        W_new = soft_threshold(Z - step * g, step * lam)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        Z = W_new + ((t - 1.0) / t_new) * (W_new - W)
        W, t = W_new, t_new
    return W


def train_l1_svm(X, Y, *, C: float = 1.0, lam: float = 0.05,
                 n_steps: int = 300, device=None) -> LinearModel:
    """X (N, D), Y (N, L) multi-hot (arrays or tensors) -> LinearModel on
    `device` (None: the card)."""
    device = resolve_device(device)
    X = as_f32(X, device)
    S = 2.0 * as_f32(Y, device).T - 1.0
    D = X.shape[1]
    # Lipschitz estimate of the smooth part: 2C * sigma_max(X)^2 from 8
    # power iterations.
    v = torch.ones(D, device=device) / torch.tensor(
        float(D), device=device).sqrt()
    for _ in range(8):
        v = X.T @ (X @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    sigma2 = torch.linalg.vector_norm(X @ v) ** 2
    step = 1.0 / (2.0 * C * sigma2 + 1e-6)
    return LinearModel(W=_fista(X, S, C, lam, step, n_steps))
