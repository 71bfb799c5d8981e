"""LEML-lite: global low-rank label embedding (paper §3.3, [31]).

Solves min_{U,V} ||Y - X U V^T||_F^2 + mu(||U||^2 + ||V||^2) by alternating
ridge regressions. With power-law tail labels the low-rank assumption
fails, so this method collapses on tail-heavy data (Table 2's LEML
column).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.topk.ops import topk


@dataclasses.dataclass
class LEMLModel:
    U: torch.Tensor       # (D, r)
    V: torch.Tensor       # (L, r)

    def scores(self, X) -> torch.Tensor:
        return (as_f32(X, self.U.device) @ self.U) @ self.V.T

    def predict_topk(self, X, k: int = 5):
        return topk(self.scores(X), k)


def _init_V(L: int, r: int, seed: int, device) -> torch.Tensor:
    """V's start, N(0, 0.01^2) (L, r), from a CPU `torch.Generator` seeded
    with `seed`: the same numbers on every device. (The JAX package draws
    from `jax.random`, which torch cannot reproduce.)"""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((L, r), generator=g) * 0.01).to(device)


def train_leml(X, Y, *, rank: int = 32, mu: float = 0.1, n_alt: int = 10,
               seed: int = 0, device=None) -> LEMLModel:
    """X (N, D), Y (N, L) multi-hot -> LEMLModel on `device` (None: the
    card)."""
    device = resolve_device(device)
    X = as_f32(X, device)
    Yf = as_f32(Y, device)
    N, D = X.shape
    L = Yf.shape[1]
    r = min(rank, L, D)
    V = _init_V(L, r, seed, device)
    G = X.T @ X + mu * torch.eye(D, device=device)    # (D, D) shared Gram
    XtY = X.T @ Yf                                     # (D, L)
    # G is the same in every round: factor it once.
    G_lu, G_piv = torch.linalg.lu_factor(G)
    del G
    eye_r = mu * torch.eye(r, device=device)
    U = torch.zeros((D, r), device=device)
    for _ in range(n_alt):
        # U-step: ridge regression of Y V onto X.
        U = torch.linalg.lu_solve(G_lu, G_piv, XtY @ V)         # (D, r)
        Z = X @ U                                               # (N, r)
        # V-step: per-label ridge in the r-dim embedded space.
        V = torch.linalg.solve(Z.T @ Z + eye_r, Z.T @ Yf).T     # (L, r)
    return LEMLModel(U=U, V=V)
