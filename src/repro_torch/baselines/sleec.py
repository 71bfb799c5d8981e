"""SLEEC-lite: sparse local embeddings (paper §3.3, [6]).

(1) k-means cluster the training points, (2) per cluster, learn a local
low-rank label embedding (SVD of the cluster's label submatrix) and a
ridge regressor into it, (3) predict by routing a test point to its
nearest centroid and decoding the label rows of its kNN among the
cluster's training points in the embedding. Captures the locally low-rank
assumption the paper critiques.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.topk.ops import topk


@dataclasses.dataclass
class SLEECModel:
    centroids: torch.Tensor        # (n_clusters, D)
    regressors: list               # per cluster: (D, r)
    embeddings: list               # per cluster: (n_c, r) training embeddings
    labels: list                   # per cluster: (n_c, L) label rows
    knn: int

    def scores(self, X) -> torch.Tensor:
        """Each row's kNN-weighted label votes within its cluster (n, L):
        the kNN set is the top-kk of the similarities (ties to the lowest
        training row), each neighbour weighted max(sim, 0) + 1e-6."""
        X = as_f32(X, self.centroids.device)
        scores = torch.zeros((X.shape[0], self.labels[0].shape[1]),
                             dtype=torch.float32, device=X.device)
        cid = (X @ self.centroids.T).argmax(1)
        for c in range(len(self.centroids)):
            idx = torch.nonzero(cid == c)[:, 0]
            if idx.numel() == 0:
                continue
            sim = (X[idx] @ self.regressors[c]) @ self.embeddings[c].T
            kk = min(self.knn, sim.shape[1])
            w, nbr = topk(sim, kk)                       # (m, kk)
            w = w.clamp_min(0.0) + 1e-6
            votes = self.labels[c][nbr.long()]          # (m, kk, L)
            scores[idx] = (w[:, :, None] * votes).sum(1)
        return scores

    def predict_topk(self, X, k: int = 5):
        return topk(self.scores(X), k)


def _kmeans(X: torch.Tensor, k: int, iters: int = 15, seed: int = 0):
    """Spherical k-means from k rows chosen by numpy's `default_rng(seed)`
    (the JAX package's draw); returns (centroids (k, D), assignment (N,))."""
    rng = np.random.default_rng(seed)
    first = rng.choice(X.shape[0], size=k, replace=False)
    C = X[torch.from_numpy(first).to(X.device)].clone()
    for _ in range(iters):
        a = (X @ C.T).argmax(1)            # cosine-ish (rows normalized)
        onehot = (a[None, :] == torch.arange(k, device=X.device)[:, None])
        count = onehot.sum(1)
        mean = (onehot.float() @ X) / count.clamp_min(1)[:, None]
        norm = torch.linalg.vector_norm(mean, dim=1, keepdim=True)
        mean = torch.where(norm > 0, mean / norm, mean)
        C = torch.where((count > 0)[:, None], mean, C)   # empty: kept
    return C, a


def train_sleec(X, Y, *, n_clusters: int = 4, rank: int = 32, knn: int = 15,
                ridge: float = 0.1, seed: int = 0, device=None) -> SLEECModel:
    """X (N, D), Y (N, L) multi-hot -> SLEECModel on `device` (None: the
    card)."""
    device = resolve_device(device)
    X = as_f32(X, device)
    Yf = as_f32(Y, device)
    D = X.shape[1]
    C, assign = _kmeans(X, n_clusters, seed=seed)
    eye = ridge * torch.eye(D, device=device)
    regs, embs, labs = [], [], []
    for c in range(n_clusters):
        idx = torch.nonzero(assign == c)[:, 0]
        if idx.numel() < 2:
            idx = torch.arange(X.shape[0], device=device)   # global
        Yc, Xc = Yf[idx], X[idx]
        r = min(rank, *Yc.shape)
        # Local label embedding: the top-r left factors of the label
        # submatrix, scaled. Only Z Z^T = U_r S_r^2 U_r^T reaches the
        # scores (sim = X G^-1 Xc^T Z Z^T), so the SVD's column signs do
        # not matter, nor a rotation inside a degenerate singular value
        # that the cut at r leaves whole. On the card, cuSOLVER's QR-based
        # gesvd: torch's default there, the Jacobi gesvdj, stops short of
        # fp32 accuracy (on wiki31k_like its Z Z^T lay up to 3.4e-4 of the
        # magnitude from LAPACK's, gesvd's 4.9e-6 where the cut is well
        # apart; tools/torch_sleec_svd.py), enough to swap kNN neighbours.
        U, s, _ = torch.linalg.svd(
            Yc, full_matrices=False,
            **({"driver": "gesvd"} if Yc.is_cuda else {}))
        Z = U[:, :r] * s[:r]                              # (n_c, r)
        # Linear regressor X -> Z (ridge).
        Wr = torch.linalg.solve(Xc.T @ Xc + eye, Xc.T @ Z)   # (D, r)
        regs.append(Wr)
        embs.append(Z)
        labs.append(Yc)
    return SLEECModel(centroids=C, regressors=regs, embeddings=embs,
                      labels=labs, knn=knn)
