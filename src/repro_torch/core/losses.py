"""Objective, gradient and Hessian-vector products of DiSMEC's per-label
solves, batched over labels (the port's plain solver ops).

The paper (Eq. 2.2) trains, for every label l, an l2-regularized
squared-hinge binary SVM over the shared design matrix X:

    f(w) = ||w||^2 + C * sum_i max(0, 1 - s_i w^T x_i)^2

Weights have shape (L, D) and sign matrices (L, N), so a whole label batch
runs as matrix products (the paper's one-label-per-core layer 2 recast as
batching). These are the counterparts of the JAX package's
`core/losses.py`, computed with `torch.matmul` (the JAX package leaves them
to XLA, outside any Pallas kernel); the fused kernels of the "pallas" solver
ops compute `objective_grad_act` and `hessian_vp` in CUDA instead.

Conventions: X (N, D) dense design matrix, S (L, N) signs in {+1, -1},
W (L, D) one row per label; math in float32.
"""

from __future__ import annotations

import torch


def margins(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor
            ) -> torch.Tensor:
    """z_{l,i} = 1 - s_{l,i} * <w_l, x_i>   of shape (L, N)."""
    return 1.0 - S * (W @ X.T)


def active_mask(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor
                ) -> torch.Tensor:
    """Active set I_l = {i : z_{l,i} > 0} as a float mask, (L, N)."""
    return (margins(W, X, S) > 0.0).float()


def objective(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
              C: float) -> torch.Tensor:
    """f(w_l) per label, shape (L,)."""
    hinge = margins(W, X, S).clamp_min(0.0)
    return (W * W).sum(-1) + C * (hinge * hinge).sum(-1)


def objective_grad_act(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                       C: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f (L,), grad (L, D), act (L, N)).

    grad f(w_l) = 2 w_l + 2C X_I^T (X_I w_l - s_I). The active mask comes
    from the same score pass; TRON (core/tron.py) hands it to every
    Hessian-vector product at this iterate, so CG never re-runs the score
    product just to rebuild the mask.
    """
    scores = W @ X.T
    z = 1.0 - S * scores
    act = (z > 0.0).to(scores.dtype)
    r = act * (scores - S)                # = -act * s * z, since s^2 = 1
    f = (W * W).sum(-1) + C * (act * z * z).sum(-1)
    grad = 2.0 * W + 2.0 * C * (r @ X)
    return f, grad, act


def objective_and_grad(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                       C: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(f, grad) only: `objective_grad_act` without the mask."""
    f, grad, _ = objective_grad_act(W, X, S, C)
    return f, grad


def hessian_vp(V: torch.Tensor, X: torch.Tensor, act: torch.Tensor,
               C: float) -> torch.Tensor:
    """Generalized-Hessian vector product, batched over labels:
    H_l = 2I + 2C X^T D_l X with D_l = diag(act_l), so
    Hv_l = 2 v_l + 2C X^T (act_l * (X v_l)).

    V (L, D) directions; act (L, N) the mask at the current Newton iterate.
    """
    return 2.0 * V + 2.0 * C * ((act * (V @ X.T)) @ X)


def l1_objective_smooth_part(W: torch.Tensor, X: torch.Tensor,
                             S: torch.Tensor, C: float) -> torch.Tensor:
    """Smooth part of the l1-SVM baseline's objective, per label:
    C * sum hinge^2 (no regularizer)."""
    hinge = margins(W, X, S).clamp_min(0.0)
    return C * (hinge * hinge).sum(-1)


def l1_grad_smooth_part(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                        C: float) -> torch.Tensor:
    """Gradient of the smooth part, 2C r @ X: the gradient of
    `objective_grad_act` without its 2W term."""
    scores = W @ X.T
    act = ((1.0 - S * scores) > 0.0).to(scores.dtype)
    return 2.0 * C * ((act * (scores - S)) @ X)


def soft_threshold(W: torch.Tensor, tau) -> torch.Tensor:
    """Prox of tau * ||.||_1 (the l1 baselines' step); `tau` a float or a
    0-d tensor. sign(W) * max(|W| - tau, 0), with W's sign copied onto the
    magnitude in place: the same bits, one temporary fewer."""
    return (W.abs() - tau).clamp_min_(0.0).copysign_(W)
