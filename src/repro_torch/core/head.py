"""The LM's output layer as a DiSMEC one-vs-rest machine: its (V, d)
weight, one row per label (token), and the head losses.

The port of the JAX package's `core/head.py`. Training minimises the
per-label l2-regularised squared-hinge objective (Eq. 2.2) summed over
the vocabulary; every label's loss touches only its own weight row.
`softmax_xent_loss` is the usual LM head, the baseline. One-positive-per-
token LM targets are a special case of the multi-hot XMC objective and
are computed without building the (T, V) sign matrix.
"""

from __future__ import annotations

from typing import Optional

import torch


def init_head(generator: torch.Generator, vocab: int, d_model: int,
              dtype=torch.float32) -> torch.Tensor:
    """(vocab, d_model) weights, N(0, 1 / d_model), drawn on the
    generator's device."""
    return (torch.randn((vocab, d_model), generator=generator,
                        device=generator.device)
            * d_model ** -0.5).to(dtype)


def target_logit(z: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """z[t, targets[t]] for logits z (T, V): a gather, equal to the JAX
    package's one-hot sum (the other terms are exact zeros)."""
    return torch.gather(z, 1, targets.long()[:, None])[:, 0]


def _masked(per_tok: torch.Tensor, valid: Optional[torch.Tensor]):
    """(per-token losses zeroed off the valid tokens, their count (at
    least 1)); without a mask, every token counts."""
    if valid is None:
        return per_tok, per_tok.shape[0]
    v = valid.reshape(-1).float()
    return per_tok * v, torch.clamp(torch.sum(v), min=1.0)


def ovr_squared_hinge_loss(W: torch.Tensor, feats: torch.Tensor,
                           targets: torch.Tensor, *, C: float = 1.0,
                           reg: float = 1e-6,
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """DiSMEC OvR loss for one-positive-per-token targets.

    W (V, d) head weights, feats (..., d), targets (...,) int ids, valid
    an optional (...,) 0/1 mask of real tokens. For a token with target y
    (s_l = +1 iff l == y):

      loss_t = max(0, 1 - z_y)^2 + sum_{l != y} max(0, 1 + z_l)^2,

    computed as sum_l max(0, 1 + z_l)^2 - max(0, 1 + z_y)^2 +
    max(0, 1 - z_y)^2; plus reg * ||W||^2, the per-label regulariser."""
    f2 = feats.reshape(-1, feats.shape[-1]).float()
    z = f2 @ W.float().T                                    # (T, V) logits
    neg = torch.clamp(1.0 + z, min=0.0)
    neg_sum = torch.sum(neg * neg, dim=-1)                  # all negatives
    z_y = target_logit(z, targets.reshape(-1))
    neg_y = torch.clamp(1.0 + z_y, min=0.0)
    pos_y = torch.clamp(1.0 - z_y, min=0.0)
    per_tok = neg_sum - neg_y * neg_y + pos_y * pos_y
    per_tok, denom = _masked(per_tok, valid)
    l2 = reg * torch.sum(W.float() ** 2)
    return C * torch.sum(per_tok) / denom + l2


def ovr_multihot_loss(W: torch.Tensor, feats: torch.Tensor, Y: torch.Tensor,
                      *, C: float = 1.0, reg: float = 1e-6) -> torch.Tensor:
    """The full multi-hot XMC objective (Eq. 2.2 summed over labels):
    feats (N, d), Y (N, V) multi-hot."""
    S = 2.0 * Y.float() - 1.0                               # (N, V)
    z = feats.float() @ W.float().T
    h = torch.clamp(1.0 - S * z, min=0.0)
    l2 = reg * torch.sum(W.float() ** 2)
    return C * torch.mean(torch.sum(h * h, dim=-1)) + l2


def softmax_xent_loss(W: torch.Tensor, feats: torch.Tensor,
                      targets: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Baseline head: softmax cross-entropy."""
    f2 = feats.reshape(-1, feats.shape[-1]).float()
    z = f2 @ W.float().T
    nll = torch.logsumexp(z, dim=-1) - target_logit(z, targets.reshape(-1))
    if valid is None:
        return torch.mean(nll)
    nll, denom = _masked(nll, valid)
    return torch.sum(nll) / denom
