"""Plain PyTorch version of the fused hinge kernel.

Same function as csrc/hinge.cu and the JAX package's `_hinge_kernel`:
(f, grad, act) of the squared-hinge objective over a label batch, in fp32
whatever the input type.
"""

from __future__ import annotations

import torch


def objective_grad_act(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                       C: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    W, X, S = W.float(), X.float(), S.float()
    scores = W @ X.T
    z = 1.0 - S * scores
    act = (z > 0.0).float()
    r = act * (scores - S)
    f = (W * W).sum(-1) + C * (act * z * z).sum(-1)
    grad = 2.0 * W + 2.0 * C * (r @ X)
    return f, grad, act
