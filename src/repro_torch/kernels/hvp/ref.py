"""Plain PyTorch version of the Hessian-vector-product kernel.

Same function as csrc/hvp.cu and the JAX package's `_hvp_kernel`:
Hv = 2V + 2C (act * (V X^T)) X, in fp32 whatever the input type.
"""

from __future__ import annotations

import torch


def hessian_vp(V: torch.Tensor, X: torch.Tensor, act: torch.Tensor,
               C: float) -> torch.Tensor:
    V, X, act = V.float(), X.float(), act.float()
    Xv = V @ X.T
    return 2.0 * V + 2.0 * C * ((act * Xv) @ X)
