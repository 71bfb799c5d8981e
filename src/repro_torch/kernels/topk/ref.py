"""Plain PyTorch versions of the top-k: the whole function, and the
blocked stage the CUDA kernel computes.

Ties order by ascending label id everywhere, as `lax.top_k` and the TPU
kernel's first argmax order them. `torch.topk` does not promise that
order, so neither version uses it.
"""

from __future__ import annotations

import torch

#: Score of a label that must never be served (block padding).
NEG_INF = float(-3.0e38)


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids) each (n, k): descending value, then ascending id."""
    vals, ids = torch.sort(scores.float(), dim=1, descending=True,
                           stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def blocked_topk(scores: torch.Tensor, k: int, *,
                 bL: int) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (n, L), L % bL == 0 -> per-block candidates (vals, idx) each
    (n, (L / bL) * k), idx global: k rounds of masked max per block, the
    lowest index first on ties, each winner masked to NEG_INF."""
    n, L = scores.shape
    if L % bL:
        raise ValueError(f"score width {L} is not a multiple of bL={bL}")
    nb = L // bL
    s = scores.float().reshape(n, nb, bL)
    col = torch.arange(bL, device=s.device)
    base = (torch.arange(nb, device=s.device) * bL)[None, :]
    vals, idx = [], []
    for _ in range(k):
        m = s.amax(dim=2)
        am = torch.where(s == m[..., None], col, bL).amin(dim=2)
        vals.append(m)
        idx.append(am + base)
        s = torch.where(col == am[..., None], NEG_INF, s)
    vals = torch.stack(vals, dim=2).reshape(n, nb * k)
    idx = torch.stack(idx, dim=2).reshape(n, nb * k).to(torch.int32)
    return vals, idx
