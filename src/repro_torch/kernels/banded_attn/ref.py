"""Plain PyTorch version of the banded attention: the JAX package's
`models/layers.py::banded_attention`, band slice by band slice.

Each chunk of `qc` queries attends to one slice of `span = window + qc`
keys ending at its last query (clamped into [0, Tk)), so memory is
O(T * (window + qc)) and it runs at T = 32,768 on the card. Scores and
softmax are float32; the weights are cast to v's type before the weighted
sum, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _largest_divisor_leq(n: int, target: int) -> int:
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_chunk: int = 512,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Tq, H, hd), k/v (B, Tk, KV, hd) -> (B, Tq, H * hd): query i
    attends to keys j with j <= i and j > i - window."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc = _largest_divisor_leq(Tq, q_chunk)
    span = min(Tk, window + qc)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, Tq, qc):
        start = min(max(q0 + qc - span, 0), Tk - span)
        kb = k[:, start:start + span].float()
        vb = v[:, start:start + span]
        qx = q[:, q0:q0 + qc].reshape(B, qc, KV, G, hd).float()
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        k_pos = torch.arange(start, start + span, device=q.device)
        s = torch.einsum("bqkgh,bskh->bkgqs", qx, kb) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        msk = (k_pos[None, :] <= q_pos[:, None]) & \
              (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(msk, s, -1e30)
        w = torch.softmax(s, dim=-1).to(vb.dtype)
        out = torch.einsum("bkgqs,bskh->bkgqh", w, vb)
        out = out.permute(0, 3, 1, 2, 4)                # (B, qc, KV, G, hd)
        outs.append(out.reshape(B, qc, H * hd).to(q.dtype))
    return torch.cat(outs, dim=1)
