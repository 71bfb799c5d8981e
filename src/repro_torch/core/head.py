"""The LM's output layer as a DiSMEC one-vs-rest machine: its (V, d)
weight, one row per label (token).

The port of `init_head` from the JAX package's `core/head.py`; the OvR
head losses come with LM training.
"""

from __future__ import annotations

import torch


def init_head(generator: torch.Generator, vocab: int, d_model: int,
              dtype=torch.float32) -> torch.Tensor:
    """(vocab, d_model) weights, N(0, 1 / d_model), drawn on the
    generator's device."""
    return (torch.randn((vocab, d_model), generator=generator,
                        device=generator.device)
            * d_model ** -0.5).to(dtype)
