"""Learning-rate schedules, evaluated in float32 as the JAX package's
jnp versions are. Each returns a function of the step (an int or a 0-d
tensor) giving the rate as a 0-d float32 tensor on the CPU."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
        return base_lr * (min_frac + (1.0 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    decay = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        s = _f32(step)
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, decay(s - warmup))
    return lr
