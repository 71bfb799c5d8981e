"""Optimizer substrate: AdamW, schedules and global-norm clipping."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
