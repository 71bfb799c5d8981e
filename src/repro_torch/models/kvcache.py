"""Serving caches: dense KV, ring-buffer sliding-window KV, SSM states.

The port of the JAX package's module of the same name. The cache is
stacked over layers, (n_layers, B, T_max, KV, hd), as there, so a cache
of either package carries over leaf by leaf; the port updates it in place
one layer at a time instead of returning a new one.

  dense decode : T_max = sequence length
  SWA layers   : ring buffer of T_max == window slots (pure-SWA stacks)
  SSM layers   : O(1) state tuples (models/ssm.py `MambaState`)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class CacheSpec:
    """Static description of one layer's cache."""
    kind: str                  # "attn" | "swa" | "mamba" | "hybrid"
    t_max: int                 # slots for attention-style caches


def attn_cache_shape(cfg: ArchConfig, n_layers: int, B: int, t_max: int):
    return (n_layers, B, t_max, cfg.n_kv_heads, cfg.head_dim)


def init_attn_cache(cfg: ArchConfig, n_layers: int, B: int, t_max: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    shape = attn_cache_shape(cfg, n_layers, B, t_max)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_t_max(cfg: ArchConfig, seq_len: int, *, use_swa: bool) -> int:
    """Ring buffers allocate only `window` slots."""
    if use_swa and cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len
