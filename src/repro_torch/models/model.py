"""Model dispatch: one entry point per architecture family.

The port of the JAX package's module of the same name. `build_model(cfg)`
returns a Model with uniform signatures, so the launcher and the serving
engine treat the architectures alike:

  init(generator)                              -> params (an LMParams)
  prefill(params, batch, *, use_swa, top_k=5)  -> (topk_vals, topk_idx, cache)
  decode_step(params, cache, tokens, pos, ...) -> (vals, idx, cache)
  init_cache(B, seq_len, *, use_swa)           -> cache dict
  train_loss(params, batch)                    -> (loss, {"loss", "aux"})

Everything runs on `device` (the card unless the caller passes "cpu").
Every decoder-only family is ported (dense, hybrid, moe, ssm, and vlm,
whose patch embeddings go in as `batch["prefix"]`); the encoder-decoder
raises NotImplementedError naming its ROADMAP item when the model is
built.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig, device=None) -> Model:
    transformer.check_ported(cfg)
    device = resolve_device(device)

    def init(generator: torch.Generator) -> transformer.LMParams:
        if generator.device.type != device.type:
            raise ValueError(f"the generator lies on {generator.device}; "
                             f"the model on {device}")
        return transformer.init_params(cfg, generator)

    def train_loss(params, batch, *, mesh=None, batch_axes=()):
        return transformer.train_loss(cfg, params, batch, mesh=mesh,
                                      batch_axes=batch_axes)

    def prefill_fn(params, batch, *, use_swa: bool = False, top_k: int = 5):
        return transformer.prefill(cfg, params, batch["tokens"],
                                   prefix=batch.get("prefix"),
                                   use_swa=use_swa, top_k=top_k)

    def decode_fn(params, cache, tokens, pos, *, use_swa: bool = False,
                  top_k: int = 5):
        return transformer.decode_step(cfg, params, cache, tokens, pos,
                                       use_swa=use_swa, top_k=top_k)

    def init_cache(B: int, seq_len: int, *, use_swa: bool = False):
        return transformer.init_cache(cfg, B, seq_len, use_swa=use_swa,
                                      device=device)

    return Model(cfg, device, init, train_loss, prefill_fn, decode_fn,
                 init_cache)
