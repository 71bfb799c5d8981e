"""Model dispatch: one entry point per architecture family.

The port of the JAX package's module of the same name. `build_model(cfg)`
returns a Model with uniform signatures, so the launcher and the serving
engine treat the architectures alike:

  init(generator)                              -> params
  prefill(params, batch, *, mesh, batch_axes, use_swa, top_k=5)
                                               -> (topk_vals, topk_idx, cache)
  decode_step(params, cache, tokens, pos, *, mesh, batch_axes, ...)
                                               -> (vals, idx, cache)
  init_cache(B, seq_len, *, use_swa, t_enc)    -> cache dict
  train_loss(params, batch, *, mesh, batch_axes) -> (loss, {"loss", "aux"})

Everything runs on `device` (the card unless the caller passes "cpu").
The decoder-only families (dense, hybrid, moe, ssm, and vlm, whose patch
embeddings go in as `batch["prefix"]`) are `transformer`'s, their params an
`LMParams`; the encoder-decoder (seamless) is `encdec`'s, its params an
`EncDecParams`, its frames `batch["prefix"]`. `train_loss`, `prefill`
and `decode_step` take a mesh (`launch/mesh.py`) and the batch axes; the
encoder-decoder's `prefill` and `decode_step` drop them, as the JAX
package's `build_model` does, so it serves over a mesh exactly as on one
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer

#: The parameter modules of the LM side.
PARAM_TYPES = (transformer.LMParams, encdec.EncDecParams)


def params_type(cfg: ArchConfig) -> type:
    return encdec.EncDecParams if cfg.is_encoder_decoder else \
        transformer.LMParams


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
    device = resolve_device(device)
    enc = cfg.is_encoder_decoder
    mod = encdec if enc else transformer

    def init(generator: torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"the generator lies on {generator.device}; "
                             f"the model on {device}")
        return mod.init_params(cfg, generator)

    def train_loss(params, batch, *, mesh=None, batch_axes=()):
        return mod.train_loss(cfg, params, batch, mesh=mesh,
                              batch_axes=batch_axes)

    def prefill_fn(params, batch, *, mesh=None, batch_axes=(),
                   use_swa: bool = False, top_k: int = 5):
        if enc:
            return encdec.prefill(cfg, params, batch["tokens"],
                                  batch["prefix"], top_k=top_k)
        return transformer.prefill(cfg, params, batch["tokens"],
                                   prefix=batch.get("prefix"), mesh=mesh,
                                   batch_axes=batch_axes, use_swa=use_swa,
                                   top_k=top_k)

    def decode_fn(params, cache, tokens, pos, *, mesh=None, batch_axes=(),
                  use_swa: bool = False, top_k: int = 5):
        if enc:
            return encdec.decode_step(cfg, params, cache, tokens, pos,
                                      top_k=top_k)
        return transformer.decode_step(cfg, params, cache, tokens, pos,
                                       mesh=mesh, batch_axes=batch_axes,
                                       use_swa=use_swa, top_k=top_k)

    def init_cache(B: int, seq_len: int, *, use_swa: bool = False,
                   t_enc=None):
        if enc:
            return encdec.init_cache(cfg, B, seq_len, t_enc or cfg.n_prefix,
                                     device=device)
        return transformer.init_cache(cfg, B, seq_len, use_swa=use_swa,
                                      device=device)

    return Model(cfg, device, init, train_loss, prefill_fn, decode_fn,
                 init_cache)
