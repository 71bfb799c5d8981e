"""Encoder-decoder assembly (seamless-m4t-medium [arXiv:2308.11596]).

The port of the JAX package's module of the same name. The modality
frontend (mel spectrogram and conv feature extractor) is a stub there and
here: the batch's `prefix` holds precomputed frame embeddings (B, T_enc, d),
and this module is the transformer backbone: a bidirectional encoder over
the frames and a causal decoder with cross-attention in every layer, on
the shared `layers` primitives (seamless's 16 kv heads make its GQA plain
multi-head attention).

Parameters (`EncDecParams`): embed, enc_blocks (norm1, attn, norm2, mlp),
enc_norm, dec_blocks (norm1, attn, norm_x, xattn, norm2, mlp), final_norm
and head. The JAX package stacks each block list over its own layer count
(`n_encoder_layers or n_layers` encoder layers); here they are
ModuleLists, so `enc_blocks.3.attn.wq` is JAX's `enc_blocks["attn"]["wq"][3]`.

  train_loss  — `encode` then `decode_train` (each block rematerialised in
                the backward) + the DiSMEC OvR (or softmax) head; aux 0
  prefill     — encode the frames, decode the prompt, fill every cache
                (self k/v, the memory's k/v once) -> the last top-k
  decode_step — one decoder token against the self cache and the cached
                memory k/v

The serving cache is `k`, `v` (L, B, T, KV, hd) and `mem_k`, `mem_v`
(L, B, T_enc, KV, hd), bf16. Prefill's cache is exactly T long, as the
JAX package's is: a decode at pos = T wraps into slot 0 (ROADMAP Queue C,
mirrored). Every top-k goes through the port's top-k ops (the blocked
top-k kernel on the card). `prefill` and `decode_step` run under
`torch.inference_mode`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.head import init_head
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.models import layers, sharding
from repro_torch.models.layers import matmul, param
from repro_torch.models.transformer import (FULL_WINDOW, _attention_decode_dyn,
                                            _dtype, _on, _tokens,
                                            ovr_loss_from_feats,
                                            softmax_loss_from_feats)


class EncBlock(nn.Module):
    """norm1, attn, norm2, mlp."""

    def __init__(self, cfg: ArchConfig, dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, g = cfg.d_model, generator
        self.norm1 = layers.init_norm(cfg, d, device=device)
        self.attn = (layers.init_attention(cfg, g, dtype) if g is not None
                     else layers.Attention(cfg, dtype, device=device))
        self.norm2 = layers.init_norm(cfg, d, device=device)
        self.mlp = (layers.init_mlp(g, d, cfg.d_ff, dtype, cfg.act)
                    if g is not None else
                    layers.MLP(d, cfg.d_ff, dtype, cfg.act, device=device))


class DecBlock(nn.Module):
    """norm1, attn, norm_x, xattn (cross-attention), norm2, mlp."""

    def __init__(self, cfg: ArchConfig, dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, g = cfg.d_model, generator

        def attn():
            return (layers.init_attention(cfg, g, dtype) if g is not None
                    else layers.Attention(cfg, dtype, device=device))
        self.norm1 = layers.init_norm(cfg, d, device=device)
        self.attn = attn()
        self.norm_x = layers.init_norm(cfg, d, device=device)
        self.xattn = attn()
        self.norm2 = layers.init_norm(cfg, d, device=device)
        self.mlp = (layers.init_mlp(g, d, cfg.d_ff, dtype, cfg.act)
                    if g is not None else
                    layers.MLP(d, cfg.d_ff, dtype, cfg.act, device=device))


def n_encoder_layers(cfg: ArchConfig) -> int:
    return cfg.n_encoder_layers or cfg.n_layers


class EncDecParams(nn.Module):
    """embed (Vp, d), enc_blocks, enc_norm, dec_blocks, final_norm, head
    (Vp, d); `cfg` is the config they were made for. With a generator the
    values are drawn from it, on its device, in the JAX package's order;
    without one they are left unset for `convert.lm_params_from_jax`."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if generator is not None:
            device = generator.device
        dtype, Vp, d = _dtype(cfg), cfg.padded_vocab(), cfg.d_model
        self.embed = param(
            torch.empty((Vp, d), dtype=dtype, device=device)
            if generator is None else
            layers.normal(generator, (Vp, d), d ** -0.5, dtype))
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype, device, generator)
            for _ in range(n_encoder_layers(cfg)))
        self.enc_norm = layers.init_norm(cfg, d, device=device)
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.final_norm = layers.init_norm(cfg, d, device=device)
        self.head = param(
            torch.empty((Vp, d), dtype=dtype, device=device)
            if generator is None else init_head(generator, Vp, d, dtype))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> EncDecParams:
    """Random parameters drawn from `generator`, on its device, with the
    JAX package's distributions (not its numbers: the generators differ)."""
    return EncDecParams(cfg, generator=generator)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device).expand(B, T)


def _enc_block(cfg, b: EncBlock, x, *, positions):
    h = layers.apply_norm(cfg, b.norm1, x)
    x = x + layers.attention(cfg, b.attn, h, positions, is_causal=False)
    h2 = layers.apply_norm(cfg, b.norm2, x)
    return x + layers.mlp(b.mlp, h2, cfg.act)


def encode(cfg: ArchConfig, params: EncDecParams, frames,
           remat: bool = True) -> torch.Tensor:
    """The bidirectional encoder over the stub frame embeddings (B, T_enc,
    d), cast to the parameters' type -> the memory (B, T_enc, d). remat:
    each block recomputed in the backward, as `jax.checkpoint` per block."""
    x = _on(frames, params.embed.device).to(_dtype(cfg))
    B, T, _ = x.shape
    positions = _positions(B, T, x.device)
    for b in params.enc_blocks:
        fn = partial(_enc_block, cfg, b, positions=positions)
        x = checkpoint(fn, x, use_reentrant=False,
                       preserve_rng_state=False) if remat else fn(x)
    return layers.apply_norm(cfg, params.enc_norm, x)


def _memory_kv(cfg: ArchConfig, blk: DecBlock, memory: torch.Tensor):
    """A decoder block's cross-attention k and v (B, S, KV, hd) of the
    memory."""
    B, S, _ = memory.shape
    k = matmul(memory, blk.xattn.wk).reshape(B, S, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = matmul(memory, blk.xattn.wv).reshape(B, S, cfg.n_kv_heads,
                                             cfg.head_dim)
    return k, v


def _dec_block(cfg, b: DecBlock, x, memory, *, positions):
    h = layers.apply_norm(cfg, b.norm1, x)
    x = x + layers.attention(cfg, b.attn, h, positions)
    hx = layers.apply_norm(cfg, b.norm_x, x)
    x = x + layers.cross_attention(cfg, b.xattn, hx,
                                   _memory_kv(cfg, b, memory))
    h2 = layers.apply_norm(cfg, b.norm2, x)
    return x + layers.mlp(b.mlp, h2, cfg.act)


def decode_train(cfg: ArchConfig, params: EncDecParams, tokens,
                 memory: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """The causal decoder with cross-attention to `memory` -> final-norm
    features (B, T, d)."""
    x = F.embedding(_tokens(tokens, params.embed.device), params.embed)
    B, T, _ = x.shape
    positions = _positions(B, T, x.device)
    for b in params.dec_blocks:
        fn = partial(_dec_block, cfg, b, positions=positions)
        x = checkpoint(fn, x, memory, use_reentrant=False,
                       preserve_rng_state=False) if remat else fn(x, memory)
    return layers.apply_norm(cfg, params.final_norm, x)


def _features(cfg: ArchConfig, params: EncDecParams, batch: dict, mesh,
              batch_axes) -> torch.Tensor:
    """`decode_train` of `encode`. Over a mesh each batch shard
    (`sharding.row_shards`) encodes and decodes on its cell's device, with
    a copy of the weights; the features come back to the weights' device
    in shard order."""
    if mesh is None:
        return decode_train(cfg, params, batch["tokens"],
                            encode(cfg, params, batch["prefix"]))
    dev = params.embed.device
    tokens = _tokens(batch["tokens"], dev)
    frames = _on(batch["prefix"], dev)
    shards = sharding.row_shards(mesh, tokens.shape[0], batch_axes)
    feats = []
    for s, p in zip(shards, sharding.replicas(params, [s.device
                                                       for s in shards])):
        memory = encode(cfg, p, frames[s.rows])
        feats.append(decode_train(cfg, p, tokens[s.rows], memory).to(dev))
    return torch.cat(feats)


def train_loss(cfg: ArchConfig, params: EncDecParams, batch: dict, *,
               mesh=None, batch_axes=()):
    """batch: prefix (the frames, B, T_enc, d), tokens, targets [+ valid]
    -> (loss, {"loss", "aux": 0}). With a mesh, the backbone runs batch
    shard by batch shard and the head loss is label-sharded over the
    cells (`transformer.ovr_loss_from_feats`)."""
    feats = _features(cfg, params, batch, mesh, batch_axes)
    if cfg.head_type == "dismec":
        loss = ovr_loss_from_feats(cfg, params.head, feats, batch["targets"],
                                   batch.get("valid"), mesh=mesh,
                                   batch_axes=batch_axes)
    else:
        loss = softmax_loss_from_feats(params.head, feats, batch["targets"],
                                       batch.get("valid"), mesh=mesh,
                                       batch_axes=batch_axes)
    return loss, {"loss": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                   device=loss.device)}


def init_cache(cfg: ArchConfig, B: int, seq_len: int, t_enc: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeros: `k`, `v` (L, B, seq_len, KV, hd), `mem_k`, `mem_v`
    (L, B, t_enc, KV, hd)."""
    L = cfg.n_layers
    kv = (L, B, seq_len, cfg.n_kv_heads, cfg.head_dim)
    mem = (L, B, t_enc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "mem_k": torch.zeros(mem, dtype=dtype, device=device),
            "mem_v": torch.zeros(mem, dtype=dtype, device=device)}


def _top_k(params: EncDecParams, x: torch.Tensor, k: int):
    """Top-k of the head's float32 logits for the features x (B, d): the
    blocked top-k kernel on the card, the stable sort on the CPU."""
    return topk_ops.topk(x.float() @ params.head.float().T, k)


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: EncDecParams, tokens, frames, *,
            top_k: int = 5):
    """Encode the frames, decode the prompt (B, T), fill the caches ->
    (top-k values, ids int32, cache) at the last position. The memory's
    k/v are computed once per layer; the cache stores them, and the
    prompt's k/v, in bf16 (the prefill itself attends with them unrounded,
    as the JAX package's does)."""
    memory = encode(cfg, params, frames, remat=False)
    x = params.embed[_tokens(tokens, params.embed.device)]
    B, T, _ = x.shape
    positions = _positions(B, T, x.device)
    cache = init_cache(cfg, B, T, memory.shape[1], device=x.device)
    for i, blk in enumerate(params.dec_blocks):
        h = layers.apply_norm(cfg, blk.norm1, x)
        q, k, v = layers._qkv(cfg, blk.attn, h, positions)
        if T > layers.DENSE_ATTN_MAX_T:
            a = layers.blockwise_attention(cfg, q, k, v)
        else:
            a = layers._sdpa(cfg, q, k, v,
                             layers.causal_mask(T, T, device=x.device))
        x = x + matmul(a, blk.attn.wo)
        hx = layers.apply_norm(cfg, blk.norm_x, x)
        mk, mv = _memory_kv(cfg, blk, memory)
        x = x + layers.cross_attention(cfg, blk.xattn, hx, (mk, mv))
        h2 = layers.apply_norm(cfg, blk.norm2, x)
        x = x + layers.mlp(blk.mlp, h2, cfg.act)
        for key, t in (("k", k), ("v", v), ("mem_k", mk), ("mem_v", mv)):
            cache[key][i].copy_(t)
    x = layers.apply_norm(cfg, params.final_norm, x)
    vals, idx = _top_k(params, x[:, -1], top_k)
    return vals, idx, cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: EncDecParams, cache: dict, tokens,
                pos: int, *, top_k: int = 5):
    """ONE decoder token (B, 1) at position `pos` against the self cache
    (written in place at slot pos % T) and the cached memory k/v ->
    (top-k values, ids int32, cache)."""
    x = params.embed[_tokens(tokens, params.embed.device)]      # (B, 1, d)
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    for i, blk in enumerate(params.dec_blocks):
        h = layers.apply_norm(cfg, blk.norm1, x)
        x = x + _attention_decode_dyn(cfg, blk.attn, h, positions,
                                      cache["k"][i], cache["v"][i], pos,
                                      FULL_WINDOW)
        hx = layers.apply_norm(cfg, blk.norm_x, x)
        x = x + layers.cross_attention(cfg, blk.xattn, hx,
                                       (cache["mem_k"][i], cache["mem_v"][i]))
        h2 = layers.apply_norm(cfg, blk.norm2, x)
        x = x + layers.mlp(blk.mlp, h2, cfg.act)
    x = layers.apply_norm(cfg, params.final_norm, x)
    vals, idx = _top_k(params, x[:, 0], top_k)
    return vals, idx, cache
