"""Decoder-only LM assembly: parameters, the training forward and head
losses, the serving cache, prefill and one-token decode.

The port of the JAX package's `models/transformer.py` for the decoder-only
families: `dense`, `hybrid` (hymba), `moe` (qwen2-moe, mixtral), `ssm`
(xLSTM's mLSTM and sLSTM blocks) and `vlm` (a modality prefix of patch
embeddings before the tokens). The JAX package stacks the layers'
parameters and scans over them (all but xLSTM, whose blocks differ); here
a `ModuleList` of `Block`s holds them and a Python loop runs them, so each
layer's attention window is a plain int, as the JAX package keeps it
static. `state_dict` keys are the JAX parameter paths with the layer
index spelled out (`blocks.3.attn.wq` is JAX's `blocks["attn"]["wq"][3]`,
or `blocks[3]["attn"]["wq"]` for xLSTM's list of blocks).

  train_loss  — full-sequence `forward` (each block rematerialised in the
                backward, as `jax.checkpoint` does per block) + the DiSMEC
                OvR (or softmax) head loss over token chunks
  prefill     — full-sequence forward that fills the serving cache and
                returns the last position's top-k
  decode_step — ONE token against the cache

All three run one block body (`_block`). Long sequences (T >
DENSE_ATTN_MAX_T) attend in bands where a layer's window cuts work
(`layers.banded_attention`: the banded-attention kernel on the card),
blockwise with an online softmax elsewhere. `forward` (training) gives
every layer the whole causal prefix, as the JAX package's `train_loss`
does (it passes no `use_swa`), so no kernel runs in training.
Every top-k goes through the port's top-k ops (the blocked top-k kernel
on the card).

A prefix (B, P, d) goes before the token embeddings in `forward` and
`prefill`, cast to the activations' type; `train_loss` drops its positions
from the features. The MoE layers add their router's aux loss, summed
over the layers, to `train_loss` (`router_aux_coef`).

Training over a mesh (`forward` and `train_loss` with `mesh=`, the port's
grid of devices): each batch shard's backbone runs forward and backward on
its cell's device with a copy of the weights (`sharding.row_shards`,
`sharding.replicas`), the MoE layers dispatch each shard's tokens at the
shard's capacity with the experts' d_ff split over the model axis, and the
head losses run one (row shard x label shard) block per cell, their
partial sums added in a fixed order on the first cell.

Serving over a mesh (`prefill` and `decode_step` with `mesh=`): each row
shard runs the one-device body on its cell with the weights placed there
once per (params, mesh) (`sharding.serving_placement`), its MoE layers
as in training, its cache on its cell (`sharding.MeshCache`); the head's
label shards each take a top-k and one more top-k merges them
(`prediction.predict_topk_sharded`, as XMC serving's). `prefill`
and `decode_step` run under `torch.inference_mode`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prediction
from repro_torch.core.head import init_head, target_logit
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.models import layers, moe, sharding, ssm
from repro_torch.models.layers import matmul, param

def check_decoder_only(cfg: ArchConfig) -> None:
    """This module's stacks are decoder-only; an encoder-decoder config
    runs in models/encdec.py (`models.model.build_model` picks it)."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its model is "
                         "models/encdec.py, through models.model.build_model")


# ---------------------------------------------------------------------------
# Block kinds and windows
# ---------------------------------------------------------------------------

def block_kind(cfg: ArchConfig, idx: int) -> str:
    if cfg.family == "ssm":
        pat = cfg.block_pattern or ("m",)
        return {"m": "mlstm", "s": "slstm"}[pat[idx % len(pat)]]
    if cfg.family == "hybrid":
        return "hybrid"
    return "attn"


def uses_layer_scan(cfg: ArchConfig) -> bool:
    """Every block has the same parameter structure (all but xLSTM): the
    JAX package scans over such stacks; its caches stack over layers."""
    return cfg.family != "ssm"


def layer_windows_static(cfg: ArchConfig, *, use_swa: bool) -> tuple:
    """Per-layer window sizes as Python ints; 0 = full attention.
    hymba: SWA everywhere except global_attn_layers; mixtral: SWA
    everywhere; dense --swa variant: SWA everywhere."""
    w = cfg.sliding_window if (cfg.sliding_window and use_swa) else 0
    wins = [w] * cfg.n_layers
    for g in cfg.global_attn_layers:
        if g < cfg.n_layers:
            wins[g] = 0
    return tuple(wins)


def window_segments(cfg: ArchConfig, *, use_swa: bool) -> list:
    """Maximal runs of consecutive layers sharing a window:
    [(start, end, window), ...]."""
    wins = layer_windows_static(cfg, use_swa=use_swa)
    segs, s = [], 0
    for i in range(1, len(wins) + 1):
        if i == len(wins) or wins[i] != wins[s]:
            segs.append((s, i, wins[s]))
            s = i
    return segs


#: The window bound of a full-attention layer in one-token decode.
FULL_WINDOW = 2 ** 30


def layer_windows(cfg: ArchConfig, *, use_swa: bool) -> tuple:
    """Per-layer window bound of the one-token decode, where the window is
    only a mask bound: full-attention layers get FULL_WINDOW."""
    return tuple(w if w > 0 else FULL_WINDOW
                 for w in layer_windows_static(cfg, use_swa=use_swa))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    """norm1; the mixer: attn [+ mamba for hybrid], or `mixer` (an mLSTM
    or sLSTM); then, when d_ff > 0, norm2 and the FFN: mlp, or moe for the
    moe family."""

    def __init__(self, cfg: ArchConfig, mixers: dict,
                 ffn: Optional[nn.Module], device=None):
        super().__init__()
        self.norm1 = layers.init_norm(cfg, cfg.d_model, device=device)
        for name, m in mixers.items():
            self.add_module(name, m)
        if cfg.d_ff > 0:
            self.norm2 = layers.init_norm(cfg, cfg.d_model, device=device)
            self.add_module("moe" if cfg.family == "moe" else "mlp", ffn)


def _make_block(cfg: ArchConfig, kind: str, dtype, device,
                generator: Optional[torch.Generator] = None) -> Block:
    """A block of `kind`, its values drawn from `generator` (mixers, then
    the FFN, as the JAX package draws them) or, without one, left unset."""
    g, d = generator, cfg.d_model
    drawn = g is not None
    mixers: dict = {}
    if kind in ("attn", "hybrid"):
        mixers["attn"] = (layers.init_attention(cfg, g, dtype) if drawn else
                          layers.Attention(cfg, dtype, device=device))
    if kind == "hybrid":
        mixers["mamba"] = (ssm.init_mamba(cfg, g, dtype, d) if drawn else
                           ssm.Mamba(cfg, dtype, d, device=device))
    if kind in ("mlstm", "slstm"):
        cls, init = ((ssm.MLSTM, ssm.init_mlstm) if kind == "mlstm" else
                     (ssm.SLSTM, ssm.init_slstm))
        mixers["mixer"] = (init(cfg, g, dtype) if drawn else
                           cls(cfg, dtype, device=device))
    ffn = None
    if cfg.d_ff > 0 and cfg.family == "moe":
        ffn = (moe.init_moe(cfg, g, dtype) if drawn else
               moe.MoE(cfg, dtype, device=device))
    elif cfg.d_ff > 0:
        ffn = (layers.init_mlp(g, d, cfg.d_ff, dtype, cfg.act) if drawn else
               layers.MLP(d, cfg.d_ff, dtype, cfg.act, device=device))
    return Block(cfg, mixers, ffn, device=device)


class LMParams(nn.Module):
    """embed (Vp, d), final_norm, blocks (a ModuleList of n_layers Blocks)
    and head (Vp, d) unless the embeddings are tied; `cfg` is the config
    they were made for. With a generator the values are drawn from it, on
    its device (embed, then the blocks in order, then head); without one
    they are left unset for `convert.lm_params_from_jax` to load."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_decoder_only(cfg)
        self.cfg = cfg
        if generator is not None:
            device = generator.device
        dtype, Vp, d = _dtype(cfg), cfg.padded_vocab(), cfg.d_model
        self.embed = param(
            torch.empty((Vp, d), dtype=dtype, device=device)
            if generator is None else
            layers.normal(generator, (Vp, d), d ** -0.5, dtype))
        self.final_norm = layers.init_norm(cfg, d, device=device)
        self.blocks = nn.ModuleList(
            _make_block(cfg, block_kind(cfg, i), dtype, device, generator)
            for i in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.head = param(
                torch.empty((Vp, d), dtype=dtype, device=device)
                if generator is None else
                init_head(generator, Vp, d, dtype))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> LMParams:
    """Random parameters drawn from `generator`, on its device, with the
    JAX package's distributions (not its numbers: the generators differ)."""
    return LMParams(cfg, generator=generator)


def head_weight(cfg: ArchConfig, params: LMParams) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.head


# ---------------------------------------------------------------------------
# Full-sequence attention and mixing
# ---------------------------------------------------------------------------

def _attention_window(cfg: ArchConfig, p: layers.Attention, x: torch.Tensor,
                      positions: torch.Tensor, window: int,
                      project: bool = True, rope=None):
    """Attention with a static window (0 = full) -> (out, k, v), k and v
    for the cache. Long sequences go to banded_attention (only each
    query's band of keys) when the window cuts work, else to the
    online-softmax blockwise attention. project=False skips @wo (the
    hybrid block fuses it with the mamba out-projection). `rope`: the
    stack's `layers.rope_tables`."""
    T = x.shape[1]
    q, k, v = layers._qkv(cfg, p, x, positions, rope)
    if T > layers.DENSE_ATTN_MAX_T:
        if window and window < T:
            out = layers.banded_attention(cfg, q, k, v, window=window)
        else:
            out = layers.blockwise_attention(cfg, q, k, v,
                                             window=window or None)
    else:
        mask = layers.causal_mask(T, T, window=window or None,
                                  device=x.device)
        out = layers._sdpa(cfg, q, k, v, mask)
    return (matmul(out, p.wo) if project else out), k, v


def _hybrid_mix(cfg: ArchConfig, blk: Block, h: torch.Tensor,
                positions: torch.Tensor, window: int, rope=None):
    """hymba's parallel attention and mamba heads, mean-combined as
    (0.5 * [ctx, y]) @ [[wo], [w_out]] -> (mix, k, v, mamba state)."""
    ctx, k, v = _attention_window(cfg, blk.attn, h, positions, window,
                                  project=False, rope=rope)   # (B,T,H*hd)
    y, sst = ssm.mamba(cfg, blk.mamba, h, cfg.d_model, return_state=True,
                       project=False)
    w_cat = torch.cat([blk.attn.wo, blk.mamba.w_out], dim=0)
    mixed = torch.cat([ctx, y.to(ctx.dtype)], dim=-1)
    return matmul(0.5 * mixed, w_cat), k, v, sst


def _ffn(cfg: ArchConfig, blk: Block, x: torch.Tensor, cells=()):
    """The FFN sublayer and its residual -> (x, MoE aux loss or None).
    `cells`: the devices of the model axis a MoE splits its experts'
    d_ff over (a batch shard's, in training over a mesh)."""
    aux = None
    if cfg.d_ff > 0:
        h = layers.apply_norm(cfg, blk.norm2, x)
        if cfg.family == "moe":
            out, aux = moe.moe_ffn(cfg, blk.moe, h, cells=cells)
        else:
            out = layers.mlp(blk.mlp, h, cfg.act)
        x = x + out
    return x, aux


def _block(cfg: ArchConfig, blk: Block, kind: str, x: torch.Tensor,
           positions: torch.Tensor, window: int, rope=None, cells=()):
    """One block over the full sequence -> (x, k, v, recurrent state, aux):
    norm1, the mix (attention, with Mamba for hybrid; or an mLSTM or
    sLSTM), the residual, the FFN. k and v are None for xLSTM blocks, the
    state None for attention blocks, aux None outside the moe family."""
    h = layers.apply_norm(cfg, blk.norm1, x)
    k = v = sst = None
    if kind == "hybrid":
        mix, k, v, sst = _hybrid_mix(cfg, blk, h, positions, window, rope)
    elif kind == "attn":
        mix, k, v = _attention_window(cfg, blk.attn, h, positions, window,
                                      rope=rope)
    elif kind == "mlstm":
        mix, sst = ssm.mlstm(cfg, blk.mixer, h, return_state=True)
    else:
        mix, sst = ssm.slstm(cfg, blk.mixer, h, return_state=True)
    x, aux = _ffn(cfg, blk, x + mix, cells)
    return x, k, v, sst, aux


# ---------------------------------------------------------------------------
# Training: forward and the head losses
# ---------------------------------------------------------------------------

def _with_prefix(cfg: ArchConfig, x: torch.Tensor, prefix) -> torch.Tensor:
    """[prefix, x] along the sequence: the modality prefix (B, P, d_model)
    cast to the embeddings' type, before the token embeddings x."""
    if prefix is None:
        return x
    prefix = _on(prefix, x.device)
    if prefix.ndim != 3 or prefix.shape[0] != x.shape[0] or \
            prefix.shape[2] != cfg.d_model:
        raise ValueError(f"a prefix is (B, P, d_model) = ({x.shape[0]}, P, "
                         f"{cfg.d_model}); got {tuple(prefix.shape)}")
    return torch.cat([prefix.to(x.dtype), x], dim=1)


def forward(cfg: ArchConfig, params: "LMParams", tokens,
            prefix: Optional[torch.Tensor] = None, *, mesh=None,
            batch_axes=(), remat: bool = True, cells=()):
    """Embeds tokens (after the modality prefix, if any), runs the stack,
    returns (final-norm features (B, P + T, d), aux), with autograd. Every
    layer attends over the whole causal prefix, as the JAX package's
    `train_loss` runs its `forward` (no `use_swa`): the banded-attention
    kernel has no backward. remat: each block's activations are recomputed
    in the backward (one (B, T, d) input kept per block), as the JAX
    package's `jax.checkpoint` per block with no saving policy. aux is the
    MoE router loss summed over the layers, 0 for the other families.

    With a mesh: each batch shard (`sharding.row_shards`) runs this
    forward on its cell's device with a copy of the weights, its MoE
    layers split over its row of the model axis (`cells`); the features
    come back to the weights' device in shard order, and aux is the mean
    of the shards' (the JAX MoE island's pmean)."""
    check_decoder_only(cfg)
    if mesh is not None:
        return _forward_mesh(cfg, params, tokens, prefix, mesh, batch_axes,
                             remat)
    # F.embedding, not indexing: on the card its backward sums the rows of
    # a repeated token in a fixed order, so two steps give the same bits.
    x = F.embedding(_tokens(tokens, params.embed.device), params.embed)
    x = _with_prefix(cfg, x, prefix)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    rope = layers.rope_tables(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(params.blocks):
        fn = partial(_block_out, cfg, blk, block_kind(cfg, i),
                     positions=positions, window=0, rope=rope, cells=cells)
        x, a = checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False) if remat else fn(x)
        if a is not None:
            aux = aux + a
    x = layers.apply_norm(cfg, params.final_norm, x)
    return x, aux


def _block_out(cfg, blk, kind, x, *, positions, window, rope, cells):
    out = _block(cfg, blk, kind, x, positions, window, rope, cells)
    return out[0], out[4]


def _forward_mesh(cfg, params, tokens, prefix, mesh, batch_axes, remat):
    dev = params.embed.device
    tokens = _tokens(tokens, dev)
    shards = _mesh_shards(cfg, mesh, tokens.shape[0], batch_axes)
    feats, aux = [], None
    for s, p in zip(shards, sharding.replicas(params, [s.device
                                                       for s in shards])):
        pre = None if prefix is None else _on(prefix, dev)[s.rows]
        f, a = forward(cfg, p, tokens[s.rows], pre, remat=remat,
                       cells=s.cells)
        feats.append(f.to(dev))
        aux = a.to(dev) if aux is None else aux + a.to(dev)
    return torch.cat(feats), aux / len(shards)


# Token-chunk size for the head losses: the (tokens, labels) logit block is
# the largest activation of training. Each chunk's block is rebuilt in the
# backward (the paper's Algorithm-1 outer batch loop, applied to the head).
HEAD_CHUNK = 32768


def _chunked_rows(n: int, target: Optional[int] = None) -> int:
    c = layers.largest_divisor_leq(n, HEAD_CHUNK if target is None
                                   else target)
    return c if c > 1 else n


def _chunked_sum(chunk_fn, f2, t2, v2) -> torch.Tensor:
    """sum of chunk_fn over token chunks of `_chunked_rows` rows, each
    chunk rematerialised in the backward, added in order from 0."""
    n = f2.shape[0]
    c = _chunked_rows(n)
    if c == n:
        return chunk_fn(f2, t2, v2)
    total = torch.zeros((), dtype=torch.float32, device=f2.device)
    for a in range(0, n, c):
        total = total + checkpoint(chunk_fn, f2[a:a + c], t2[a:a + c],
                                   v2[a:a + c], use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def _rows(feats, targets, valid):
    """(feats (n, d) float32, targets (n,) long, valid (n,) float32: ones
    without a mask)."""
    f2 = feats.reshape(-1, feats.shape[-1]).float()
    t2 = _tokens(targets, f2.device).reshape(-1)
    v2 = (_on(valid, f2.device).reshape(-1).float() if valid is not None
          else torch.ones(f2.shape[0], dtype=torch.float32,
                          device=f2.device))
    return f2, t2, v2


def _label_block(z: torch.Tensor, t: torch.Tensor, offset: int):
    """(z at each row's target where the target lies in this block of
    labels [offset, offset + z.shape[1]), else 0; where it does)."""
    local = t - offset
    inside = (local >= 0) & (local < z.shape[1])
    z_y = target_logit(z, local.clamp(0, z.shape[1] - 1))
    return torch.where(inside, z_y, 0.0), inside


def _ovr_block(f: torch.Tensor, W: torch.Tensor, t: torch.Tensor,
               v: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The OvR squared hinge of the rows f against the labels W (the
    block [offset, offset + len(W)) of the vocabulary), summed with the
    row weights v: every label a negative, the target's term swapped for
    a positive one where the target lies in the block."""
    z = f @ W.T                                         # (c, labels)
    z_y, inside = _label_block(z, t, offset)
    neg = torch.clamp(1.0 + z, min=0.0)
    neg_sum = torch.sum(neg * neg, dim=-1)
    neg_y = torch.clamp(1.0 + z_y, min=0.0)
    pos_y = torch.clamp(1.0 - z_y, min=0.0)
    per_tok = (neg_sum - torch.where(inside, neg_y * neg_y, 0.0)
               + torch.where(inside, pos_y * pos_y, 0.0))
    return torch.sum(per_tok * v)


def _mesh_head_total(cells_fn, Wf, f2, t2, v2, mesh, batch_axes):
    """The head's sum over the mesh (`sharding.head_cells`): cell (i, j)
    holds row shard i's features and label shard j's weights (copies whose
    gradients are summed in a fixed order); `cells_fn(fs, Ws, ts, vs,
    offsets)` gives one row chunk's total on the row shard's first cell
    from the per-cell lists. Chunks (`_chunked_rows` of a row shard, each
    rematerialised in the backward) are added in order, then the row
    shards on the first cell."""
    rows, M, devs = sharding.head_cells(mesh, f2.shape[0], batch_axes)
    edges = [Wf.shape[0] * j // M for j in range(M + 1)]
    W_cells = [sharding.replicate(Wf[a:b], [d[j] for d in devs])
               for j, (a, b) in enumerate(zip(edges, edges[1:]))]
    first = Wf.device
    total = None
    for i, rs in enumerate(rows):
        fs = sharding.replicate(f2[rs], devs[i])
        ts = [t2[rs].to(d) for d in devs[i]]
        vs = [v2[rs].to(d) for d in devs[i]]
        Ws = [W_cells[j][i] for j in range(M)]
        n = rs.stop - rs.start
        c = _chunked_rows(n)

        def chunk(*flat):
            return cells_fn(*(list(flat[k * M:(k + 1) * M])
                              for k in range(3)), Ws, edges[:-1])
        part = None
        for a in range(0, n, c):
            flat = [x[a:a + c] for x in (*fs, *ts, *vs)]
            r = chunk(*flat) if c == n else checkpoint(
                chunk, *flat, use_reentrant=False, preserve_rng_state=False)
            part = r if part is None else part + r
        part = part.to(first)
        total = part if total is None else total + part
    return total


def _ovr_cells(fs, ts, vs, Ws, offsets):
    part = None
    for f, t, v, W, off in zip(fs, ts, vs, Ws, offsets):
        blk = _ovr_block(f, W, t, v, off).to(fs[0].device)
        part = blk if part is None else part + blk
    return part


def ovr_loss_from_feats(cfg: ArchConfig, W: torch.Tensor,
                        feats: torch.Tensor, targets, valid=None, *,
                        mesh=None, batch_axes=()) -> torch.Tensor:
    """DiSMEC OvR squared-hinge loss over the padded vocabulary, token
    chunk by token chunk: C * sum of per-token losses / valid tokens +
    ovr_reg * ||W||^2.

    With a mesh, the paper's layer-1 parallelism: the rows go over the
    batch axes minus `model`, the labels over `model`, and cell (i, j)
    computes its independent (row shard x label shard) block of the hinge
    sum; the blocks' partial sums are added on the first cell in a fixed
    order (j within a row shard, then i)."""
    f2, t2, v2 = _rows(feats, targets, valid)
    Wf = W.float()
    if mesh is None:
        total = _chunked_sum(lambda f, t, v: _ovr_block(f, Wf, t, v),
                             f2, t2, v2)
    else:
        total = _mesh_head_total(_ovr_cells, Wf, f2, t2, v2, mesh,
                                 batch_axes)
    denom = (torch.clamp(torch.sum(v2), min=1.0) if valid is not None
             else f2.shape[0])
    l2 = cfg.ovr_reg * torch.sum(Wf ** 2)
    return cfg.ovr_C * total / denom + l2


def _softmax_cells(fs, ts, vs, Ws, offsets):
    """One row chunk's summed cross-entropy over the label shards: each
    cell's max, sum of exp and target logit, combined on the first cell
    (the logsumexp's max and sum across the label shards)."""
    d0 = fs[0].device
    ms, ss, zys = [], [], []
    for f, t, W, off in zip(fs, ts, Ws, offsets):
        z = f @ W.T
        m = z.amax(dim=-1).detach()
        ms.append(m.to(d0))
        ss.append(torch.exp(z - m[:, None]).sum(dim=-1).to(d0))
        zys.append(_label_block(z, t, off)[0].to(d0))
    m = torch.stack(ms).amax(dim=0)
    s = ss[0] * torch.exp(ms[0] - m)
    z_y = zys[0]
    for j in range(1, len(ms)):
        s = s + ss[j] * torch.exp(ms[j] - m)
        z_y = z_y + zys[j]
    return torch.sum((m + torch.log(s) - z_y) * vs[0])


def softmax_loss_from_feats(W: torch.Tensor, feats: torch.Tensor, targets,
                            valid=None, *, mesh=None,
                            batch_axes=()) -> torch.Tensor:
    """The baseline softmax cross-entropy head, token-chunked like the OvR
    head. With a mesh, cells as the OvR head's; the logsumexp needs each
    row's max and sum of exp across the label shards, the collectives the
    DiSMEC head does without."""
    f2, t2, v2 = _rows(feats, targets, valid)
    Wf = W.float()

    def chunk_nll(f_c, t_c, v_c):
        z = f_c @ Wf.T
        nll = torch.logsumexp(z, dim=-1) - target_logit(z, t_c)
        return torch.sum(nll * v_c)

    if mesh is None:
        total = _chunked_sum(chunk_nll, f2, t2, v2)
    else:
        total = _mesh_head_total(_softmax_cells, Wf, f2, t2, v2, mesh,
                                 batch_axes)
    denom = (torch.clamp(torch.sum(v2), min=1.0) if valid is not None
             else f2.shape[0])
    return total / denom


def train_loss(cfg: ArchConfig, params: "LMParams", batch: dict, *,
               mesh=None, batch_axes=()):
    """batch: tokens (B, T), targets (B, T), valid (B, T) [+ prefix
    (B, P, d)], as numpy arrays or tensors -> (loss + router_aux_coef *
    aux, {"loss", "aux"}). The prefix positions carry no target."""
    prefix = batch.get("prefix")
    feats, aux = forward(cfg, params, batch["tokens"], prefix=prefix,
                         mesh=mesh, batch_axes=batch_axes)
    if prefix is not None:
        feats = feats[:, prefix.shape[1]:]
    W = head_weight(cfg, params)
    if cfg.head_type == "dismec":
        loss = ovr_loss_from_feats(cfg, W, feats, batch["targets"],
                                   batch.get("valid"), mesh=mesh,
                                   batch_axes=batch_axes)
    else:
        loss = softmax_loss_from_feats(W, feats, batch["targets"],
                                       batch.get("valid"), mesh=mesh,
                                       batch_axes=batch_axes)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, one-token decode
# ---------------------------------------------------------------------------

def decode_cache_len(cfg: ArchConfig, seq_len: int, *, use_swa: bool) -> int:
    """Uniform per-layer cache length. Pure-SWA stacks (dense --swa)
    ring-buffer at `window`; stacks with any global layer (hymba)
    allocate full length (the window mask still applies per layer)."""
    if cfg.sliding_window and use_swa and not cfg.global_attn_layers:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _state_init(cfg: ArchConfig, kind: str, B: int, device=None):
    if kind == "mlstm":
        return ssm.mlstm_init_state(cfg, B, device=device)
    return ssm.slstm_init_state(cfg, B, device=device)


def init_cache(cfg: ArchConfig, B: int, seq_len: int, *, use_swa: bool,
               dtype=torch.bfloat16, device=None) -> dict:
    """Serving cache: "k", "v" (n_layers, B, T, KV, hd) and, for hybrid
    stacks, "ssm" (a MambaState stacked over layers); for xLSTM, "states":
    one float32 MLSTMState or SLSTMState per layer."""
    check_decoder_only(cfg)
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"states": [_state_init(cfg, block_kind(cfg, i), B, device)
                           for i in range(L)]}
    t_eff = decode_cache_len(cfg, seq_len, use_swa=use_swa)
    shape = (L, B, t_eff, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        st = ssm.mamba_init_state(cfg, B, cfg.d_model, device=device)
        cache["ssm"] = ssm.MambaState(
            *(torch.zeros((L,) + a.shape, dtype=a.dtype, device=device)
              for a in st))
    return cache


def _decode_valid(T_max: int, pos: int, eff: int, device) -> torch.Tensor:
    """(1, 1, 1, 1, T_max) mask of the cache slots the token at `pos`
    attends to: slot s holds the absolute position p_s with
    p_s % T_max == s; valid iff written and within the window `eff`."""
    slots = torch.arange(T_max, device=device)
    abs_pos = pos - (pos - slots) % T_max
    valid = (abs_pos >= 0) & (abs_pos > pos - eff) & (abs_pos <= pos)
    return valid[None, None, None, None, :]


def _attention_decode_dyn(cfg: ArchConfig, p: layers.Attention,
                          x: torch.Tensor, positions: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: int, eff: int, valid=None,
                          rope=None) -> torch.Tensor:
    """One-token attention against one layer's cache (B, T_max, KV, hd),
    written in place at slot pos % T_max; `eff` bounds the window. `valid`
    (`_decode_valid`) and `rope` (`layers.rope_tables`), if the caller has
    them, are shared by the layers of a step."""
    T_max = k_cache.shape[1]
    q, k, v = layers._qkv(cfg, p, x, positions, rope)
    slot = pos % T_max
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    if valid is None:
        valid = _decode_valid(T_max, pos, eff, x.device)
    out = layers._sdpa(cfg, q, k_cache, v_cache, valid)
    return matmul(out, p.wo)


def _decode_block(cfg: ArchConfig, blk: Block, kind: str, x: torch.Tensor,
                  positions: torch.Tensor, window: int, kc, vc, sst,
                  pos: int, valid=None, rope=None, cells=()):
    """One decode block: x (B, 1, d) -> (x, recurrent state); kc and vc
    (None for xLSTM blocks) are updated in place."""
    h = layers.apply_norm(cfg, blk.norm1, x)
    if kind == "mlstm":
        mix, sst = ssm.mlstm_decode(cfg, blk.mixer, h, sst)
    elif kind == "slstm":
        mix, sst = ssm.slstm_decode(cfg, blk.mixer, h, sst)
    else:
        mix = _attention_decode_dyn(cfg, blk.attn, h, positions, kc, vc,
                                    pos, window, valid, rope)
    if kind == "hybrid":
        m, sst = ssm.mamba_decode(cfg, blk.mamba, h, sst, cfg.d_model)
        mix = 0.5 * (mix + m)
    return _ffn(cfg, blk, x + mix, cells)[0], sst


def _on(a, device) -> torch.Tensor:
    """An array-like or tensor as a tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))               # a writable copy
    return a.to(device)


def _tokens(tokens, device) -> torch.Tensor:
    return _on(tokens, device).long()


def _top_k(cfg: ArchConfig, params: LMParams, x: torch.Tensor, k: int):
    """Top-k of the head's logits for the features x (B, d), in float32:
    the blocked top-k kernel on the card, the stable sort on the CPU."""
    W = head_weight(cfg, params)
    logits = x.float() @ W.float().T
    return topk_ops.topk(logits, k)


def _mesh_shards(cfg: ArchConfig, mesh, B: int, batch_axes) -> list:
    """The backbone's row shards of a B-row batch on the mesh (training
    and serving alike)."""
    shards = sharding.row_shards(mesh, B, batch_axes)
    if cfg.family == "moe" and len(shards[0].cells) == 1 and \
            mesh.shape["model"] > 1:
        # The JAX island would shard these tokens over `model` and still
        # add the model cells' partial outputs: other tokens' rows.
        raise ValueError(f"{cfg.name}: a MoE's batch shards cannot span the "
                         f"model axis (batch axes {tuple(batch_axes)})")
    return shards


def _decode_body(cfg: ArchConfig, params: LMParams, cache: dict, tokens,
                 pos: int, use_swa: bool, cells=None) -> torch.Tensor:
    """One token (B, 1) through the stack against `cache` (updated in
    place; xLSTM's states replaced in its list) -> the final-norm features
    (B, d). `cells`: per layer, what a MoE layer splits its experts over
    (none: one device)."""
    x = params.embed[_tokens(tokens, params.embed.device)]      # (B, 1, d)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    wins = layer_windows(cfg, use_swa=use_swa)
    cells = cells or [()] * cfg.n_layers
    if cfg.family == "ssm":
        states = cache["states"]
        for i, blk in enumerate(params.blocks):
            x, states[i] = _decode_block(cfg, blk, block_kind(cfg, i), x,
                                         positions, wins[i], None, None,
                                         states[i], pos, cells=cells[i])
        return layers.apply_norm(cfg, params.final_norm, x)[:, 0]
    T_max = cache["k"].shape[2]
    valid = {w: _decode_valid(T_max, pos, w, x.device) for w in set(wins)}
    rope = layers.rope_tables(cfg, positions)
    for i, blk in enumerate(params.blocks):
        kind = block_kind(cfg, i)
        sst = None
        if kind == "hybrid":
            sst = ssm.MambaState(cache["ssm"].h[i], cache["ssm"].conv[i])
        x, sst = _decode_block(cfg, blk, kind, x, positions, wins[i],
                               cache["k"][i], cache["v"][i], sst, pos,
                               valid[wins[i]], rope, cells[i])
        if kind == "hybrid":
            cache["ssm"].h[i].copy_(sst.h)
            cache["ssm"].conv[i].copy_(sst.conv)
    return layers.apply_norm(cfg, params.final_norm, x)[:, 0]


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: LMParams, cache, tokens,
                pos: int, *, mesh=None, batch_axes=(), use_swa: bool = False,
                top_k: int = 5):
    """ONE new token (B, 1) against the cache at position `pos` ->
    (top-k values, top-k ids int32, cache), the cache updated in place
    (xLSTM's per-layer states replaced in its list).

    With a mesh, as `prefill`'s: each row shard's token against its own
    cache (a `sharding.MeshCache`, as `prefill(mesh=)` returns it; a
    one-device cache is split over the row shards first, once), the
    top-k merged over the label shards; the MeshCache is returned."""
    check_decoder_only(cfg)
    pos = int(pos)
    if mesh is None:
        x = _decode_body(cfg, params, cache, tokens, pos, use_swa)
        vals, idx = _top_k(cfg, params, x, top_k)
        return vals, idx, cache
    placed = sharding.serving_placement(params, mesh,
                                        head_weight(cfg, params))
    tokens = _tokens(tokens, params.embed.device)
    shards = _mesh_shards(cfg, mesh, tokens.shape[0], batch_axes)
    if not isinstance(cache, sharding.MeshCache):
        cache = sharding.split_cache(cache, shards)
    if cache.rows != tuple(s.rows for s in shards):
        raise ValueError(f"a cache of row shards {cache.rows} for a step "
                         f"of row shards {[s.rows for s in shards]}")
    feats = [_decode_body(cfg, placed.params(s.device), c,
                          tokens[s.rows].to(s.device), pos, use_swa,
                          placed.experts(s.cells))
             for s, c in zip(shards, cache.shards)]
    vals, idx = _mesh_top_k(mesh, placed, feats, top_k)
    return vals, idx, cache


def _prefill_body(cfg: ArchConfig, params: LMParams, tokens, prefix,
                  use_swa: bool, cells=None):
    """The full-sequence forward that fills a new serving cache -> (the
    final-norm features of the last position (B, d), cache). `cells`: per
    layer, what a MoE layer splits its experts over (none: one
    device)."""
    x = params.embed[_tokens(tokens, params.embed.device)]
    x = _with_prefix(cfg, x, prefix)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    wins = layer_windows_static(cfg, use_swa=use_swa)
    t_eff = decode_cache_len(cfg, T, use_swa=use_swa)
    cache = init_cache(cfg, B, t_eff, use_swa=use_swa, device=x.device)
    rope = layers.rope_tables(cfg, positions)
    cells = cells or [()] * cfg.n_layers
    states = []
    for i, blk in enumerate(params.blocks):
        x, k, v, sst, _ = _block(cfg, blk, block_kind(cfg, i), x,
                                 positions, wins[i], rope, cells[i])
        if cfg.family == "ssm":
            cache["states"][i] = sst
            continue
        if sst is not None:
            states.append(sst)
        cache["k"][i].copy_(k[:, T - t_eff:])
        cache["v"][i].copy_(v[:, T - t_eff:])
    if states:
        cache["ssm"] = ssm.MambaState(*(torch.stack(a) for a in
                                        zip(*states)))
    return layers.apply_norm(cfg, params.final_norm, x)[:, -1], cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: LMParams, tokens,
            prefix: Optional[torch.Tensor] = None, *, mesh=None,
            batch_axes=(), use_swa: bool = False, top_k: int = 5):
    """Full-sequence forward that fills the serving cache -> (top-k
    values, top-k ids int32, cache) at the last position (k = 5, as the
    JAX package fixes it). A prefix (B, P, d) goes before the tokens and
    takes the first P positions of the cache. Cache length == sequence
    length (bf16, as the JAX package stores it); xLSTM's cache holds each
    layer's state after the sequence.

    With a mesh: each row shard (`sharding.row_shards` of the batch axes)
    runs this forward on its cell with the weights placed there once
    (`sharding.serving_placement`), its MoE layers at the shard's own
    capacity with the experts' d_ff split over the shard's cells (as
    training's `forward(mesh=)`; mLSTM, sLSTM and Mamba as on one
    device, as JAX serving passes them no mesh). The head is split into
    label shards over `model`: each label shard's cell takes the top-k of
    its logits for every row, and the candidates, gathered on the first
    cell in shard order, are merged by one more top-k, so a tie goes to
    the lowest global id, as `lax.top_k` of the full logits gives it. The
    cache is a `sharding.MeshCache` (each row shard's on its cell), which
    `decode_step(mesh=)` continues; values and ids lie on the mesh's
    first cell."""
    check_decoder_only(cfg)
    if mesh is None:
        x, cache = _prefill_body(cfg, params, tokens, prefix, use_swa)
        vals, idx = _top_k(cfg, params, x, top_k)
        return vals, idx, cache
    placed = sharding.serving_placement(params, mesh,
                                        head_weight(cfg, params))
    dev = params.embed.device
    tokens = _tokens(tokens, dev)
    shards = _mesh_shards(cfg, mesh, tokens.shape[0], batch_axes)
    feats, caches = [], []
    for s in shards:
        pre = None if prefix is None else _on(prefix, dev)[s.rows]
        f, c = _prefill_body(cfg, placed.params(s.device),
                             tokens[s.rows].to(s.device), pre, use_swa,
                             placed.experts(s.cells))
        feats.append(f)
        caches.append(c)
    vals, idx = _mesh_top_k(mesh, placed, feats, top_k)
    return vals, idx, sharding.MeshCache(tuple(s.rows for s in shards),
                                         caches)


def _mesh_top_k(mesh, placed, feats: list, k: int):
    """The top-k of the head's logits over the label shards
    (`predict_topk_sharded` on the placed head): every row shard's
    features, in row order and float32 as `_top_k`'s, go to each label
    shard's cell for its top-k, and the candidates are merged on the
    first cell, a tie going to the lowest global id."""
    x = torch.cat([f.to(mesh.first) for f in feats]).float()
    return prediction.predict_topk_sharded(x, placed.head, k, mesh)
