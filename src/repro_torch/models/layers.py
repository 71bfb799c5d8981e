"""Shared transformer layers: norms, RoPE, GQA attention, MLP.

The port of the JAX package's module of the same name. Parameters live in
small `nn.Module`s whose attribute names are the JAX parameter keys
(`wq`, `wk`, ..., `scale`), so a module's `state_dict` keys are the JAX
tree's paths; the functions take `(cfg, p, x, ...)` as the JAX ones do.
Every parameter is created with `requires_grad=False`: this is the
serving side.

`attention` (causal, or an encoder's bidirectional), `cross_attention`
(against an encoder's memory) and `attention_decode` (one token against a
cache) are the JAX module's; the decoder-only stacks compose their own
from `_qkv` and `_sdpa` (models/transformer.py).

Attention variants: GQA with any kv_heads, RoPE on a fraction of the head
dims (chatglm3 rotates half), per-head qk RMS-norm (qwen3), QKV bias
(qwen1.5), sliding-window causal masks (hymba, mixtral, and the --swa
variant of the dense archs).

PyTorch does not promote types in a matrix product as jnp does, so the
products that mix types in the JAX package (an f32 activation against
bf16 weights) go through `matmul`, which widens both sides first.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.banded_attn import ops as banded_ops

#: Above this sequence length attention never materialises dense scores.
DENSE_ATTN_MAX_T = 2048


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter: no gradient."""
    return nn.Parameter(t, requires_grad=False)


def normal(generator: torch.Generator, shape, scale: float,
           dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from `generator` on its device, then
    cast, as the JAX package draws and casts."""
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * scale).to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in the wider of the two types (jnp's promotion)."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """`scale` (and `bias` for layernorm), float32."""

    def __init__(self, cfg: ArchConfig, d: int, device=None):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros(d, dtype=torch.float32,
                                          device=device))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def apply_norm(cfg: ArchConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias)
    return rmsnorm(x, p.scale)


def init_norm(cfg: ArchConfig, d: int, device=None) -> Norm:
    return Norm(cfg, d, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rot_dims(cfg: ArchConfig) -> int:
    rot = int(cfg.head_dim * cfg.rope_fraction)
    return rot - rot % 2


def rope_freqs(cfg: ArchConfig, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary fraction of head_dim."""
    rot = _rot_dims(cfg)
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """(cos, sin), each (B, T, 1, rot/2), for positions (B, T); None when
    no dims rotate. Every layer of a stack shares them: the stack computes
    them once a call (XLA finds that for the JAX package)."""
    if _rot_dims(cfg) == 0:
        return None
    ang = positions[..., None].float() * rope_freqs(cfg, positions.device)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
               tables=None) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int. Rotates the first
    rope_fraction of head dims (chatglm3 rotates half), passes the rest.
    `tables`: `rope_tables(cfg, positions)`, if the caller has them."""
    rot = _rot_dims(cfg)
    if rot == 0:
        return x
    cos, sin = tables if tables is not None else rope_tables(cfg, positions)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).flatten(-2)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq (d, q_dim), wk and wv (d, kv_dim), wo (q_dim, d) [+ bq, bk, bv]
    [+ q_norm, k_norm]."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

        def new(*shape, dt=dtype):
            return param(torch.empty(shape, dtype=dt, device=device))
        self.wq, self.wk, self.wv, self.wo = (new(d, qd), new(d, kvd),
                                              new(d, kvd), new(qd, d))
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = new(qd), new(kvd), new(kvd)
        if cfg.qk_norm:
            self.q_norm = new(cfg.head_dim, dt=torch.float32)
            self.k_norm = new(cfg.head_dim, dt=torch.float32)


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   dtype) -> Attention:
    p = Attention(cfg, dtype, device=generator.device)
    s = cfg.d_model ** -0.5
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(p, name)
            w.copy_(normal(generator, w.shape, s, dtype))
        for name in ("bq", "bk", "bv"):
            if hasattr(p, name):
                getattr(p, name).zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(p, name):
                getattr(p, name).fill_(1.0)
    return p


def _qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor,
         positions: torch.Tensor, rope=None):
    B, T, _ = x.shape
    q, k, v = matmul(x, p.wq), matmul(x, p.wk), matmul(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:                       # qwen3: per-head RMS on q and k
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    rope = rope if rope is not None else rope_tables(cfg, positions)
    return (apply_rope(cfg, q, positions, rope),
            apply_rope(cfg, k, positions, rope), v)


def _softcap(cfg: ArchConfig, s: torch.Tensor) -> torch.Tensor:
    c = cfg.attn_logit_softcap
    return c * torch.tanh(s / c) if c else s


def _sdpa(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd) -> (B,Tq,H*hd). GQA via head
    groups; scores and softmax in float32, the weights cast to v's type."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    # (B, KV, G * Tq, hd) @ (B, KV, hd, Tk): a group's heads share k and v.
    qg = q.reshape(B, Tq, KV, G, hd).permute(0, 2, 3, 1, 4) \
        .reshape(B, KV, G * Tq, hd)
    scores = (qg.float() @ k.permute(0, 2, 3, 1).float()) \
        .view(B, KV, G, Tq, Tk)
    scores = _softcap(cfg, scores / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = w.view(B, KV, G * Tq, Tk) @ v.permute(0, 2, 1, 3)
    return out.view(B, KV, G, Tq, hd).permute(0, 3, 1, 2, 4) \
        .reshape(B, Tq, H * hd)


def largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (chunk sizes must tile T)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def blockwise_attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *, window: Optional[int] = None,
                        is_causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention with an online softmax, in plain torch
    ops: never materialises the (Tq, Tk) scores; the working set is one
    (B, H, q_chunk, kv_chunk) tile. The JAX package's recurrence, tile by
    tile, except that a causal query chunk stops at its last key chunk:
    a tile wholly after the diagonal is masked everywhere and, since every
    row has met its own key by then, leaves (m, l, acc) exactly as they
    were.

    q (B,Tq,H,hd), k/v (B,Tk,KV,hd) -> (B,Tq,H*hd)
    """
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = largest_divisor_leq(Tq, q_chunk)
    kv_chunk = largest_divisor_leq(Tk, kv_chunk)
    nk = Tk // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, Tq, q_chunk):
        qx = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, KV, G, hd).float()
        q_pos = torch.arange(q0, q0 + q_chunk, device=q.device)
        m = torch.full((B, KV, G, q_chunk), -1e30, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=q.device)
        last = min(nk, (q0 + q_chunk - 1) // kv_chunk + 1) if is_causal \
            else nk
        for k0 in range(0, last * kv_chunk, kv_chunk):
            kx = k[:, k0:k0 + kv_chunk]
            vx = v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qx, kx.float()) * scale
            s = _softcap(cfg, s)
            if is_causal:
                k_pos = torch.arange(k0, k0 + kv_chunk, device=q.device)
                msk = k_pos[None, :] <= q_pos[:, None]
                if window is not None:
                    msk &= k_pos[None, :] > q_pos[:, None] - window
                s = torch.where(msk, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vx.dtype), vx).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = out.permute(0, 3, 1, 2, 4)                 # (B,qc,KV,G,hd)
        outs.append(out.reshape(B, q_chunk, H * hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def banded_attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, window: int,
                     q_chunk: int = 512) -> torch.Tensor:
    """Sliding-window attention that visits only each query's band of
    keys: the banded-attention kernel on the card, its plain version
    (the JAX package's band slices, `q_chunk` queries at a time) on the
    CPU. q (B,Tq,H,hd), k/v (B,Tk,KV,hd) -> (B,Tq,H*hd). Causal."""
    return banded_ops.banded_attention(q, k, v, window=window,
                                       softcap=cfg.attn_logit_softcap,
                                       q_chunk=q_chunk)


def causal_mask(Tq: int, Tk: int, *, q_offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """(1,1,1,Tq,Tk) boolean mask; window => sliding-window causal."""
    qi = torch.arange(Tq, device=device)[:, None] + q_offset
    ki = torch.arange(Tk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m = m & (ki > qi - window)
    return m[None, None, None, :, :]


def attention(cfg: ArchConfig, p: Attention, x: torch.Tensor,
              positions: torch.Tensor, *, window: Optional[int] = None,
              is_causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (an encoder's with is_causal=False):
    dense scores up to DENSE_ATTN_MAX_T, the online-softmax blockwise
    attention above."""
    T = x.shape[1]
    q, k, v = _qkv(cfg, p, x, positions)
    if T > DENSE_ATTN_MAX_T:
        out = blockwise_attention(cfg, q, k, v, window=window,
                                  is_causal=is_causal)
    else:
        mask = causal_mask(T, T, window=window, device=x.device) \
            if is_causal else None
        out = _sdpa(cfg, q, k, v, mask)
    return matmul(out, p.wo)


def cross_attention(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                    memory_kv: tuple) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B, S, KV,
    hd): the queries take wq alone (no bias, norm or rotation, as in the
    JAX package); above DENSE_ATTN_MAX_T queries, blockwise against the
    memory."""
    B, T, _ = x.shape
    q = matmul(x, p.wq).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k, v = memory_kv
    if T > DENSE_ATTN_MAX_T:
        out = blockwise_attention(cfg, q, k, v, is_causal=False)
    else:
        out = _sdpa(cfg, q, k, v, None)
    return matmul(out, p.wo)


def attention_decode(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                     positions: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index: int, *,
                     window: Optional[int] = None):
    """One-token decode: x (B, 1, d) against a cache (B, T_max, KV, hd),
    written in place at slot `cache_index` (`cache_index % T_max` for a
    sliding-window ring) -> (out, k_cache, v_cache). A ring slot holds the
    absolute position p with p % T_max == slot, valid once written and
    within the window; the JAX package's mask, term for term."""
    T_max = k_cache.shape[1]
    q, k, v = _qkv(cfg, p, x, positions)
    slot = cache_index % T_max if window is not None else cache_index
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    slots = torch.arange(T_max, device=x.device)
    if window is not None:
        abs_pos = cache_index - (cache_index - slots) % T_max
        valid = ((abs_pos >= 0) & (abs_pos > cache_index - (window or T_max))
                 | (slots == slot)) & (abs_pos <= cache_index)
    else:
        valid = slots <= cache_index
    out = _sdpa(cfg, q, k_cache, v_cache, valid[None, None, None, None, :])
    return matmul(out, p.wo), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """w1 (d, f), w2 (f, d) [+ w3 (d, f), SwiGLU's gate]."""

    def __init__(self, d: int, f: int, dtype, act: str = "silu",
                 device=None):
        super().__init__()
        self.w1 = param(torch.empty(d, f, dtype=dtype, device=device))
        self.w2 = param(torch.empty(f, d, dtype=dtype, device=device))
        if act == "silu":
            self.w3 = param(torch.empty(d, f, dtype=dtype, device=device))


def init_mlp(generator: torch.Generator, d: int, f: int, dtype,
             act: str = "silu") -> MLP:
    p = MLP(d, f, dtype, act, device=generator.device)
    with torch.no_grad():
        p.w1.copy_(normal(generator, (d, f), d ** -0.5, dtype))
        p.w2.copy_(normal(generator, (f, d), f ** -0.5, dtype))
        if act == "silu":
            p.w3.copy_(normal(generator, (d, f), d ** -0.5, dtype))
    return p


def mlp(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if act == "silu":
        h = F.silu(matmul(x, p.w1)) * matmul(x, p.w3)
    else:
        h = F.gelu(matmul(x, p.w1), approximate="tanh")   # jax.nn.gelu
    return matmul(h, p.w2)
