"""Mamba-style diagonal SSD: hymba's SSM heads, full sequence and one
token at a time.

The port of the Mamba half of the JAX package's `models/ssm.py` (the
xLSTM mixers come with their family). Plain PyTorch: the JAX package runs
no Pallas kernel here.

  mamba(cfg, p, x, d_inner)              full sequence (prefill)
  mamba_decode(cfg, p, x, state, ...)    one token, O(1) state update

The JAX package scans chunks of `CHUNK` positions with an associative scan
inside each. PyTorch has no stable associative scan, so within a chunk
this port uses the scan's closed form: with a_t = dt_t * A the log decay
of step t, the state after step t is

  h_t = exp(sum_{u<=t} a_u) h_in + sum_{s<=t} exp(sum_{s<u<=t} a_u) inp_s,

whose weights come from one masked cumulative sum per chunk (`_segsum`,
exact where the weight matters). Chunks are computed all at once; only the
carried state goes through a loop over the T / CHUNK chunks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import matmul, normal, param

CHUNK = 256


class Mamba(nn.Module):
    """w_in (d, 2 d_inner), w_bc (d, 2S), w_dt (d, H), b_dt, A_log, D (H,),
    conv (4, d_inner), w_out (d_inner, d), ln (d_inner,)."""

    def __init__(self, cfg: ArchConfig, dtype, d_inner: int, device=None):
        super().__init__()
        d, S, H = cfg.d_model, cfg.ssm_state, d_inner // cfg.head_dim

        def new(*shape, dt=dtype):
            return param(torch.empty(shape, dtype=dt, device=device))
        f32 = torch.float32
        self.w_in, self.w_bc, self.w_dt = (new(d, 2 * d_inner), new(d, 2 * S),
                                           new(d, H))
        self.b_dt, self.A_log, self.D = (new(H, dt=f32), new(H, dt=f32),
                                         new(H, dt=f32))
        self.conv, self.w_out = new(4, d_inner), new(d_inner, d)
        self.ln = new(d_inner, dt=f32)


def init_mamba(cfg: ArchConfig, generator: torch.Generator, dtype,
               d_inner: int) -> Mamba:
    p = Mamba(cfg, dtype, d_inner, device=generator.device)
    d, S, H = cfg.d_model, cfg.ssm_state, d_inner // cfg.head_dim
    s = d ** -0.5
    dev = generator.device
    with torch.no_grad():
        p.w_in.copy_(normal(generator, (d, 2 * d_inner), s, dtype))
        p.w_bc.copy_(normal(generator, (d, 2 * S), s, dtype))
        p.w_dt.copy_(normal(generator, (d, H), s, dtype))
        u = torch.rand(H, generator=generator, device=dev)
        lo, hi = math.log(0.001), math.log(0.1)
        p.b_dt.copy_(torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))))
        p.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                             device=dev)))
        p.D.fill_(1.0)
        p.conv.copy_(normal(generator, (4, d_inner), 0.5, dtype))
        p.w_out.copy_(normal(generator, (d_inner, d), d_inner ** -0.5,
                             dtype))
        p.ln.fill_(1.0)
    return p


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, H, hd, S) SSM state
    conv: torch.Tensor     # (B, 3, d_inner) last inputs for the causal conv


def mamba_init_state(cfg: ArchConfig, B: int, d_inner: int,
                     dtype=torch.float32, device=None) -> MambaState:
    H = d_inner // cfg.head_dim
    return MambaState(
        h=torch.zeros((B, H, cfg.head_dim, cfg.ssm_state), dtype=dtype,
                      device=device),
        conv=torch.zeros((B, 3, d_inner), dtype=dtype, device=device))


def _causal_conv(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, window 4. xc (B, T, C), w (4, C)."""
    pad = F.pad(xc, (0, 0, 3, 0))
    T = xc.shape[1]
    return sum(pad[:, i:i + T] * w[i] for i in range(4))


def _group_rmsnorm(x: torch.Tensor, scale: torch.Tensor, H: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm on flattened (B, T, d=H*hd)."""
    B, T, d = x.shape
    xs = x.reshape(B, T, H, d // H).float()
    xs = xs * torch.rsqrt(torch.mean(xs * xs, dim=-1, keepdim=True) + eps)
    return (xs.reshape(B, T, d) * scale).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., W) -> (..., W, W): out[t, s] = sum_{s<u<=t} a_u for s <= t,
    -inf above the diagonal."""
    W = a.shape[-1]
    x = a[..., None, :].expand(*a.shape, W).transpose(-1, -2)  # [t, s] = a_t
    below = torch.ones(W, W, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0).cumsum(dim=-2)
    return x.masked_fill(~below.clone().fill_diagonal_(True), -math.inf)


def _ssd(dt: torch.Tensor, a: torch.Tensor, xh: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor, W: int):
    """y_t = C_t h_t with h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T, chunks of
    W positions. dt, a (B, T, H); xh (B, T, H, hd); Bm, Cm (B, T, S), all
    float32 -> (y (B, T, H, hd), final state (B, H, hd, S))."""
    Bsz, T, H = dt.shape
    hd, S = xh.shape[-1], Bm.shape[-1]
    nc = T // W
    dtc = dt.reshape(Bsz, nc, W, H)
    xc = xh.reshape(Bsz, nc, W, H, hd)
    Bc = Bm.reshape(Bsz, nc, W, S)
    Cc = Cm.reshape(Bsz, nc, W, S)
    ac = a.reshape(Bsz, nc, W, H).permute(0, 1, 3, 2)           # (b,c,h,W)
    cum = ac.cumsum(dim=-1)                                     # sum_{u<=t}
    seg = _segsum(ac)                                           # (b,c,h,t,s)
    # Within the chunk: y_t = sum_{s<=t} exp(seg[t, s]) dt_s (C_t.B_s) x_s.
    CB = torch.einsum("bcts,bcus->bctu", Cc, Bc)                # (b,c,t,s)
    M = torch.exp(seg) * CB[:, :, None] * dtc.permute(0, 1, 3, 2)[:, :, :,
                                                                  None, :]
    y = torch.einsum("bchts,bcshd->bcthd", M, xc)
    # What each chunk adds to the state it hands on, and its whole decay.
    to_end = torch.exp(seg[..., -1, :]) * dtc.permute(0, 1, 3, 2)
    xw = xc * to_end.permute(0, 1, 3, 2)[..., None]             # (b,c,s,h,d)
    states = torch.einsum("bcshd,bcsn->bchdn", xw, Bc)
    decay = torch.exp(cum[..., -1])                             # (b,c,h)
    h = torch.zeros((Bsz, H, hd, S), dtype=dt.dtype, device=dt.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (b,c,h,d,n)
    y = y + torch.einsum("bctn,bchdn->bcthd", Cc, h_in) * \
        torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    return y.reshape(Bsz, T, H, hd), h


def mamba(cfg: ArchConfig, p: Mamba, x: torch.Tensor, d_inner: int,
          return_state: bool = False, project: bool = True):
    """Full-sequence SSD. x: (B, T, d). project=False returns the gated
    activations before the out-projection (the hybrid block fuses it with
    the attention's wo)."""
    B, T, d = x.shape
    hd = cfg.head_dim
    H = d_inner // hd
    S = cfg.ssm_state

    xz = matmul(x, p.w_in)
    xc, z = xz[..., :d_inner], xz[..., d_inner:]
    xc = F.silu(_causal_conv(xc, p.conv))
    bc = matmul(x, p.w_bc)
    Bm, Cm = bc[..., :S], bc[..., S:]                   # (B, T, S)
    dt = _softplus(matmul(x, p.w_dt).float() + p.b_dt)
    A = -torch.exp(p.A_log)                             # (H,) negative
    xh = xc.reshape(B, T, H, hd).float()

    W = min(CHUNK, T)
    W = W if T % W == 0 else math.gcd(T, W)
    y, h_final = _ssd(dt, dt * A, xh, Bm.float(), Cm.float(), W)
    y = y + xh * p.D[None, None, :, None]
    y = _group_rmsnorm(y.reshape(B, T, d_inner), p.ln, H)
    y = y * F.silu(z)
    out = y.to(x.dtype) if not project else \
        matmul(y.to(x.dtype), p.w_out).to(x.dtype)
    if return_state:
        xc_raw = xz[..., :d_inner]                      # pre-conv inputs
        pad = torch.cat([torch.zeros((B, 3, d_inner), dtype=xc_raw.dtype,
                                     device=x.device), xc_raw], dim=1)
        return out, MambaState(h=h_final, conv=pad[:, T:T + 3])
    return out


def mamba_decode(cfg: ArchConfig, p: Mamba, x: torch.Tensor,
                 state: MambaState, d_inner: int
                 ) -> tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, 1, d)."""
    B, _, d = x.shape
    hd = cfg.head_dim
    H = d_inner // hd
    S = cfg.ssm_state

    xz = matmul(x[:, 0], p.w_in)
    xc_t, z = xz[..., :d_inner], xz[..., d_inner:]
    window = torch.cat([state.conv, xc_t[:, None]], dim=1)       # (B,4,di)
    xc = F.silu((window.float() * p.conv.float()).sum(dim=1))
    bc = matmul(x[:, 0], p.w_bc)
    Bm, Cm = bc[..., :S], bc[..., S:]
    dt = _softplus(matmul(x[:, 0], p.w_dt).float() + p.b_dt)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                                    # (B, H)

    xh = xc.reshape(B, H, hd).float()
    inp = dt[:, :, None, None] * xh[..., None] * Bm.float()[:, None, None, :]
    h = state.h * decay[..., None, None] + inp
    y = (h * Cm.float()[:, None, None, :]).sum(dim=-1)
    y = y + xh * p.D[None, :, None]
    y = _group_rmsnorm(y.reshape(B, 1, d_inner), p.ln, H)
    y = y * F.silu(z)[:, None]
    out = matmul(y, p.w_out).to(x.dtype)
    return out, MambaState(h=h, conv=window[:, 1:])
