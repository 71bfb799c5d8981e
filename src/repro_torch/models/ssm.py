"""Recurrent sequence mixers: xLSTM's mLSTM and sLSTM, and hymba's
Mamba-style diagonal SSD, each over a full sequence and one token at a
time.

The port of the JAX package's `models/ssm.py`. Plain PyTorch: the JAX
package runs no Pallas kernel here.

  mlstm(cfg, p, x) / mlstm_decode(cfg, p, x, state)
  slstm(cfg, p, x) / slstm_decode(cfg, p, x, state)
  mamba(cfg, p, x, d_inner) / mamba_decode(cfg, p, x, state, d_inner)

mLSTM runs chunkwise (`CHUNK` positions): within a chunk an
attention-like term under the gates' decay, across chunks the carried
matrix memory, stabilised by the max-state m, chunk after chunk in a
loop, as the JAX package's scan. The JAX package pads T up to a multiple
of CHUNK with zero rows, and those rows still apply their gates, so the
state it returns after a T that is not a multiple of CHUNK is that of the
padded sequence, not of T tokens. The port returns the same state.

sLSTM mixes its hidden state across time (a block-diagonal recurrence
per head), so it runs step by step: a Python loop over T, its input
projection computed for all T at once.

The JAX package scans Mamba's chunks of `CHUNK` positions with an
associative scan inside each. PyTorch has no stable associative scan, so
within a chunk this port uses the scan's closed form: with a_t = dt_t * A
the log decay of step t, the state after step t is

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
from repro_torch.models import sharding
from repro_torch.models.layers import matmul, normal, param

CHUNK = 256
#: The stabilisers' start: the log of an empty state's weight.
M_INIT = -1e30


def _heads_of(cfg: ArchConfig) -> int:
    return cfg.mlstm_heads or cfg.n_heads


# ===========================================================================
# mLSTM (matrix memory, exponential gating)
# ===========================================================================

class MLSTM(nn.Module):
    """wq, wk, wv, wo (d, d), w_if (d, 2H); b_if (2H,) and the per-head
    norm scale ln (d,), float32."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, H = cfg.d_model, _heads_of(cfg)

        def new(*shape, dt=dtype):
            return param(torch.empty(shape, dtype=dt, device=device))
        self.wq, self.wk, self.wv, self.wo = (new(d, d), new(d, d),
                                              new(d, d), new(d, d))
        self.w_if = new(d, 2 * H)
        self.b_if = new(2 * H, dt=torch.float32)
        self.ln = new(d, dt=torch.float32)


def init_mlstm(cfg: ArchConfig, generator: torch.Generator,
               dtype) -> MLSTM:
    p = MLSTM(cfg, dtype, device=generator.device)
    d, H = cfg.d_model, _heads_of(cfg)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo", "w_if"):
            w = getattr(p, name)
            w.copy_(normal(generator, w.shape, d ** -0.5, dtype))
        p.b_if[:H] = 0.0                 # input gates
        p.b_if[H:] = 3.0                 # forget gates open
        p.ln.fill_(1.0)
    return p


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, hd, hd) matrix memory
    n: torch.Tensor    # (B, H, hd)     normalizer
    m: torch.Tensor    # (B, H)         max-gate stabilizer (log space)


def mlstm_init_state(cfg: ArchConfig, B: int, dtype=torch.float32,
                     device=None) -> MLSTMState:
    H = _heads_of(cfg)
    hd = cfg.d_model // H
    return MLSTMState(
        C=torch.zeros((B, H, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((B, H, hd), dtype=dtype, device=device),
        m=torch.full((B, H), M_INIT, dtype=dtype, device=device))


def _mlstm_gates(p: MLSTM, x: torch.Tensor, H: int):
    """Log input and forget gates, (B, T, H) each, f by log-sigmoid."""
    g = matmul(x, p.w_if).float() + p.b_if
    return g[..., :H], F.logsigmoid(g[..., H:])


def _to_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, d = x.shape
    return x.reshape(B, T, H, d // H).transpose(1, 2)      # (B, H, T, hd)


def _mlstm_chunk(state: MLSTMState, qx, kx, vx, li, lf):
    """One chunk of W positions, exactly the per-token recurrence. With
    F_t = sum_{u<=t} lf_u within the chunk, the decode stabiliser is
    m_t = F_t + M_t, M_t = max(m_in, cummax_{s<=t}(li_s - F_s)), and in
    units exp(m_t) a source s <= t weighs exp(li_s - F_s - M_t), the
    carried state exp(m_in - M_t). qx, kx, vx (B, H, W, hd); li, lf
    (B, H, W) -> (next state, h (B, H, W, hd) float32)."""
    C_in, n_in, m_in = state
    W = li.shape[-1]
    Fc = torch.cumsum(lf, dim=-1)
    a = li - Fc                                   # source log-weight
    M = torch.maximum(m_in[..., None], torch.cummax(a, dim=-1).values)
    wmat = torch.exp(a[..., None, :] - M[..., :, None])
    causal = torch.ones((W, W), dtype=torch.bool, device=a.device).tril()
    qf, kf, vf = qx.float(), kx.float(), vx.float()
    scores = qf @ kf.transpose(-1, -2)
    w = torch.where(causal, wmat * scores, 0.0)
    h_intra = w @ vf
    den_intra = torch.sum(w, dim=-1)

    carry_w = torch.exp(m_in[..., None] - M)      # (B, H, W)
    h_inter = (qf @ C_in) * carry_w[..., None]
    den_inter = (qf @ n_in[..., None])[..., 0] * carry_w
    den = den_intra + den_inter
    h = (h_intra + h_inter) / torch.clamp(torch.abs(den), min=1.0)[..., None]

    # The chunk's end state, in units exp(m_out), m_out = F_W + M_W.
    M_W = M[..., -1]
    w_s = torch.exp(a - M_W[..., None])           # (B, H, W)
    keep = torch.exp(m_in - M_W)
    kw = kf * w_s[..., None]
    C = keep[..., None, None] * C_in + kw.transpose(-1, -2) @ vf
    n = keep[..., None] * n_in + kw.sum(dim=-2)
    return MLSTMState(C=C, n=n, m=Fc[..., -1] + M_W), h


def mlstm(cfg: ArchConfig, p: MLSTM, x: torch.Tensor,
          return_state: bool = False):
    """Chunkwise mLSTM over the full sequence. x: (B, T, d). The state
    returned is that of T padded to a multiple of CHUNK (module
    docstring)."""
    B, T, d = x.shape
    H = _heads_of(cfg)
    hd = d // H
    nc = -(-T // CHUNK)
    Tp = nc * CHUNK
    if Tp != T:
        x = F.pad(x, (0, 0, 0, Tp - T))
    q = _to_heads(matmul(x, p.wq), H) / math.sqrt(hd)
    k = _to_heads(matmul(x, p.wk), H)
    v = _to_heads(matmul(x, p.wv), H)
    log_i, log_f = _mlstm_gates(p, x, H)
    log_i, log_f = log_i.transpose(1, 2), log_f.transpose(1, 2)  # (B,H,Tp)
    state = mlstm_init_state(cfg, B, device=x.device)
    hs = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        state, h = _mlstm_chunk(state, q[:, :, sl], k[:, :, sl],
                                v[:, :, sl], log_i[..., sl], log_f[..., sl])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, Tp, d)[:, :T]
    h = _group_rmsnorm(h, p.ln, H)
    out = matmul(h.to(x.dtype), p.wo).to(x.dtype)
    return (out, state) if return_state else out


def mlstm_decode(cfg: ArchConfig, p: MLSTM, x: torch.Tensor,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """One-token recurrent step. x: (B, 1, d)."""
    B, _, d = x.shape
    H = _heads_of(cfg)
    hd = d // H
    q = (matmul(x, p.wq).reshape(B, H, hd) / math.sqrt(hd)).float()
    k = matmul(x, p.wk).reshape(B, H, hd).float()
    v = matmul(x, p.wv).reshape(B, H, hd).float()
    log_i, log_f = _mlstm_gates(p, x, H)
    li, lf = log_i[:, 0], log_f[:, 0]             # (B, H)

    m_new = torch.maximum(state.m + lf, li)
    w_old = torch.exp(state.m + lf - m_new)
    w_in = torch.exp(li - m_new)
    C = w_old[..., None, None] * state.C + \
        w_in[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = w_old[..., None] * state.n + w_in[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.clamp(torch.abs((q * n).sum(dim=-1)), min=1.0)
    h = (num / den[..., None]).reshape(B, 1, d)
    h = _group_rmsnorm(h, p.ln, H)
    out = matmul(h.to(x.dtype), p.wo).to(x.dtype)
    return out, MLSTMState(C=C, n=n, m=m_new)


# ===========================================================================
# sLSTM (scalar memory, exponential gating, head-wise state mixing)
# ===========================================================================

class SLSTM(nn.Module):
    """w (d, 4d): the z, i, f, o gates from the input; r (H, hd, 4 hd):
    the block-diagonal recurrence per head; wo (d, d); b (4d,) and ln
    (d,), float32."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, H = cfg.d_model, _heads_of(cfg)
        hd = d // H

        def new(*shape, dt=dtype):
            return param(torch.empty(shape, dtype=dt, device=device))
        self.w = new(d, 4 * d)
        self.r = new(H, hd, 4 * hd)
        self.b = new(4 * d, dt=torch.float32)
        self.wo = new(d, d)
        self.ln = new(d, dt=torch.float32)


def init_slstm(cfg: ArchConfig, generator: torch.Generator,
               dtype) -> SLSTM:
    p = SLSTM(cfg, dtype, device=generator.device)
    d = cfg.d_model
    hd = d // _heads_of(cfg)
    with torch.no_grad():
        p.w.copy_(normal(generator, p.w.shape, d ** -0.5, dtype))
        p.r.copy_(normal(generator, p.r.shape, hd ** -0.5, dtype))
        p.b.zero_()
        p.b[2 * d:3 * d] = 3.0            # forget gates open
        p.wo.copy_(normal(generator, p.wo.shape, d ** -0.5, dtype))
        p.ln.fill_(1.0)
    return p


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) cell
    n: torch.Tensor   # (B, d) normalizer
    h: torch.Tensor   # (B, d) hidden
    m: torch.Tensor   # (B, d) stabilizer


def slstm_init_state(cfg: ArchConfig, B: int, dtype=torch.float32,
                     device=None) -> SLSTMState:
    d = cfg.d_model

    def z():
        return torch.zeros((B, d), dtype=dtype, device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((B, d), M_INIT, dtype=dtype,
                                   device=device))


def _slstm_step(r: torch.Tensor, b: torch.Tensor, state: SLSTMState,
                xw: torch.Tensor, H: int):
    """xw: the step's input projection x_t @ w in float32, (B, 4d) ->
    (new state, the gate pre-activations g (B, 4d))."""
    B, d = state.h.shape
    hh = state.h.reshape(B, H, d // H).to(r.dtype).transpose(0, 1)
    rec = torch.bmm(hh, r).transpose(0, 1).reshape(B, 4 * d)
    g = xw + rec.float() + b
    zt = torch.tanh(g[:, :d])
    it = g[:, d:2 * d]                       # log-space input gate
    ft = F.logsigmoid(g[:, 2 * d:3 * d])
    ot = torch.sigmoid(g[:, 3 * d:])
    m_new = torch.maximum(state.m + ft, it)
    w_old = torch.exp(state.m + ft - m_new)
    w_in = torch.exp(it - m_new)
    c = w_old * state.c + w_in * zt
    n = w_old * state.n + w_in
    h = ot * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new), g


def _shifted(seq: torch.Tensor, first: float) -> torch.Tensor:
    """(B, T, n) -> the previous step's values: `first`, then seq[:, :-1]."""
    return torch.cat([torch.full_like(seq[:, :1], first), seq[:, :-1]], 1)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over T steps from the zero state as one autograd
    node: xw (B, T, 4d) float32, r, b -> (h (B, T, d), c, n, h, m after
    the last step). The forward loop records nothing for autograd; the
    backward runs the loop in reverse with the step's derivatives written
    out (those autograd takes through `_slstm_step`, ties included: half
    to each side of the max, the clamp's at n == 1 passed), so training
    pays a few launches a step and no graph of T steps. The recurrent
    weight's gradient is one product over all steps."""

    @staticmethod
    def forward(ctx, xw, r, b, H):
        B, T, d = xw.shape[0], xw.shape[1], xw.shape[2] // 4
        z = torch.zeros((B, d), dtype=torch.float32, device=xw.device)
        state = SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, M_INIT))
        gs, states = [], []
        for t in range(T):
            state, g = _slstm_step(r, b, state, xw[:, t], H)
            states.append(state)
            gs.append(g)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(r, torch.stack(gs, dim=1), *(
                torch.stack(a, dim=1) for a in zip(*states)))  # c, n, h, m
            ctx.H = H
        return (torch.stack([s.h for s in states], dim=1), *state)

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_h, g_m):
        r, G, Cs, Ns, Hs, Ms = ctx.saved_tensors
        H = ctx.H
        B, T, d = Hs.shape
        hd = d // H
        c_prev, n_prev = _shifted(Cs, 0.0), _shifted(Ns, 0.0)
        h_prev, m_prev = _shifted(Hs, 0.0), _shifted(Ms, M_INIT)
        gz, gi, gf, go = G.split(d, dim=-1)
        z, o = torch.tanh(gz), torch.sigmoid(go)
        a = m_prev + F.logsigmoid(gf)
        w_old, w_in = torch.exp(a - Ms), torch.exp(gi - Ms)
        nn_ = torch.clamp(Ns, min=1.0)
        # Per-step coefficients, all steps at once.
        k_c = o / nn_                                 # dc  += gh k_c
        k_n = -(o * Cs) / (nn_ * nn_) * (Ns >= 1.0)   # dn  += gh k_n
        k_o = Cs / nn_ * o * (1.0 - o)                # dgo  = gh k_o
        cpw, npw = c_prev * w_old, n_prev * w_old
        zw, zc = z * w_in, w_in * (1.0 - z * z)
        a_share = torch.where(a == gi, 0.5, (a > gi).float())
        sgf = torch.sigmoid(-gf)                      # d logsigmoid
        dG = torch.empty_like(G)
        gc = torch.zeros_like(Hs[:, 0]) if g_c is None else g_c.clone()
        gn = torch.zeros_like(gc) if g_n is None else g_n.clone()
        gm = torch.zeros_like(gc) if g_m is None else g_m.clone()
        dh = torch.zeros_like(gc) if g_h is None else g_h.clone()
        rt = r.transpose(1, 2)
        for t in range(T - 1, -1, -1):
            gh = dh if g_hs is None else g_hs[:, t] + dh
            dc = torch.addcmul(gc, gh, k_c[:, t])
            dn = torch.addcmul(gn, gh, k_n[:, t])
            d_old = torch.addcmul(dc * cpw[:, t], dn, npw[:, t])
            d_in = torch.addcmul(dc * zw[:, t], dn, w_in[:, t])
            dm = gm - d_old - d_in
            da = torch.addcmul(d_old, dm, a_share[:, t])
            dgt = dG[:, t]
            torch.mul(dc, zc[:, t], out=dgt[:, :d])
            torch.addcmul(d_in, dm, 1.0 - a_share[:, t], out=dgt[:, d:2 * d])
            torch.mul(da, sgf[:, t], out=dgt[:, 2 * d:3 * d])
            torch.mul(gh, k_o[:, t], out=dgt[:, 3 * d:])
            gc, gn, gm = dc * w_old[:, t], dn * w_old[:, t], da
            drec = dgt.to(r.dtype).reshape(B, H, 4 * hd).transpose(0, 1)
            dh = torch.bmm(drec, rt).transpose(0, 1).reshape(B, d).float()
        hh = h_prev.to(r.dtype).reshape(B * T, H, hd).transpose(0, 1)
        drec = dG.to(r.dtype).reshape(B * T, H, 4 * hd).transpose(0, 1)
        return dG, torch.bmm(hh.transpose(1, 2), drec), dG.sum((0, 1)), None


def slstm(cfg: ArchConfig, p: SLSTM, x: torch.Tensor,
          return_state: bool = False, *, mesh=None, batch_axes=()):
    """sLSTM over the full sequence, one step at a time (`_SLSTMScan`).
    x: (B, T, d).

    With a mesh, as the JAX package's shard_map island: each batch shard
    (`sharding.row_shards`) runs on its cell's device with a copy of the
    weights, whose gradients are summed once, in shard order; outputs and
    states come back to x's device. The rows are independent, so the
    values are the unsharded ones."""
    if mesh is not None:
        shards = sharding.row_shards(mesh, x.shape[0], batch_axes)
        outs = [slstm(cfg, ps, x[s.rows].to(s.device), return_state)
                for s, ps in zip(shards, sharding.replicas(
                    p, [s.device for s in shards]))]
        if not return_state:
            return torch.cat([o.to(x.device) for o in outs])
        return (torch.cat([o.to(x.device) for o, _ in outs]),
                SLSTMState(*(torch.cat([st[f].to(x.device)
                                        for _, st in outs])
                             for f in range(4))))
    H = _heads_of(cfg)
    xw = matmul(x, p.w).float()                   # (B, T, 4d)
    hs, *state = _SLSTMScan.apply(xw, p.r, p.b, H)
    h = _group_rmsnorm(hs, p.ln, H)
    out = matmul(h.to(x.dtype), p.wo).to(x.dtype)
    return (out, SLSTMState(*state)) if return_state else out


def slstm_decode(cfg: ArchConfig, p: SLSTM, x: torch.Tensor,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """One-token step. x: (B, 1, d)."""
    H = _heads_of(cfg)
    state, _ = _slstm_step(p.r, p.b, state, matmul(x[:, 0], p.w).float(), H)
    h = _group_rmsnorm(state.h[:, None], p.ln, H)
    return matmul(h.to(x.dtype), p.wo).to(x.dtype), state


# ===========================================================================
# Mamba-style diagonal SSD (hymba's SSM heads)
# ===========================================================================

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
