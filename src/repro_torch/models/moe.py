"""Mixture-of-Experts FFN: top-k routing, capacity-clipped sort-based
dispatch, batched expert FFNs, a weighted combine and shared experts.

The port of the JAX package's module of the same name, for its two MoE
architectures:
  * qwen2-moe-a2.7b — 60 routed experts top-4 + shared experts (one
    expert of d_ff 5632, gated per token) [hf:Qwen/Qwen1.5-MoE-A2.7B]
  * mixtral-8x22b   — 8 routed experts top-2, no shared expert
    [arXiv:2401.04088]

Dispatch sorts the (token, expert) assignments by expert id (stably) and
gives each expert `capacity` rows; an assignment past its expert's
capacity is dropped (it adds nothing to its token). The capacity depends
on the number of tokens n = B * T of the call, so a prefill can drop
assignments that one-token decode steps keep: that is the JAX package's
design, mirrored here. `count_dropped` reports them.

The router's top-k ids come from the port's top-k (the blocked top-k
kernel on the card): the lowest id wins a tie, as `lax.top_k` gives it,
which `torch.topk` does not promise. The gate values are then gathered
from the router probabilities, so the router gets its gradient (the
kernel has none). The expert products take their operands' type and give
float32, as the JAX package's `preferred_element_type=float32` einsums
(`_f32_bmm`). The combine adds each token's k contributions in the JAX
package's order (ascending expert id), each cast to the activations'
type, with no atomic adds: two runs on the card give the same bits.

  moe_ffn(cfg, p, x)       (B, T, d) -> (out, Switch aux loss)

The mesh branch (tokens sharded, experts tensor-parallel) is not ported.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.models.layers import matmul, normal, param


class SharedExpert(nn.Module):
    """w1, w3 (d, fs), w2 (fs, d) and the per-token gate (d, 1)."""

    def __init__(self, d: int, fs: int, dtype, device=None):
        super().__init__()

        def new(*shape):
            return param(torch.empty(shape, dtype=dtype, device=device))
        self.w1, self.w3, self.w2 = new(d, fs), new(d, fs), new(fs, d)
        self.gate = new(d, 1)


class MoE(nn.Module):
    """router (d, E) float32, w1 and w3 (E, d, fe), w2 (E, fe, d)
    [+ shared]."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, E, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff

        def new(*shape, dt=dtype):
            return param(torch.empty(shape, dtype=dt, device=device))
        self.router = new(d, E, dt=torch.float32)
        self.w1, self.w3, self.w2 = new(E, d, fe), new(E, d, fe), \
            new(E, fe, d)
        if cfg.n_shared_experts:
            fs = cfg.shared_d_ff or fe * cfg.n_shared_experts
            self.shared = SharedExpert(d, fs, dtype, device=device)


def init_moe(cfg: ArchConfig, generator: torch.Generator, dtype) -> MoE:
    """The JAX package's distributions, drawn from `generator` in its
    order (router, w1, w3, w2, then the shared expert's w1, w3, w2, gate)."""
    p = MoE(cfg, dtype, device=generator.device)
    d = cfg.d_model
    s = d ** -0.5
    with torch.no_grad():
        p.router.copy_(normal(generator, p.router.shape, s, torch.float32))
        p.w1.copy_(normal(generator, p.w1.shape, s, dtype))
        p.w3.copy_(normal(generator, p.w3.shape, s, dtype))
        p.w2.copy_(normal(generator, p.w2.shape, p.w2.shape[1] ** -0.5,
                          dtype))
        if cfg.n_shared_experts:
            sh = p.shared
            fs = sh.w2.shape[0]
            sh.w1.copy_(normal(generator, sh.w1.shape, s, dtype))
            sh.w3.copy_(normal(generator, sh.w3.shape, s, dtype))
            sh.w2.copy_(normal(generator, sh.w2.shape, fs ** -0.5, dtype))
            sh.gate.copy_(normal(generator, sh.gate.shape, s, dtype))
    return p


# Each MoE call appends (assignments, dropped) here while `count_dropped`
# is active.
_DROPS: Optional[list] = None


@contextlib.contextmanager
def count_dropped():
    """Collects, for every MoE layer call in the block, in call order, the
    (token, expert) assignments routed (an int) and those dropped at the
    capacity (a 0-d int64 tensor on the call's device). A rematerialised
    forward calls each layer again in the backward."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def capacity(cfg: ArchConfig, n: int) -> int:
    """Rows each expert takes from a call of n tokens."""
    return max(int(n * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor),
               4)


def _f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, m, k) @ (E, k, n) -> float32. bf16 operands on the card with no
    gradient to take go to `torch.bmm(..., out_dtype=torch.float32)` (the
    tensor cores, float32 sums; it has no backward); otherwise the
    operands are widened to float32 first. A bf16 product is exact in
    float32, so the two differ only in their summation order."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def route(probs: torch.Tensor, top_k: int):
    """(gate values renormalised over the k chosen, expert ids int64),
    each (n, k): ids in descending probability, the lowest id first on a
    tie; the values gathered from `probs` (differentiable)."""
    _, idx = topk_ops.topk(probs.detach(), top_k)
    idx = idx.long()
    vals = torch.gather(probs, 1, idx)
    return vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9), idx


def _dispatch_combine(xf: torch.Tensor, gate_vals: torch.Tensor,
                      gate_idx: torch.Tensor, capacity: int,
                      w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor):
    """Sort-based dispatch -> batched expert FFN -> weighted combine.
    xf (n, d) tokens; gate_vals, gate_idx (n, k) from `route`; w1/w3
    (E, d, f), w2 (E, f, d) -> (out (n, d), dropped assignments, 0-d)."""
    n, d = xf.shape
    k = gate_idx.shape[1]
    E = w1.shape[0]
    dev = xf.device
    e_s, order = torch.sort(gate_idx.reshape(-1), stable=True)
    tok_s = order // k
    w_s = gate_vals.reshape(-1)[order]

    # Position of each routed token within its expert's capacity buffer.
    counts = torch.bincount(e_s, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=dev) - starts[e_s]
    keep = pos < capacity
    dst = torch.where(keep, e_s * capacity + pos, E * capacity)

    # F.embedding gathers the token rows: its backward sums a token's k
    # rows in a fixed order. Dropped rows all go to the overflow slot.
    rows = F.embedding(tok_s, xf)
    buf = xf.new_zeros((E * capacity + 1, d)).index_put((dst,), rows)
    buf = buf[:-1].reshape(E, capacity, d)

    h = _f32_bmm(buf, w1)
    g = _f32_bmm(buf, w3)
    h = (F.silu(h) * g).to(xf.dtype)
    y = _f32_bmm(h, w2).to(xf.dtype)

    y_flat = torch.cat([y.reshape(E * capacity, d),
                        y.new_zeros((1, d))])
    contrib = (y_flat[dst] * w_s[:, None]).to(xf.dtype)
    # Each token's k contributions in sorted (ascending expert) order:
    # the sorted positions of token t are where `order` holds t*k..t*k+k-1.
    at = torch.empty_like(order)
    at[order] = torch.arange(n * k, device=dev)
    at = torch.sort(at.reshape(n, k), dim=1).values
    parts = contrib[at.reshape(-1)].reshape(n, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out, (~keep).sum()


def _shared_expert(p: SharedExpert, xf: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(xf, p.w1)) * matmul(xf, p.w3)
    y = matmul(h, p.w2)
    gate = torch.sigmoid(matmul(xf, p.gate).float()).to(y.dtype)
    return y * gate


def moe_ffn_local(cfg: ArchConfig, p: MoE, xf: torch.Tensor):
    """MoE FFN on the tokens xf (n, d) -> (out (n, d), aux loss)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    n = xf.shape[0]
    logits = matmul(xf, p.router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = route(probs, k)
    out, dropped = _dispatch_combine(xf, gate_vals, gate_idx,
                                     capacity(cfg, n), p.w1, p.w3, p.w2)
    if _DROPS is not None:
        _DROPS.append((n * k, dropped.detach()))
    if cfg.n_shared_experts:
        out = out + _shared_expert(p.shared, xf)
    # Switch's load-balance loss: E * sum_e (token fraction)_e * (mass)_e,
    # the token's top-1 its first top-k id (the first maximum).
    f_e = torch.bincount(gate_idx[:, 0], minlength=E).float() / n
    p_e = torch.mean(probs, dim=0)
    return out, E * torch.sum(f_e * p_e)


def moe_ffn(cfg: ArchConfig, p: MoE, x: torch.Tensor, *, mesh=None,
            batch_axes: tuple = ()):
    """MoE FFN on (B, T, d) -> (out (B, T, d), aux loss)."""
    if mesh is not None or batch_axes:
        from repro_torch.models.transformer import NOT_PORTED
        raise NotImplementedError(NOT_PORTED["mesh"])
    B, T, d = x.shape
    out, aux = moe_ffn_local(cfg, p, x.reshape(B * T, d))
    return out.reshape(B, T, d), aux
