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

Over a mesh (`moe_ffn(mesh=)`, or a training forward's batch shard) the
tokens stay on their batch shard and dispatch there at that shard's
capacity, and the experts' d_ff is split over the model axis, as the JAX
package's shard_map island does.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.models import sharding
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


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """How often each of the E expert ids occurs in `ids` (int64, (E,))."""
    return torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _dispatch(xf: torch.Tensor, gate_vals: torch.Tensor,
              gate_idx: torch.Tensor, capacity: int, E: int):
    """Sort-based dispatch of the tokens xf (n, d), gate_vals and gate_idx
    (n, k) from `route` -> (buf (E, capacity, d): each expert's rows, and
    the plan `_combine` reads: each assignment's slot (E * capacity for a
    dropped one), its gate value and the sorted position of each token's
    k assignments), dropped assignments (0-d))."""
    n, d = xf.shape
    k = gate_idx.shape[1]
    dev = xf.device
    e_s, order = torch.sort(gate_idx.reshape(-1), stable=True)
    tok_s = order // k
    w_s = gate_vals.reshape(-1)[order]

    # Position of each routed token within its expert's capacity buffer.
    # A scatter into E zeros, not `bincount`: its shape is static, so the
    # dispatch also runs on fake tensors (the dry run).
    counts = _counts(e_s, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=dev) - starts[e_s]
    keep = pos < capacity
    dst = torch.where(keep, e_s * capacity + pos, E * capacity)

    # F.embedding gathers the token rows: its backward sums a token's k
    # rows in a fixed order. Dropped rows all go to the overflow slot.
    rows = F.embedding(tok_s, xf)
    buf = xf.new_zeros((E * capacity + 1, d)).index_put((dst,), rows)
    buf = buf[:-1].reshape(E, capacity, d)

    # Each token's k contributions in sorted (ascending expert) order:
    # the sorted positions of token t are where `order` holds t*k..t*k+k-1.
    at = torch.empty_like(order)
    at[order] = torch.arange(n * k, device=dev)
    at = torch.sort(at.reshape(n, k), dim=1).values
    return buf, (dst, w_s, at), (~keep).sum()


def _combine(buf: torch.Tensor, plan, w1: torch.Tensor, w3: torch.Tensor,
             w2: torch.Tensor, dtype) -> torch.Tensor:
    """The batched expert FFN over `buf` with w1/w3 (E, d, f), w2
    (E, f, d) (all of d_ff, or one model cell's slice of it), then the
    weighted combine of each token's k rows, added in order -> (n, d)."""
    dst, w_s, at = plan
    E, C, d = buf.shape
    n, k = at.shape
    h = _f32_bmm(buf, w1)
    g = _f32_bmm(buf, w3)
    h = (F.silu(h) * g).to(dtype)
    y = _f32_bmm(h, w2).to(dtype)
    y_flat = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
    contrib = (y_flat[dst] * w_s[:, None]).to(dtype)
    parts = contrib[at.reshape(-1)].reshape(n, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


class PlacedExperts(tuple):
    """One MoE layer's experts split over the cells of a model axis, each
    cell's slice already on its device (`split_experts`): serving over a
    mesh places them once and passes them as the layer's `cells`."""


def split_experts(p: MoE, cells: Sequence) -> PlacedExperts:
    """Each model cell's slice of the experts' d_ff (and of the shared
    expert's) on the cell's device, in cell order: (device, w1, w3, w2,
    shared (w1, w3, w2) or None) a cell. On the weights' own device a
    slice is a view."""
    m = len(cells)
    shared = [None] * m
    if hasattr(p, "shared"):
        sh = p.shared
        shared = [(sh.w1[:, sl].to(dev), sh.w3[:, sl].to(dev),
                   sh.w2[sl].to(dev))
                  for dev, sl in zip(cells, _f_slices(sh.w1.shape[1], m))]
    return PlacedExperts(
        (dev, p.w1[:, :, sl].to(dev), p.w3[:, :, sl].to(dev),
         p.w2[:, sl].to(dev), s)
        for dev, sl, s in zip(cells, _f_slices(p.w1.shape[2], m), shared))


def _dispatch_combine(xf: torch.Tensor, gate_vals: torch.Tensor,
                      gate_idx: torch.Tensor, capacity: int,
                      w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, placed: Sequence = ()):
    """Sort-based dispatch -> batched expert FFN -> weighted combine.
    xf (n, d) tokens; gate_vals, gate_idx (n, k) from `route`; w1/w3
    (E, d, f), w2 (E, f, d) -> (out (n, d), dropped assignments, 0-d).
    `placed`: the experts' d_ff split over the cells of a model axis
    (`split_experts`); each cell then runs and combines its slice, and the
    partial outputs are added on xf's device in the order of the cells."""
    buf, plan, dropped = _dispatch(xf, gate_vals, gate_idx, capacity,
                                   w1.shape[0])
    if not placed:
        return _combine(buf, plan, w1, w3, w2, xf.dtype), dropped
    dst, w_s, at = plan
    devs = [c[0] for c in placed]
    out = None
    for (dev, c1, c3, c2, _), b, w in zip(placed,
                                          sharding.replicate(buf, devs),
                                          sharding.replicate(w_s, devs)):
        part = _combine(b, (dst.to(dev), w, at.to(dev)), c1, c3, c2,
                        xf.dtype).to(xf.device)
        out = part if out is None else out + part
    return out, dropped


def _f_slices(f: int, m: int) -> list:
    """The model cells' slices of a d_ff of f."""
    edges = [f * j // m for j in range(m + 1)]
    return [slice(a, b) for a, b in zip(edges, edges[1:])]


def _shared_expert(p: SharedExpert, xf: torch.Tensor,
                   placed: Sequence = ()) -> torch.Tensor:
    """The gated shared expert; over the cells of `placed`
    (`split_experts`) its d_ff is split as the routed experts' is, the
    partial products added in the order of the cells before the gate."""
    if not placed:
        h = F.silu(matmul(xf, p.w1)) * matmul(xf, p.w3)
        y = matmul(h, p.w2)
    else:
        devs = [c[0] for c in placed]
        y = None
        for (*_, (w1, w3, w2)), x in zip(placed,
                                         sharding.replicate(xf, devs)):
            h = F.silu(matmul(x, w1)) * matmul(x, w3)
            part = matmul(h, w2).to(xf.device)
            y = part if y is None else y + part
    gate = torch.sigmoid(matmul(xf, p.gate).float()).to(y.dtype)
    return y * gate


def moe_ffn_local(cfg: ArchConfig, p: MoE, xf: torch.Tensor,
                  cells: Sequence = ()):
    """MoE FFN on the tokens xf (n, d) -> (out (n, d), aux loss). `cells`:
    the devices of the model axis the experts' d_ff is split over, or
    their slices already placed there (`PlacedExperts`); none, or one
    device: all of it here."""
    E, k = cfg.n_experts, cfg.moe_top_k
    placed = (() if len(cells) <= 1 else cells
              if isinstance(cells, PlacedExperts) else
              split_experts(p, cells))
    n = xf.shape[0]
    logits = matmul(xf, p.router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = route(probs, k)
    out, dropped = _dispatch_combine(xf, gate_vals, gate_idx,
                                     capacity(cfg, n), p.w1, p.w3, p.w2,
                                     placed)
    if _DROPS is not None:
        _DROPS.append((n * k, dropped.detach()))
    if cfg.n_shared_experts:
        out = out + _shared_expert(p.shared, xf, placed)
    # Switch's load-balance loss: E * sum_e (token fraction)_e * (mass)_e,
    # the token's top-1 its first top-k id (the first maximum).
    f_e = _counts(gate_idx[:, 0], E).float() / n
    p_e = torch.mean(probs, dim=0)
    return out, E * torch.sum(f_e * p_e)


def moe_ffn(cfg: ArchConfig, p: MoE, x: torch.Tensor, *, mesh=None,
            batch_axes: tuple = (), cells: Sequence = ()):
    """MoE FFN on (B, T, d) -> (out (B, T, d), aux loss).

    With a mesh, as the JAX package's shard_map island: the tokens stay on
    their batch shard (`sharding.row_shards`: the batch axes where they
    divide B, else "data", else every shard holds them all), each shard
    dispatches its own tokens at its own capacity on its cell's device,
    the experts' d_ff is split over the shard's row of the model axis,
    and the aux loss is the mean over the shards. The outputs come back
    to x's device. `cells` (no mesh): the tokens are already one shard's,
    and these are the devices of its model axis."""
    B, T, d = x.shape
    if mesh is None:
        out, aux = moe_ffn_local(cfg, p, x.reshape(B * T, d), cells)
        return out.reshape(B, T, d), aux
    shards = sharding.row_shards(mesh, B, batch_axes)
    outs, aux = [], None
    for s, ps in zip(shards, sharding.replicas(p, [s.device
                                                   for s in shards])):
        xs = x[s.rows].to(s.device)
        o, a = moe_ffn_local(cfg, ps, xs.reshape(-1, d), s.cells)
        outs.append(o.reshape(xs.shape).to(x.device))
        a = a.to(x.device)
        aux = a if aux is None else aux + a
    return torch.cat(outs), aux / len(shards)
