"""Partition specs for LM parameters, batches and caches, and how the port
places a training step's pieces on a mesh.

The port of the JAX package's module of the same name. Its conventions
(mesh axes: optional "pod", then "data", "model"):

  weights : FSDP over "data" x tensor-parallel over "model". Every 2-D
            projection (a, b) is (fsdp, tp) or (tp, fsdp) by which dim is
            the TP dim; a dim that does not divide its axis is replicated.
            The head (and a tied embedding) is always label-sharded over
            "model", the paper's layer-1 parallelism; `backbone_tp=False`
            replicates the rest of the backbone.
  batch   : over ("pod", "data") (and "model" when the backbone has no
            TP), with fallbacks when the batch does not divide them.
  caches  : batch over (pod, data), length over "model"; B = 1: length
            over ("data", "model").

`batch_axes`, `batch_spec`, `param_pspecs` and `cache_pspecs` keep every
decision of the JAX functions. They take leaves' shapes (anything with a
`.shape`, or a tuple of ints), so no weights need to be allocated, and
return each spec as a tuple of entries, as `tuple(PartitionSpec(...))`
reads: an axis name, a tuple of names, or None (replicated). The JAX
module's `named` (a `NamedSharding` per spec) has no counterpart: the
port has no compiler that places arrays by spec.

The port's mesh is a grid of devices driven from one process
(`launch/mesh.py`), so the pieces of a training step are placed by hand:

  row_shards    — the batch shards of the backbone: each runs its forward
                  and backward on one cell's device (`shard_axes`: the
                  batch axes with the JAX package's fallbacks);
  replicate     — copies of a tensor for several devices, whose gradients
                  come back summed in the order of the devices;
  replicas      — a parameter module for each of several devices (its
                  tensors from `replicate`);
  head_cells    — the (row shard, label shard) cells of the head losses.

Serving over a mesh (`prefill` and `decode_step` with `mesh=`) has no
gradients to gather, and a decode step cannot afford to copy the weights,
so it places them once per (params, mesh) and reuses them:

  serving_placement — the parameters on each cell's device (the tensors
                  themselves on their own device), each MoE layer's
                  experts split over a row of the model axis, and the head
                  (or tied embedding) in float32 label shards over `model`
                  (`prediction.shard_rows`);
  MeshCache     — each row shard's serving cache (the one-device layout
                  of its rows) on its cell; `split_cache` makes one from a
                  one-device cache, `gather_cache` the reverse.

A device may repeat in the grid: then a copy is a view, and the sums keep
their fixed order.
"""

from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prediction

FSDP, TP = "data", "model"


def _axis(mesh_shape: dict, name: str, size: int) -> Optional[str]:
    """The axis name if `size` divides the axis, else None (replicate)."""
    return name if name in mesh_shape and size % mesh_shape[name] == 0 \
        else None


def _entry(axes: tuple):
    """A spec entry as `PartitionSpec` normalises it: one axis by name."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_axes(mesh_shape: dict, cfg: Optional[ArchConfig] = None) -> tuple:
    """Mesh axes the batch shards over. With backbone_tp=False the `model`
    axis carries no backbone TP and becomes more data parallelism for the
    backbone: data-parallel features, a label-parallel head."""
    axes = ("pod", "data") if "pod" in mesh_shape else ("data",)
    if cfg is not None and not cfg.backbone_tp:
        axes = axes + (TP,)
    return axes


def batch_spec(mesh_shape: dict, global_batch: int, extra=(None,),
               cfg: Optional[ArchConfig] = None) -> tuple:
    """The batch's spec: the first of the batch axes, the same without
    `model`, then ("data",), whose sizes divide the batch; else
    replicated."""
    axes = batch_axes(mesh_shape, cfg)
    cands = [axes]
    base = ("pod", "data") if "pod" in mesh_shape else ("data",)
    if axes != base:
        cands.append(base)
    if base != ("data",):
        cands.append(("data",))
    for c in cands:
        n = 1
        for a in c:
            n *= mesh_shape[a]
        if global_batch % n == 0:
            return (_entry(c), *extra)
    return (None, *extra)


# Leaf names whose LAST dim is the tensor-parallel dim (column-parallel)...
_TP_LAST = {"wq", "wk", "wv", "w1", "w3", "w_in", "w_if", "w_dt", "w"}
# ...and whose SECOND-TO-LAST dim is (row-parallel / vocab-sharded).
_TP_FIRST = {"wo", "w2", "w_out", "embed", "head", "lm_head"}
# Contraction-dim-only sharding (the output dim is small or must stay
# whole).
_FSDP_ONLY = {"router", "gate"}
# Fully replicated: a small projection whose TP-sharded output would make
# every SSM chunk step a partial sum.
_REPLICATE = {"w_bc"}
# The extreme output layer (and a tied embedding): always label-sharded.
_HEAD_NAMES = {"embed", "head", "lm_head"}


def _is_shape(node) -> bool:
    return isinstance(node, tuple) and all(isinstance(d, int) for d in node)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map_tree(fn, node, path: tuple = ()):
    """fn(path, leaf) over nested dicts, lists and (named) tuples, keeping
    the structure; a leaf has a `.shape` or is a tuple of ints."""
    if isinstance(node, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(node)]
    if isinstance(node, tuple) and not _is_shape(node):
        items = [_map_tree(fn, v, path + (i,)) for i, v in enumerate(node)]
        return type(node)(*items) if hasattr(node, "_fields") else \
            tuple(items)
    return fn(path, node)


def param_pspecs(cfg: ArchConfig, params, mesh_shape: dict):
    """The spec of every leaf of `params` (the JAX package's parameter
    tree: nested dicts and lists, by leaf-name patterns). A 2-D (or
    stacked 3-D / 4-D) weight gets (..., fsdp dim, tp dim), each axis
    dropped where the dim does not divide it."""

    def spec_for(path: tuple, leaf) -> tuple:
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        shape = _shape(leaf)
        if len(shape) <= 1 or name is None or name in _REPLICATE:
            return ()
        lead = (None,) * (len(shape) - 2)
        # backbone_tp=False replicates the backbone whole (not FSDP): a
        # recurrent stack applies its weights at every time step.
        if not cfg.backbone_tp and name not in _HEAD_NAMES:
            return ()
        if name in _TP_FIRST:
            return (*lead, _axis(mesh_shape, TP, shape[-2]),
                    _axis(mesh_shape, FSDP, shape[-1]))
        if name in _TP_LAST:
            return (*lead, _axis(mesh_shape, FSDP, shape[-2]),
                    _axis(mesh_shape, TP, shape[-1]))
        if name in _FSDP_ONLY:
            return (*lead, _axis(mesh_shape, FSDP, shape[-2]), None)
        return ()

    return _map_tree(spec_for, params)


def cache_pspecs(cache, mesh_shape: dict, global_batch: int):
    """KV caches (L, B, T, KV, hd): batch over (pod, data), T over model;
    B = 1: T over every axis it divides. Recurrent states (L, B, ...):
    batch over data where it divides.

    These are the JAX package's specs (the dry run's per-device bytes). The
    port's serving over a mesh (`MeshCache`) splits the batch as they do
    but keeps each row shard's cache length whole on that shard's cell:
    the port replicates the backbone on each row shard's cell, so the
    weights, not the cache, set a card's memory; and a length split would
    add a softmax merged across cards, in an order the JAX reference does
    not pin down. Splitting the length over cards is the next step once
    several cards exist (ROADMAP)."""
    del global_batch                      # the JAX function ignores it too

    def n_of(axes) -> int:
        n = 1
        for a in axes:
            n *= mesh_shape[a]
        return n

    def spec_for(_path, leaf) -> tuple:
        shape = _shape(leaf)
        baxes = batch_axes(mesh_shape)
        if len(shape) == 5:                             # stacked attn cache
            B, T = shape[1], shape[2]
            if B % n_of(baxes) == 0:
                return (None, _entry(baxes), _axis(mesh_shape, TP, T), None,
                        None)
            if B % mesh_shape["data"] == 0:
                return (None, "data", _axis(mesh_shape, TP, T), None, None)
            seq = tuple(a for a in ("data", "model")
                        if T % mesh_shape[a] == 0)
            if len(seq) == 2 and T % (mesh_shape["data"] *
                                      mesh_shape["model"]) == 0:
                return (None, None, seq, None, None)
            return (None, None, seq[0] if seq else None, None, None)
        if len(shape) >= 2:                             # recurrent states
            rest = (None,) * (len(shape) - 2)
            if shape[1] % n_of(baxes) == 0:
                return (None, _entry(baxes), *rest)
            if shape[1] % mesh_shape["data"] == 0:
                return (None, "data", *rest)
            return (None,) * len(shape)
        return (None,)

    return _map_tree(spec_for, cache)


# ---------------------------------------------------------------------------
# Placing a training step on the port's mesh
# ---------------------------------------------------------------------------

def shard_axes(mesh_shape: dict, B: int, batch_axes: Sequence[str]) -> tuple:
    """The axes the backbone's batch shards over: the caller's batch axes,
    then the same without `model`, then ("data",), the first whose size
    divides B; () for none (every cell holds the whole batch, as the JAX
    MoE island replicates a B = 1 batch)."""
    cands = []
    if batch_axes:
        cands.append(tuple(batch_axes))
        rows = tuple(a for a in batch_axes if a != TP)
        if rows and rows != cands[0]:
            cands.append(rows)
    cands.append(("data",))
    for c in cands:
        n = 1
        for a in c:
            n *= mesh_shape[a]
        if B % n == 0:
            return c
    return ()


@dataclasses.dataclass(frozen=True)
class RowShard:
    """One batch shard of the backbone: its rows, the device its forward
    and backward run on, and the devices of its row of the model axis
    (where a MoE layer splits its experts' d_ff; its own device alone when
    the shard is one cell of the model axis)."""
    rows: slice
    device: torch.device
    cells: tuple


def row_shards(mesh, B: int, batch_axes: Sequence[str]) -> list:
    """The backbone's batch shards of a B-row batch, in the JAX package's
    order (data major)."""
    axes = shard_axes(mesh.shape, B, batch_axes)
    D, M = mesh.shape["data"], mesh.shape["model"]
    cells = [(i, j) for i in range(D) for j in range(M)
             if ("data" in axes or i == 0) and ("model" in axes or j == 0)]
    n = B // len(cells)
    return [RowShard(slice(k * n, (k + 1) * n), mesh.devices[i][j],
                     (mesh.devices[i][j],) if "model" in axes else
                     tuple(mesh.devices[i]))
            for k, (i, j) in enumerate(cells)]


class _Replicate(torch.autograd.Function):
    """Copies of one tensor for several devices; the backward adds the
    copies' gradients on the tensor's device in the order of the
    devices."""

    @staticmethod
    def forward(ctx, t, devices):
        ctx.device = t.device
        return tuple(t.view_as(t) if d == t.device else t.to(d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            g = g.to(ctx.device)
            total = g if total is None else total + g
        return total, None


def replicate(t: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """A copy of `t` for each device (a view where the device is t's);
    their gradients are gathered to t's device and added in this order.
    One device, t's own: [t]."""
    devices = [torch.device(d) for d in devices]
    if devices == [t.device]:
        return [t]
    return list(_Replicate.apply(t, devices))


def replicas(module: torch.nn.Module, devices: Sequence) -> list:
    """A copy of the parameter module for each device, its parameters
    from `replicate` (the structure copied, the tensors not where the
    device is the module's own)."""
    tensors = [(p, replicate(p, devices)) for p in module.parameters()]
    out = []
    for k in range(len(devices)):
        memo = {id(p): reps[k] for p, reps in tensors}
        if hasattr(module, "cfg"):
            memo[id(module.cfg)] = module.cfg
        out.append(copy.deepcopy(module, memo))
    return out


def head_cells(mesh, n_rows: int, batch_axes: Sequence[str]):
    """The head's cells: (row slices, label-shard count, device of cell
    (i, j) by [i][j]). Rows go over the batch axes minus `model` (the
    data axis here, where it divides the rows; else one row shard), the
    labels over `model`."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    by_rows = "data" in batch_axes and n_rows % D == 0
    nr = D if by_rows else 1
    n = n_rows // nr
    return ([slice(i * n, (i + 1) * n) for i in range(nr)], M,
            [list(mesh.devices[i]) for i in range(nr)])


# ---------------------------------------------------------------------------
# Placing serving on the port's mesh
# ---------------------------------------------------------------------------

def place(module: torch.nn.Module, device) -> torch.nn.Module:
    """The parameter module on `device`: the module itself where it lies
    there, else a copy of its structure holding copies of its tensors
    (no gradient)."""
    device = torch.device(device)
    tensors = list(module.parameters())
    if all(t.device == device for t in tensors):
        return module
    memo = {id(t): torch.nn.Parameter(t.detach().to(device),
                                      requires_grad=False) for t in tensors}
    if hasattr(module, "cfg"):
        memo[id(module.cfg)] = module.cfg
    return copy.deepcopy(module, memo)


class ServingPlacement:
    """What serving over one mesh reads of one parameter module, placed
    on the cells' devices once (`serving_placement`):

      params(device)   — the parameters on a device (`place`);
      experts(cells)   — per layer, a MoE layer's experts split over the
                         devices `cells` of a row of the model axis
                         (`moe.split_experts`), () for other layers;
      head             — the head (or the tied embedding) in float32,
                         split into label shards over `model`
                         (`prediction.shard_rows`), shard j on cell
                         (0, j): what `predict_topk_sharded` reads.

    Each piece is made once (the head here, the rest at its first use) and
    kept; on a device that holds the weights already, it is the tensor
    itself (a view), not a copy."""

    def __init__(self, params, mesh, W: torch.Tensor):
        # A weak reference: the placements are kept in a dict weakly keyed
        # by the parameters.
        self._source = weakref.ref(params)
        self._params: dict = {}
        self._experts: dict = {}
        self.versions = _versions(params)
        self.head = prediction.shard_rows(W.float(), mesh)

    def params(self, device) -> torch.nn.Module:
        device = torch.device(device)
        if device in self._params:
            return self._params[device]
        p = place(self._source(), device)
        if p is not self._source():
            self._params[device] = p
        return p

    def experts(self, cells: tuple) -> list:
        from repro_torch.models import moe
        if cells not in self._experts:
            p = self.params(cells[0])
            self._experts[cells] = [
                moe.split_experts(blk.moe, cells) if hasattr(blk, "moe")
                else () for blk in p.blocks]
        return self._experts[cells]


def _versions(params) -> Optional[tuple]:
    """Each parameter's version counter (None for inference tensors, which
    keep none)."""
    try:
        return tuple(t._version for t in params.parameters())
    except RuntimeError:
        return None


_PLACEMENTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def serving_placement(params, mesh, W: torch.Tensor) -> ServingPlacement:
    """The serving placement of `params` on `mesh` (W: its head weight),
    made once per (params, mesh) and reused by every later call; made
    anew if a parameter was changed in place since (a training step)."""
    by_mesh = _PLACEMENTS.setdefault(params, {})
    placed = by_mesh.get(mesh)
    if placed is None or placed.versions != _versions(params):
        placed = by_mesh[mesh] = ServingPlacement(params, mesh, W)
    return placed


@dataclasses.dataclass
class MeshCache:
    """A serving cache over a mesh: `shards[i]` is row shard i's cache in
    the one-device layout of its rows `rows[i]`, on that shard's cell."""
    rows: tuple
    shards: list


def _map_cache(cache: dict, fn) -> dict:
    """fn(tensor, batch dim) over a one-device cache: k/v (and the stacked
    Mamba state) (L, B, ...), xLSTM's per-layer states (B, ...)."""
    out = {}
    for key, val in cache.items():
        if key == "states":
            out[key] = [type(st)(*(fn(t, 0) for t in st)) for st in val]
        elif isinstance(val, tuple):
            out[key] = type(val)(*(fn(t, 1) for t in val))
        else:
            out[key] = fn(val, 1)
    return out


def split_cache(cache: dict, shards: Sequence[RowShard]) -> MeshCache:
    """A one-device cache as a MeshCache over the row shards: each shard's
    rows on its cell (a view where the cache lies there already)."""
    return MeshCache(tuple(s.rows for s in shards), [
        _map_cache(cache, lambda t, dim, s=s:
                   t.narrow(dim, s.rows.start,
                            s.rows.stop - s.rows.start).to(s.device))
        for s in shards])


def gather_cache(cache: MeshCache, device) -> dict:
    """A MeshCache in the one-device layout on `device`: the row shards'
    caches joined along the batch in row order."""
    shards = cache.shards

    def cat(get, dim):
        return torch.cat([get(c).to(device) for c in shards], dim=dim)
    out = {}
    for key, val in shards[0].items():
        if key == "states":
            out[key] = [type(st)(*(cat(lambda c: c[key][n][f], 0)
                                   for f in range(len(st))))
                        for n, st in enumerate(val)]
        elif isinstance(val, tuple):
            out[key] = type(val)(*(cat(lambda c: c[key][f], 1)
                                   for f in range(len(val))))
        else:
            out[key] = cat(lambda c: c[key], 1)
    return out
