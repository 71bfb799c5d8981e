"""Shape stand-ins for every entry point the dry run counts: each leaf's
shape, dtype, partition spec and per-device shard shape, with no weight
allocated.

The port of the JAX package's module of the same name. Where the JAX
module builds `jax.ShapeDtypeStruct`s with a `NamedSharding`, this one
gives `LeafSpec`s, the spec from `models/sharding.py` (the JAX package's
decisions) and the shard shape each device of the mesh would hold.
Parameters and caches are made on the `meta` device (`abstract_params`,
`cache_specs`): shapes and dtypes, no storage. Modality frontends are
stubs, as in the JAX package: audio and vision configs take frame or
patch embeddings of the documented shape.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.convert import lm_jax_tree
from repro_torch.models import sharding as shd
from repro_torch.models.model import Model, params_type

# Gradient-accumulation micro-batching of train_4k (global batch 256), the
# JAX package's choice for a 16 GB v5e.
TRAIN_ACCUM = {
    "xlstm-125m": 1, "qwen1.5-0.5b": 1, "seamless-m4t-medium": 8,
    "hymba-1.5b": 8, "qwen2-moe-a2.7b": 4, "chatglm3-6b": 4,
    "internvl2-26b": 8, "qwen3-14b": 8, "deepseek-coder-33b": 8,
    "mixtral-8x22b": 8,
}


def use_swa_for(cfg: ArchConfig, shape_name: str) -> bool:
    """SWA-native archs always; dense archs only for the long_500k
    variant."""
    if cfg.swa_always:
        return True
    return shape_name == "long_500k" and cfg.sliding_window is not None


class LeafSpec(NamedTuple):
    """One leaf: its global shape and dtype, its partition spec (a tuple
    of entries as `models/sharding.py` gives them) and the shape of the
    shard each device holds."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple
    shard_shape: tuple

    @property
    def shard_bytes(self) -> int:
        n = 1
        for d in self.shard_shape:
            n *= d
        return n * self.dtype.itemsize


def shard_shape(shape: tuple, spec: tuple, mesh_shape: dict) -> tuple:
    """The per-device shape of a leaf of `shape` under `spec`: each dim
    divided by the sizes of the axes it is split over (the specs only
    split dims that divide)."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        k = 1
        for a in axes:
            k *= mesh_shape[a]
        if n % k:
            raise ValueError(f"dim {n} of {shape} does not divide over "
                             f"{axes} ({k})")
        out.append(n // k)
    return tuple(out)


def _leaf(shape, dtype, spec, mesh_shape) -> LeafSpec:
    shape, spec = tuple(shape), tuple(spec)
    return LeafSpec(shape, dtype, spec, shard_shape(shape, spec, mesh_shape))


def _zip_tree(fn, tree, specs):
    """fn(leaf, spec) over a tree (dicts, lists, named tuples) and its
    tree of specs."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_tree(fn, v, s) for v, s in zip(tree, specs)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_tree(fn, v, s)
                            for v, s in zip(tree, specs)))
    return fn(tree, specs)


def leaves(tree) -> list:
    """The LeafSpecs of a tree, in order."""
    if isinstance(tree, LeafSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [x for v in tree for x in leaves(v)]


def shard_bytes(tree) -> int:
    """The bytes one device holds of a tree of LeafSpecs."""
    return sum(x.shard_bytes for x in leaves(tree))


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      accum: int) -> dict:
    ms = mesh.shape
    mb = shape.global_batch // accum
    T = shape.seq_len
    bspec = shd.batch_spec(ms, mb, cfg=cfg)
    lead = () if accum == 1 else (accum,)
    lspec = () if accum == 1 else (None,)
    spec = (*lspec, *bspec)
    batch = {
        "tokens": _leaf(lead + (mb, T), torch.int32, spec, ms),
        "targets": _leaf(lead + (mb, T), torch.int32, spec, ms),
        "valid": _leaf(lead + (mb, T), torch.float32, spec, ms),
    }
    if cfg.n_prefix:
        batch["prefix"] = _leaf(lead + (mb, cfg.n_prefix, cfg.d_model),
                                torch.bfloat16, (*spec, None), ms)
    return batch


def serve_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    ms = mesh.shape
    B, T = shape.global_batch, shape.seq_len
    bspec = shd.batch_spec(ms, B, cfg=cfg)
    if shape.kind == "prefill":
        batch = {"tokens": _leaf((B, T), torch.int32, bspec, ms)}
        if cfg.n_prefix:
            batch["prefix"] = _leaf((B, cfg.n_prefix, cfg.d_model),
                                    torch.bfloat16, (*bspec, None), ms)
        return batch
    # decode: ONE new token
    return {"tokens": _leaf((B, 1), torch.int32, bspec, ms),
            "pos": _leaf((), torch.int32, (), ms)}


def abstract_params(model: Model) -> Any:
    """The model's parameter module on the `meta` device: every shape and
    dtype, no storage."""
    return params_type(model.cfg)(model.cfg, device="meta")


def params_specs(cfg: ArchConfig, params: Any, mesh) -> dict:
    """The LeafSpec of every leaf of the JAX package's parameter tree of
    `params` (the layers stacked, `convert.lm_jax_tree`)."""
    tree = lm_jax_tree(params, lambda t: t)
    pspecs = shd.param_pspecs(cfg, tree, mesh.shape)
    return _zip_tree(lambda t, s: _leaf(t.shape, t.dtype, s, mesh.shape),
                     tree, pspecs)


def opt_specs(params_tree: dict) -> dict:
    """AdamW's state as `optim.adamw_init` makes it: the step (int32,
    replicated) and float32 moments `mu`, `nu` sharded as their
    parameters."""
    def f32(node):
        if isinstance(node, LeafSpec):
            return node._replace(dtype=torch.float32)
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        return [f32(v) for v in node]
    return {"step": LeafSpec((), torch.int32, (), ()),
            "mu": f32(params_tree), "nu": f32(params_tree)}


def cache_specs(cfg: ArchConfig, model: Model, shape: ShapeConfig, mesh,
                use_swa: bool) -> dict:
    """The serving cache of a decode step at the shape's batch and length
    (made on the `meta` device), leaf by leaf."""
    from repro_torch.models.model import build_model
    meta = model if model.device.type == "meta" else \
        build_model(cfg, device="meta")
    cache = meta.init_cache(shape.global_batch, shape.seq_len,
                            use_swa=use_swa)
    cspecs = shd.cache_pspecs(cache, mesh.shape, shape.global_batch)
    return _zip_tree(lambda t, s: _leaf(t.shape, t.dtype, s, mesh.shape),
                     cache, cspecs)
