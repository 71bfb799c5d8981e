"""Weights carried across from the JAX package.

The JAX package holds jax arrays; handed over as numpy, they become the
port's objects on a device: a packed `BlockSparseModel` or its int8
form `Int8BlockSparseModel`, a trained `DiSMECModel`, a `TronResult`, a
warm start W0, an LM's parameters (`lm_params_from_jax`; trained ones
go back with `lm_params_to_jax`), or a Table 2 baseline's model
(`*_model_from_numpy`). For example

    fields = {f: np.asarray(getattr(jax_model, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    model = block_sparse_from_numpy(fields, shape=jax_model.shape,
                                    block_shape=jax_model.block_shape,
                                    orig_shape=jax_model.orig_shape,
                                    device="cpu")
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.pruning import BlockSparseModel, Int8BlockSparseModel
from repro_torch.device import resolve_device


def block_sparse_from_numpy(fields: dict[str, np.ndarray], *, shape,
                            block_shape, orig_shape=None,
                            device=None) -> BlockSparseModel:
    """The port's `BlockSparseModel` from the numpy fields `blocks`,
    `block_rows`, `block_cols` and `row_ptr` (copied, on `device`; None:
    the card). Index arrays become int32, as the kernels take them."""
    device = resolve_device(device)

    def put(name, dtype=None):
        a = np.asarray(fields[name])
        return torch.tensor(a if dtype is None else a.astype(dtype),
                            device=device)
    return BlockSparseModel(
        blocks=put("blocks"), block_rows=put("block_rows", np.int32),
        block_cols=put("block_cols", np.int32),
        row_ptr=put("row_ptr", np.int32), shape=tuple(shape),
        block_shape=tuple(block_shape),
        orig_shape=None if orig_shape is None else tuple(orig_shape))


def int8_block_sparse_from_numpy(fields: dict[str, np.ndarray], *, shape,
                                 block_shape, orig_shape=None,
                                 device=None) -> Int8BlockSparseModel:
    """The port's `Int8BlockSparseModel` from the JAX one's numpy fields
    `blocks` (int8), `scales`, `block_rows`, `block_cols` and `row_ptr`
    (copied, on `device`; None: the card)."""
    coords = block_sparse_from_numpy(
        {**fields, "blocks": np.asarray(fields["blocks"], np.int8)},
        shape=shape, block_shape=block_shape, orig_shape=orig_shape,
        device=device)
    return Int8BlockSparseModel(
        blocks=coords.blocks,
        scales=torch.tensor(np.asarray(fields["scales"], np.float32),
                            device=coords.device),
        block_rows=coords.block_rows, block_cols=coords.block_cols,
        row_ptr=coords.row_ptr, shape=coords.shape,
        block_shape=coords.block_shape, orig_shape=coords.orig_shape)


def dismec_model_from_numpy(W: np.ndarray, *, delta: float,
                            n_labels: Optional[int] = None,
                            device=None):
    """The port's `DiSMECModel` from the JAX model's weights, handed over as
    `np.asarray(jax_model.W)` (copied, on `device`; None: the card)."""
    from repro_torch.core.dismec import DiSMECModel
    W = np.asarray(W, np.float32)
    return DiSMECModel(W=torch.tensor(W, device=resolve_device(device)),
                       delta=float(delta),
                       n_labels=int(W.shape[0] if n_labels is None
                                    else n_labels))


def tron_result_from_numpy(fields: dict[str, np.ndarray], *, device=None):
    """The port's `TronResult` from the JAX one's fields (`W`, `f`,
    `gnorm`, `n_newton`, `n_cg`, `converged`) as numpy arrays, e.g.
    `{k: np.asarray(v) for k, v in jax_result._asdict().items()}`."""
    from repro_torch.core.tron import TronResult
    device = resolve_device(device)
    dtypes = {"W": np.float32, "f": np.float32, "gnorm": np.float32,
              "n_newton": np.int32, "n_cg": np.int32, "converged": np.bool_}
    return TronResult(**{k: torch.tensor(np.asarray(fields[k], dt),
                                         device=device)
                         for k, dt in dtypes.items()})


def warm_start_from_numpy(W0: np.ndarray, *, device=None) -> torch.Tensor:
    """A TRON warm start W0 (L, D) from the JAX package's array, as float32
    on `device` (None: the card): the port's `train_label_batch` and
    `make_batch_solver(warm=True)` take it as is."""
    return torch.tensor(np.asarray(W0, np.float32),
                        device=resolve_device(device))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (ml_dtypes) by their
    bits."""
    a = np.array(a, order="C")                  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def layer_stacks(cfg) -> dict:
    """The block lists of an LM's parameter tree and their layer counts:
    `blocks` (n_layers) for the decoder-only stacks, `enc_blocks` and
    `dec_blocks` for the encoder-decoder."""
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import n_encoder_layers
        return {"enc_blocks": n_encoder_layers(cfg),
                "dec_blocks": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def _unstacked(cfg, tree: dict, leaf=lambda a: a) -> dict:
    """State-dict entries of the JAX package's LM parameter tree: each
    leaf through `leaf`, the leaves under a block list (`layer_stacks`)
    split at their leading layer axis into `<list>.<i>.` entries (or, for
    xLSTM, the i-th tree of the list)."""
    from repro_torch.models.transformer import uses_layer_scan
    flat: dict = {}
    stacked = uses_layer_scan(cfg)
    stacks = layer_stacks(cfg)

    def walk(prefix: str, sub: dict, layer: Optional[int]) -> None:
        for key, val in sub.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val, layer)
            else:
                a = leaf(val)
                flat[prefix + key] = a if layer is None else a[layer]

    for key, val in tree.items():
        if key in stacks:
            for i in range(stacks[key]):
                if stacked:
                    walk(f"{key}.{i}.", val, i)
                else:
                    walk(f"{key}.{i}.", val[i], None)
        elif isinstance(val, dict):
            walk(f"{key}.", val, None)
        else:
            flat[key] = leaf(val)
    return flat


def lm_params_from_flat(cfg, flat: dict, *, device=None):
    """The LM parameters of cfg (an `LMParams`, or an `EncDecParams` for
    the encoder-decoder) on `device` (None: the card) from state-dict
    entries; every leaf must fill a parameter of the same shape (cast to
    the parameter's type), and none may be missing."""
    from repro_torch.models.model import params_type
    params = params_type(cfg)(cfg, device=resolve_device(device))
    params.load_state_dict(flat, strict=True)
    return params


def lm_params_from_jax(cfg, params_np: dict, *, device=None):
    """The port's LM parameters (`models.transformer.LMParams`, or
    `models.encdec.EncDecParams`) from the JAX package's parameter tree as
    numpy arrays: `embed`, `final_norm`, `head` and `blocks`, whose leaves
    are stacked over the n_layers layers (leading dim L; for xLSTM a list
    of per-layer trees), or the encoder-decoder's `enc_blocks`,
    `enc_norm` and `dec_blocks`, each list stacked over its own count; e.g.
    `jax.tree.map(np.asarray, build_model(cfg).init(key))`. The layer axis
    is unstacked into `blocks.<i>.` entries; every leaf must fill a
    parameter of the same shape, and none may be missing."""
    flat = {k: _tensor(a) for k, a in
            _unstacked(cfg, params_np, np.asarray).items()}
    return lm_params_from_flat(cfg, flat, device=device)


def lm_jax_tree(params, leaf=lambda t: t.detach().cpu()) -> dict:
    """The JAX package's parameter tree of `params` (an `LMParams` or an
    `EncDecParams`) as nested dicts of each parameter through `leaf` (by
    default a host tensor of its type): the block lists' leaves
    (`layer_stacks`) stack the layers' parameters along a new leading axis
    (for xLSTM, `blocks` is a list of per-layer trees)."""
    from repro_torch.models.transformer import uses_layer_scan
    sd = {k: leaf(v) for k, v in params.state_dict().items()}
    stacked = uses_layer_scan(params.cfg)
    stacks = {k: len(getattr(params, k)) for k in layer_stacks(params.cfg)}
    tree: dict = {}
    if not stacked:
        tree["blocks"] = [{} for _ in params.blocks]
    for name, t in sd.items():
        path = name.split(".")
        node = tree
        if path[0] in stacks and not stacked:
            node, path = tree["blocks"][int(path[1])], path[2:]
        elif path[0] in stacks:
            if path[1] != "0":
                continue
            rest = ".".join(path[2:])
            t = torch.stack([sd[f"{path[0]}.{i}.{rest}"]
                             for i in range(stacks[path[0]])])
            path = [path[0]] + path[2:]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def lm_params_to_jax(cfg, params) -> dict:
    """The inverse of `lm_params_from_jax`: the JAX package's parameter
    tree of the port's `params` as numpy arrays, the layer axis stacked
    back (`lm_params_to_jax(cfg, lm_params_from_jax(cfg, t))` equals t).
    numpy has no bfloat16 here, so a bf16 parameter comes back as its
    exact float32 values."""
    for key, n in layer_stacks(cfg).items():
        if len(getattr(params, key)) != n:
            raise ValueError(f"{len(getattr(params, key))} {key} for a "
                             f"config of {n}")

    def to_np(node):
        if isinstance(node, dict):
            return {k: to_np(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_np(v) for v in node]
        return (node.float() if node.dtype == torch.bfloat16
                else node).numpy()
    return to_np(lm_jax_tree(params))


# --- The Table 2 baselines (`repro_torch.baselines`) ----------------------

def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def linear_model_from_numpy(W: np.ndarray, *, device=None):
    """L1-SVM's or PD-Sparse's model from the JAX one's `W` (L, D)."""
    from repro_torch.baselines.l1_svm import LinearModel
    return LinearModel(W=_f32(W, resolve_device(device)))


def leml_model_from_numpy(U: np.ndarray, V: np.ndarray, *, device=None):
    """LEML's model from the JAX one's `U` (D, r) and `V` (L, r)."""
    from repro_torch.baselines.leml import LEMLModel
    device = resolve_device(device)
    return LEMLModel(U=_f32(U, device), V=_f32(V, device))


def sleec_model_from_numpy(centroids: np.ndarray, regressors, embeddings,
                           labels, *, knn: int, device=None):
    """SLEEC's model from the JAX one's `centroids` (k, D) and its
    per-cluster lists `regressors` (D, r), `embeddings` (n_c, r) and
    `labels` (n_c, L)."""
    from repro_torch.baselines.sleec import SLEECModel
    device = resolve_device(device)
    return SLEECModel(centroids=_f32(centroids, device),
                      regressors=[_f32(a, device) for a in regressors],
                      embeddings=[_f32(a, device) for a in embeddings],
                      labels=[_f32(a, device) for a in labels], knn=int(knn))


def fastxml_model_from_numpy(trees: list[dict], *, n_labels: int,
                             device=None):
    """FastXML's model from flattened trees, each a dict of `splits` (S, D),
    `children` (S, 2) and `leaves` (n_leaves, L) arrays and the ints
    `root` and `depth`, numbered as `baselines.fastxml.Tree` numbers them
    (depth-first, a node before its left then its right subtree; a child
    code c >= 0 is internal node c, c < 0 leaf -1 - c); `splits` is (0, D)
    for a tree that is one leaf."""
    from repro_torch.baselines.fastxml import FastXMLModel, Tree
    device = resolve_device(device)
    return FastXMLModel(trees=[Tree(
        splits=_f32(t["splits"], device),
        children=torch.tensor(np.asarray(t["children"], np.int64)
                              .reshape(-1, 2), device=device),
        leaves=_f32(t["leaves"], device), root=int(t["root"]),
        depth=int(t["depth"])) for t in trees], n_labels=int(n_labels))
