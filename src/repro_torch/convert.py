"""Weights carried across from the JAX package.

The JAX package holds jax arrays; handed over as numpy, they become the
port's objects on a device: a packed `BlockSparseModel` or its int8
form `Int8BlockSparseModel`, a trained `DiSMECModel`, a `TronResult`, a
warm start W0, an LM's parameters (`lm_params_from_jax`), or a Table 2
baseline's model (`*_model_from_numpy`). For example

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


def lm_params_from_jax(cfg, params_np: dict, *, device=None):
    """The port's LM parameters (`models.transformer.LMParams`) from the
    JAX package's parameter tree as numpy arrays: `embed`, `final_norm`,
    `head` and `blocks`, whose leaves are stacked over the n_layers
    layers (leading dim L), e.g.
    `jax.tree.map(np.asarray, build_model(cfg).init(key))`. The layer axis
    is unstacked into `blocks.<i>.` entries; every leaf must fill a
    parameter of the same shape, and none may be missing."""
    from repro_torch.models.transformer import LMParams

    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, tree, layer: Optional[int]) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val, layer)
            else:
                a = np.asarray(val)
                flat[prefix + key] = _tensor(a if layer is None else a[layer])

    for key, val in params_np.items():
        if key == "blocks":
            for i in range(cfg.n_layers):
                walk(f"blocks.{i}.", val, i)
        elif isinstance(val, dict):
            walk(f"{key}.", val, None)
        else:
            flat[key] = _tensor(np.asarray(val))
    params = LMParams(cfg, device=resolve_device(device))
    params.load_state_dict(flat, strict=True)
    return params


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
