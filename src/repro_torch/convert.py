"""Weights carried across from the JAX package.

The JAX package holds jax arrays; handed over as numpy, they become the
port's objects on a device: a packed `BlockSparseModel`, a trained
`DiSMECModel`, a `TronResult`, or a warm start W0. For example

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

from repro_torch.core.pruning import BlockSparseModel
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
