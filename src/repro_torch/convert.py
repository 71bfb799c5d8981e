"""Weights carried across from the JAX package.

The JAX package's `BlockSparseModel` holds jax arrays; handed over as
numpy, its fields become the port's model on a device:

    fields = {f: np.asarray(getattr(jax_model, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    model = block_sparse_from_numpy(fields, shape=jax_model.shape,
                                    block_shape=jax_model.block_shape,
                                    orig_shape=jax_model.orig_shape,
                                    device="cpu")
"""

from __future__ import annotations

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
