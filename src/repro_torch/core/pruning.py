"""Model sparsity via restricted ambiguity (paper §2.2), and BSR packing.

Weights with |w| < Delta are set to exact zero after training (Algorithm
1, step 7). The pruned matrix is then packed into block-sparse form: W is
tiled into (bl, bd) blocks, all-zero blocks are dropped, and the predict
kernel (kernels/bsr_predict) visits only the survivors.

Packing matches the JAX package's `core/pruning.py` field for field,
including the fully pruned sentinel (one zero block, `row_ptr` all zeros),
so that checkpoints interoperate. Packing runs host-side in numpy, once,
offline; the packed arrays then live as tensors on the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device, to_numpy

#: The most bytes of dense rows `BlockSparseModel.dense_rows` builds at a
#: time, beside its output.
DENSE_CHUNK_BYTES = 1 << 28


def prune(W: torch.Tensor, delta: float) -> torch.Tensor:
    """Algorithm 1 step 7: zero all ambiguous weights |w| < delta."""
    return torch.where(W.abs() < delta, torch.zeros((), dtype=W.dtype,
                                                    device=W.device), W)


def nnz(W: torch.Tensor) -> torch.Tensor:
    """Count of nonzero weights (an int64 0-d tensor)."""
    return (W != 0.0).sum()


def sparsity(W: torch.Tensor) -> torch.Tensor:
    """Share of exact zeros."""
    return 1.0 - nnz(W) / W.numel()


def ambiguous_fraction(W: torch.Tensor, delta: float = 0.01) -> torch.Tensor:
    """Share of weights with |w| < delta: the paper reports 96% (Wiki-31K)
    and 99.5% (WikiLSHTC-325K)."""
    return (W.abs() < delta).float().mean()


def weight_histogram(W: torch.Tensor, bins: int = 81, lim: float = 0.2
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram of the learnt weights over `bins` equal bins of [-lim,
    lim] (paper Fig. 2a/2b): (counts int64 (bins,), edges (bins + 1,)).

    Bins are half-open [a, b), the last one closed, and values outside
    [-lim, lim] are not counted, as `jnp.histogram` does. `torch.histogram`
    has no CUDA version and `torch.histc` places values by float
    arithmetic, so each value is bucketed against the edges themselves.
    `torch.linspace` and `jnp.linspace` may differ by an ulp at an edge,
    and a value that close to an edge may then fall in the next bin.
    """
    edges = torch.linspace(-lim, lim, bins + 1, dtype=torch.float32,
                           device=W.device)
    w = W.reshape(-1).float()
    w = w[(w >= edges[0]) & (w <= edges[-1])]
    b = torch.bucketize(w, edges, right=True) - 1     # edges[b] <= w
    b = b.clamp_max(bins - 1)                          # the last bin closed
    return torch.bincount(b, minlength=bins), edges


@dataclasses.dataclass
class BlockSparseModel:
    """Packed BSR representation of a pruned weight matrix.

      blocks     : (n_blocks, bl, bd) packed nonzero blocks
      block_rows : (n_blocks,) int32 label-block index of each block (sorted)
      block_cols : (n_blocks,) int32 feature-block index of each block
      row_ptr    : (L/bl + 1,) int32 CSR-style offsets into the packed arrays
      shape      : (Lp, Dp) block-padded shape of the packed matrix
      orig_shape : (L, D) true pre-padding shape
    All four arrays are tensors on one device (`device`).
    """
    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    row_ptr: torch.Tensor
    shape: tuple[int, int]
    block_shape: tuple[int, int]
    orig_shape: tuple[int, int] | None = None

    @property
    def n_labels(self) -> int:
        """True label count (pre-padding)."""
        return (self.orig_shape or self.shape)[0]

    @property
    def n_features(self) -> int:
        """True feature dim (pre-padding)."""
        return (self.orig_shape or self.shape)[1]

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def density(self) -> float:
        bl, bd = self.block_shape
        total = (self.shape[0] // bl) * (self.shape[1] // bd)
        return self.n_blocks / max(total, 1)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def to(self, device) -> "BlockSparseModel":
        """The same model with its arrays on `device`."""
        return dataclasses.replace(
            self, blocks=to_device(self.blocks, device),
            block_rows=self.block_rows.to(device),
            block_cols=self.block_cols.to(device),
            row_ptr=self.row_ptr.to(device))

    def to_dense(self) -> torch.Tensor:
        """The (Lp, Dp) padded dense matrix, on the model's device."""
        return self.dense_rows(0, self.shape[0])

    def dense_rows(self, lo: int, hi: int, *, n_rows: int | None = None,
                   n_cols: int | None = None, device=None) -> torch.Tensor:
        """Rows [lo, hi) of the padded dense matrix, its first `n_cols`
        columns (all Dp when None), as a contiguous tensor on `device` (the
        model's when None); rows at or past `n_rows` (Lp when None) are
        zero. Row blocks are densified a chunk of at most DENSE_CHUNK_BYTES
        at a time, so no second dense copy of the rows is ever held."""
        bl, bd = self.block_shape
        Lp, Dp = self.shape
        n_cols = Dp if n_cols is None else n_cols
        top = min(hi, Lp if n_rows is None else n_rows)
        out = torch.zeros((hi - lo, n_cols), dtype=self.blocks.dtype,
                          device=self.device if device is None else device)
        if top <= lo:
            return out
        ptr = self.row_ptr.tolist()
        step = max(1, DENSE_CHUNK_BYTES
                   // (bl * Dp * self.blocks.element_size()))
        end = -(-top // bl)
        for b0 in range(lo // bl, end, step):
            b1 = min(b0 + step, end)
            p0, p1 = ptr[b0], ptr[b1]
            tile = torch.zeros((b1 - b0, Dp // bd, bl, bd),
                               dtype=self.blocks.dtype, device=self.device)
            tile[(self.block_rows[p0:p1] - b0).long(),
                 self.block_cols[p0:p1].long()] = self.blocks[p0:p1]
            tile = tile.permute(0, 2, 1, 3).reshape((b1 - b0) * bl, Dp)
            r0, r1 = max(lo, b0 * bl), min(top, b1 * bl)
            out[r0 - lo:r1 - lo].copy_(tile[r0 - b0 * bl:r1 - b0 * bl,
                                            :n_cols])
        return out

    def quantize(self) -> "Int8BlockSparseModel":
        """Symmetric per-block int8 artifact of this model, on its device
        (see `quantize_block_sparse`)."""
        return quantize_block_sparse(self)

    def save(self, directory: str, *, meta: dict | None = None) -> None:
        """Persist as the serving checkpoint artifact (checkpoint/io.py)."""
        from repro_torch.checkpoint.io import save_block_sparse
        save_block_sparse(self, directory, meta=meta)

    @staticmethod
    def load(directory: str, *, device=None) -> tuple["BlockSparseModel",
                                                      dict]:
        """Returns (model, meta). Inverse of `save`."""
        from repro_torch.checkpoint.io import load_block_sparse
        return load_block_sparse(directory, device=device)


#: Symmetric int8 range: scale = max|block| / INT8_QMAX.
INT8_QMAX = 127


def quantize_blocks(blocks) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-block int8 quantization of packed (nb, bl, bd) blocks,
    as the JAX package computes it: q int8 with q[k] ~= blocks[k] /
    scales[k], scales[k] = max|blocks[k]| / 127, round half to even. An
    all-zero block gets scale 0 and exact zeros. The checkpoint writer
    persists both arrays."""
    b = to_numpy(blocks).astype(np.float32, copy=False)
    amax = np.abs(b).max(axis=(1, 2))
    scales = (amax / INT8_QMAX).astype(np.float32)
    safe = np.where(scales > 0.0, scales, 1.0)[:, None, None]
    q = np.clip(np.rint(b / safe), -INT8_QMAX, INT8_QMAX).astype(np.int8)
    return q, scales


def dequantize_blocks(q, scales) -> np.ndarray:
    """Inverse of `quantize_blocks` up to the rounding bound scales / 2."""
    return (to_numpy(q).astype(np.float32)
            * to_numpy(scales).astype(np.float32)[:, None, None])


@dataclasses.dataclass
class Int8BlockSparseModel:
    """Packed BSR with symmetric per-block int8 values and fp32 scales: the
    `int8` backend's artifact. Each surviving (bl, bd) block stores int8
    values and one scale; coordinates and shapes are those of the fp32
    `BlockSparseModel` it was quantized from (the same tensors, not
    copies). The int8 kernels widen the values in registers and multiply
    each block's fp32 partial dot by its scale.
    """
    blocks: torch.Tensor                 # (n_blocks, bl, bd) int8
    scales: torch.Tensor                 # (n_blocks,) float32
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    row_ptr: torch.Tensor
    shape: tuple[int, int]
    block_shape: tuple[int, int]
    orig_shape: tuple[int, int] | None = None

    @property
    def n_labels(self) -> int:
        return (self.orig_shape or self.shape)[0]

    @property
    def n_features(self) -> int:
        return (self.orig_shape or self.shape)[1]

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def payload_bytes(self) -> int:
        """Bytes of the quantized payload (int8 blocks + scales)."""
        return self.blocks.numel() + 4 * int(self.scales.shape[0])

    def to(self, device) -> "Int8BlockSparseModel":
        """The same model with its arrays on `device`."""
        return dataclasses.replace(
            self, blocks=to_device(self.blocks, device),
            scales=self.scales.to(device),
            block_rows=self.block_rows.to(device),
            block_cols=self.block_cols.to(device),
            row_ptr=self.row_ptr.to(device))

    def dequantize(self) -> BlockSparseModel:
        """Back to a float32 `BlockSparseModel` (within the rounding
        bound), on the same device; the serving kernels never use it."""
        blocks = torch.from_numpy(dequantize_blocks(self.blocks, self.scales))
        return BlockSparseModel(
            blocks=blocks.to(self.device), block_rows=self.block_rows,
            block_cols=self.block_cols, row_ptr=self.row_ptr,
            shape=self.shape, block_shape=self.block_shape,
            orig_shape=self.orig_shape)


def quantize_block_sparse(model: BlockSparseModel) -> Int8BlockSparseModel:
    """Quantize a packed fp32 model to the int8 serving artifact, on the
    model's device; the coordinate tensors are shared, not copied."""
    q, scales = quantize_blocks(model.blocks)
    return Int8BlockSparseModel(
        blocks=to_device(torch.from_numpy(q), model.device),
        scales=torch.from_numpy(scales).to(model.device),
        block_rows=model.block_rows, block_cols=model.block_cols,
        row_ptr=model.row_ptr, shape=model.shape,
        block_shape=model.block_shape, orig_shape=model.orig_shape)


def _model(blocks, rows, cols, row_ptr, shape, block_shape, orig_shape,
           device) -> BlockSparseModel:
    def put(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(device)
    return BlockSparseModel(
        blocks=put(blocks), block_rows=put(rows, np.int32),
        block_cols=put(cols, np.int32), row_ptr=put(row_ptr, np.int32),
        shape=tuple(shape), block_shape=tuple(block_shape),
        orig_shape=None if orig_shape is None else tuple(orig_shape))


def to_block_sparse(W, block_shape: tuple[int, int] = (128, 128),
                    pad_value: float = 0.0, *, row_block_offset: int = 0,
                    sentinel_if_empty: bool = True,
                    device=None) -> BlockSparseModel:
    """Convert a (pruned) dense matrix (tensor or array) to packed BSR.

    With `row_block_offset=k` the result describes rows [k*bl, k*bl + L)
    of a larger matrix: `block_rows` are offset into the enclosing matrix
    while `shape` and `row_ptr` stay local to this slice, so consecutive
    slices join with `concat_block_sparse`. `sentinel_if_empty=False` lets
    an all-zero slice stay truly empty (0 packed blocks). The packed arrays
    land on `device` (None: the card).
    """
    device = resolve_device(device)
    Wn = to_numpy(W)
    L, D = Wn.shape
    bl, bd = block_shape
    Lp = ((L + bl - 1) // bl) * bl
    Dp = ((D + bd - 1) // bd) * bd
    if (Lp, Dp) != (L, D):
        Wp = np.full((Lp, Dp), pad_value, Wn.dtype)
        Wp[:L, :D] = Wn
        Wn = Wp
    nbl, nbd = Lp // bl, Dp // bd
    tiles = Wn.reshape(nbl, bl, nbd, bd).transpose(0, 2, 1, 3)
    nonzero = np.abs(tiles).max(axis=(2, 3)) > 0.0              # (nbl, nbd)
    rows, cols = np.nonzero(nonzero)                            # row-major
    blocks = tiles[rows, cols]                                  # (nb, bl, bd)
    counts = np.bincount(rows, minlength=nbl)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    if blocks.shape[0] == 0 and sentinel_if_empty:              # fully pruned
        blocks = np.zeros((1, bl, bd), Wn.dtype)
        rows = np.zeros((1,), np.int64)
        cols = np.zeros((1,), np.int64)
        row_ptr = np.zeros(nbl + 1, np.int32)
    return _model(blocks, rows + row_block_offset, cols, row_ptr, (Lp, Dp),
                  block_shape, (L, D), device)


def concat_block_sparse(parts: list[BlockSparseModel],
                        orig_shape: tuple[int, int]) -> BlockSparseModel:
    """Stack per-batch BSR slices (append form, consecutive row ranges) into
    one servable model without touching any packed block: blocks, rows and
    cols concatenate, and each part's local row_ptr is shifted by the
    packed-block count of everything before it. The result lives on the
    first part's device."""
    if not parts:
        raise ValueError("concat_block_sparse needs at least one part")
    bl, bd = parts[0].block_shape
    Dp = parts[0].shape[1]
    device = parts[0].device
    blocks, rows, cols, row_ptr = [], [], [], [np.zeros(1, np.int32)]
    row_block_off = 0
    n_packed = 0
    for p in parts:
        if tuple(p.block_shape) != (bl, bd) or p.shape[1] != Dp:
            raise ValueError("parts disagree on block shape / feature width")
        p_rows = to_numpy(p.block_rows).astype(np.int64)
        p_ptr = to_numpy(p.row_ptr).astype(np.int64)
        n_p = int(p_ptr[-1])            # packed blocks (0 for empty parts;
        if n_p:                         # the sentinel would report ptr[-1]=0)
            if p_rows[0] < row_block_off:
                raise ValueError("part rows overlap the previous part")
            blocks.append(to_numpy(p.blocks)[:n_p])
            rows.append(p_rows[:n_p])
            cols.append(to_numpy(p.block_cols).astype(np.int64)[:n_p])
        row_ptr.append(p_ptr[1:] + n_packed)
        n_packed += n_p
        row_block_off += p.shape[0] // bl
    L, D = orig_shape
    Lp = row_block_off * bl
    if Lp < L or Dp < D:
        raise ValueError(f"parts cover ({Lp}, {Dp}), need {orig_shape}")
    if n_packed == 0:                                           # fully pruned
        return _model(np.zeros((1, bl, bd), np.float32), np.zeros(1),
                      np.zeros(1), np.zeros(row_block_off + 1), (Lp, Dp),
                      (bl, bd), orig_shape, device)
    return _model(np.concatenate(blocks, axis=0), np.concatenate(rows),
                  np.concatenate(cols), np.concatenate(row_ptr), (Lp, Dp),
                  (bl, bd), orig_shape, device)
