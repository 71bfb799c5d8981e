"""Public wrappers: BSR prediction over a pruned DiSMEC model.

`bsr_predict` yields the (n, Lp) score matrix; `bsr_predict_topk` joins it
to the blocked top-k (kernels/topk) as the serving entry point of
`repro_torch.serve.xmc.BsrBackend`. `bsr_predict_int8[_topk]` does the same
over the int8 artifact (`Int8Backend`). The gathered forms score only a
selection of row blocks, the fine stage of `ShortlistBackend`: shared by
the micro-batch, `sel` (B,) -> (n, B * bl) (`bsr_predict_gather[_int8]`),
or each query's own, `sel` (n, B) (`bsr_predict_gather_pq[_int8]`); their
`_topk` forms translate the candidates back to label ids. A sorted selection of
every row block reproduces the exhaustive path bit for bit.

Each `*_cuda` function launches one entry point of csrc/bsr_predict.cu and
counts its launches (`fn.launches`); the `*_blocks` dispatchers run it on a
CUDA tensor and its plain version (ref.py) on a CPU tensor; any other
device raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pruning import BlockSparseModel, Int8BlockSparseModel
from repro_torch.device import to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_predict import ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk.ref import NEG_INF

#: The exhaustive int8 kernel runs the gathered design (`gather_kernel`,
#: each row block its own slot) up to this many rows and `bsr_kernel` above
#: it; both give the same bits. Set where the two designs' times cross on
#: an H100 (PERF.md, kernel 4).
INT8_GATHER_MAX_N = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bsr_predict_f32": [_P] * 5 + [_I] * 8 + [_P],
    "bsr_predict_int8": [_P] * 6 + [_I] * 8 + [_P],
    "bsr_gather_f32": [_P] * 6 + [_I] * 8 + [_P],
    "bsr_gather_int8": [_P] * 7 + [_I] * 8 + [_P],
    "bsr_gather_pq_f32": [_P] * 6 + [_I] * 8 + [_P],
    "bsr_gather_pq_int8": [_P] * 7 + [_I] * 8 + [_P],
}


def _launch(symbol: str, x: torch.Tensor, blocks: torch.Tensor,
            scales, block_cols: torch.Tensor, row_ptr: torch.Tensor, sel,
            n_row_blocks: int, slots: int) -> torch.Tensor:
    """Check what every entry point takes, allocate the (n, slots * bl)
    output and launch `symbol` on the current stream."""
    n, Dp = x.shape
    nb, bl, bd = blocks.shape
    int8 = scales is not None
    tensors = [t for t in (x, blocks, scales, block_cols, row_ptr, sel)
               if t is not None]
    if x.device.type != "cuda" or any(
            t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{symbol} takes contiguous tensors on one CUDA "
                         "device")
    want = (torch.int8 if int8 else torch.float32)
    if (x.dtype != torch.float32 or blocks.dtype != want
            or (int8 and scales.dtype != torch.float32)
            or any(t.dtype != torch.int32 for t in (block_cols, row_ptr, sel)
                   if t is not None)):
        raise ValueError(f"{symbol} takes float32 x, {want} blocks"
                         + (", float32 scales" if int8 else "")
                         + " and int32 block_cols, row_ptr and sel")
    piece = 16 if int8 else 4
    if (Dp % bd or bd % piece or row_ptr.shape != (n_row_blocks + 1,)
            or n < 1 or slots < 1 or (int8 and scales.shape != (nb,))):
        raise ValueError(f"{symbol}: x {tuple(x.shape)}, blocks "
                         f"{tuple(blocks.shape)}, row_ptr "
                         f"{tuple(row_ptr.shape)} for {n_row_blocks} row "
                         f"blocks, {slots} slots (needs Dp % bd == 0, bd % "
                         f"{piece} == 0, n >= 1, one scale per block)")
    if x.data_ptr() % 16 or blocks.data_ptr() % 16:
        raise ValueError(f"{symbol} copies 16-byte pieces: x and blocks "
                         "must start on a 16-byte boundary")
    out = torch.empty((n, slots * bl), dtype=torch.float32, device=x.device)
    fn = _build.function("bsr_predict", symbol, _ARGTYPES[symbol])
    ptrs = [t.data_ptr() for t in (x, blocks, scales, block_cols, row_ptr,
                                   sel) if t is not None]
    dims = [n, Dp] + ([n_row_blocks * bl] if symbol == "bsr_predict_f32"
                      else []) + [n_row_blocks]
    if sel is not None:
        dims.append(slots)
    dims.append(nb)                       # the extent of the tensor maps
    tail = [INT8_GATHER_MAX_N] if symbol == "bsr_predict_int8" else []
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn, fn(*ptrs, out.data_ptr(), *dims, bl, bd, *tail,
                        x.device.index or 0, stream))
    return out


def bsr_predict_cuda(x: torch.Tensor, blocks: torch.Tensor,
                     block_cols: torch.Tensor, row_ptr: torch.Tensor,
                     n_row_blocks: int) -> torch.Tensor:
    """Launch the BSR predict kernel: x (n, Dp) f32, blocks (nb, bl, bd)
    f32, block_cols (nb,) i32, row_ptr (n_row_blocks + 1,) i32, all
    contiguous on one card -> (n, n_row_blocks * bl) f32.
    `bsr_predict_cuda.launches` counts the launches."""
    out = _launch("bsr_predict_f32", x, blocks, None, block_cols, row_ptr,
                  None, n_row_blocks, n_row_blocks)
    _build.count_launch(bsr_predict_cuda)
    return out


def bsr_predict_int8_cuda(x: torch.Tensor, blocks: torch.Tensor,
                          scales: torch.Tensor, block_cols: torch.Tensor,
                          row_ptr: torch.Tensor,
                          n_row_blocks: int) -> torch.Tensor:
    """Launch the int8 BSR predict kernel: blocks (nb, bl, bd) int8 with bd
    % 16 == 0, scales (nb,) f32, the rest as `bsr_predict_cuda`."""
    out = _launch("bsr_predict_int8", x, blocks, scales, block_cols,
                  row_ptr, None, n_row_blocks, n_row_blocks)
    _build.count_launch(bsr_predict_int8_cuda)
    return out


def bsr_predict_gather_cuda(x: torch.Tensor, blocks: torch.Tensor,
                            block_cols: torch.Tensor, row_ptr: torch.Tensor,
                            sel: torch.Tensor) -> torch.Tensor:
    """Launch the gathered BSR kernel: sel (B,) i32 row-block ids in any
    order -> (n, B * bl) f32, columns [i*bl, (i+1)*bl) for sel[i]."""
    out = _launch("bsr_gather_f32", x, blocks, None, block_cols, row_ptr,
                  sel, row_ptr.shape[0] - 1, sel.shape[0])
    _build.count_launch(bsr_predict_gather_cuda)
    return out


def bsr_predict_gather_int8_cuda(x: torch.Tensor, blocks: torch.Tensor,
                                 scales: torch.Tensor,
                                 block_cols: torch.Tensor,
                                 row_ptr: torch.Tensor,
                                 sel: torch.Tensor) -> torch.Tensor:
    """Launch the gathered int8 BSR kernel: `bsr_predict_gather_cuda` over
    int8 blocks and their scales."""
    out = _launch("bsr_gather_int8", x, blocks, scales, block_cols, row_ptr,
                  sel, row_ptr.shape[0] - 1, sel.shape[0])
    _build.count_launch(bsr_predict_gather_int8_cuda)
    return out


def bsr_predict_gather_pq_cuda(x: torch.Tensor, blocks: torch.Tensor,
                               block_cols: torch.Tensor,
                               row_ptr: torch.Tensor,
                               sel: torch.Tensor) -> torch.Tensor:
    """Launch the per-query gathered BSR kernel: sel (n, B) i32, row q's
    own row-block ids -> (n, B * bl) f32."""
    _check_pq_sel("bsr_gather_pq_f32", x, sel)
    out = _launch("bsr_gather_pq_f32", x, blocks, None, block_cols, row_ptr,
                  sel, row_ptr.shape[0] - 1, sel.shape[1])
    _build.count_launch(bsr_predict_gather_pq_cuda)
    return out


def bsr_predict_gather_pq_int8_cuda(x: torch.Tensor, blocks: torch.Tensor,
                                    scales: torch.Tensor,
                                    block_cols: torch.Tensor,
                                    row_ptr: torch.Tensor,
                                    sel: torch.Tensor) -> torch.Tensor:
    """Launch the per-query gathered int8 BSR kernel:
    `bsr_predict_gather_pq_cuda` over int8 blocks and their scales."""
    _check_pq_sel("bsr_gather_pq_int8", x, sel)
    out = _launch("bsr_gather_pq_int8", x, blocks, scales, block_cols,
                  row_ptr, sel, row_ptr.shape[0] - 1, sel.shape[1])
    _build.count_launch(bsr_predict_gather_pq_int8_cuda)
    return out


def _check_pq_sel(symbol: str, x: torch.Tensor, sel: torch.Tensor) -> None:
    if sel.dim() != 2 or sel.shape[0] != x.shape[0]:
        raise ValueError(f"{symbol} takes sel (n, B) for x "
                         f"{tuple(x.shape)}; got {tuple(sel.shape)}")


for _fn in (bsr_predict_cuda, bsr_predict_int8_cuda, bsr_predict_gather_cuda,
            bsr_predict_gather_int8_cuda, bsr_predict_gather_pq_cuda,
            bsr_predict_gather_pq_int8_cuda):
    _fn.launches = 0


def _card_x(x: torch.Tensor) -> torch.Tensor:
    x = x.float().contiguous()
    return x.clone() if x.data_ptr() % 16 else x   # a view into a buffer


def _n_row_blocks(model) -> int:
    return model.shape[0] // model.block_shape[0]


def bsr_predict_blocks(x: torch.Tensor, model: BlockSparseModel
                       ) -> torch.Tensor:
    """x (n, Dp) against the packed blocks -> (n, Lp): the kernel on the
    card, its plain version on the CPU."""
    R = _n_row_blocks(model)
    if x.device.type == "cpu":
        return ref.bsr_predict(x, model.blocks, model.block_rows,
                               model.block_cols, R)
    return bsr_predict_cuda(_card_x(x), model.blocks, model.block_cols,
                            model.row_ptr, R)


def bsr_predict_int8_blocks(x: torch.Tensor, model: Int8BlockSparseModel
                            ) -> torch.Tensor:
    R = _n_row_blocks(model)
    if x.device.type == "cpu":
        return ref.bsr_predict_int8(x, model.blocks, model.scales,
                                    model.block_rows, model.block_cols, R)
    return bsr_predict_int8_cuda(_card_x(x), model.blocks, model.scales,
                                 model.block_cols, model.row_ptr, R)


def bsr_predict_gather_blocks(x: torch.Tensor, model, sel: torch.Tensor
                              ) -> torch.Tensor:
    """x (n, Dp) against the row blocks of sel -> (n, B * bl): (B,) shared,
    or (n, B) per query; int8 when `model` is the int8 artifact."""
    int8 = isinstance(model, Int8BlockSparseModel)
    sel = sel.to(device=x.device, dtype=torch.int32).contiguous()
    if x.device.type == "cpu":
        if sel.dim() == 2 and int8:
            return ref.bsr_predict_gather_pq_int8(x, model.blocks,
                                                  model.scales,
                                                  model.block_cols,
                                                  model.row_ptr, sel)
        if sel.dim() == 2:
            return ref.bsr_predict_gather_pq(x, model.blocks,
                                             model.block_cols,
                                             model.row_ptr, sel)
        if int8:
            return ref.bsr_predict_gather_int8(x, model.blocks, model.scales,
                                               model.block_cols,
                                               model.row_ptr, sel)
        return ref.bsr_predict_gather(x, model.blocks, model.block_cols,
                                      model.row_ptr, sel)
    x = _card_x(x)
    if sel.dim() == 2 and int8:
        return bsr_predict_gather_pq_int8_cuda(x, model.blocks, model.scales,
                                               model.block_cols,
                                               model.row_ptr, sel)
    if sel.dim() == 2:
        return bsr_predict_gather_pq_cuda(x, model.blocks, model.block_cols,
                                          model.row_ptr, sel)
    if int8:
        return bsr_predict_gather_int8_cuda(x, model.blocks, model.scales,
                                            model.block_cols, model.row_ptr,
                                            sel)
    return bsr_predict_gather_cuda(x, model.blocks, model.block_cols,
                                   model.row_ptr, sel)


def _pad_features(x: torch.Tensor, model) -> torch.Tensor:
    """Pad x (n, D) to the model's padded feature width Dp; D > Dp raises
    with both dims named."""
    Dp = model.shape[1]
    D = x.shape[1]
    if D > Dp:
        raise ValueError(
            f"request feature dim {D} exceeds the model's padded feature "
            f"dim {Dp} (true feature dim {model.n_features}); bsr_predict "
            "cannot score features the model never had — slice the request "
            "or rebuild the model with the wider feature space")
    if D < Dp:
        x = F.pad(x, (0, Dp - D))
    return x


def _mask_empty_row_blocks(out: torch.Tensor, model) -> torch.Tensor:
    """Zero the label rows of row blocks with no packed block. The kernel
    already writes zeros there; this keeps the convention explicit."""
    bl = model.block_shape[0]
    counts = model.row_ptr[1:] - model.row_ptr[:-1]          # (Lp/bl,)
    row_mask = torch.repeat_interleave(counts > 0, bl)
    return torch.where(row_mask[None, :], out, 0.0)


def bsr_predict(x: torch.Tensor, model: BlockSparseModel) -> torch.Tensor:
    """Scores (n, Lp) for a batch against a block-sparse model.

    Pads x's feature dim to the padded model shape (raising when the
    request is wider than the model) and zeroes label row blocks that have
    no surviving blocks.
    """
    x = _pad_features(x.float(), model)
    return _mask_empty_row_blocks(bsr_predict_blocks(x, model), model)


def bsr_predict_int8(x: torch.Tensor, model: Int8BlockSparseModel
                     ) -> torch.Tensor:
    """Scores (n, Lp) against the int8 per-block-scaled artifact, with the
    conventions of `bsr_predict`. Within the per-block quantization bound
    (|w - scale * q| <= scale / 2) of the fp32 scores."""
    x = _pad_features(x.float(), model)
    return _mask_empty_row_blocks(bsr_predict_int8_blocks(x, model), model)


def _topk_masked(scores: torch.Tensor, k: int, n_labels: int | None):
    if n_labels is not None and n_labels < scores.shape[1]:
        scores[:, n_labels:] = NEG_INF     # in place: scores is ours
    return topk_ops.topk(scores, k)


def bsr_predict_topk(x: torch.Tensor, model: BlockSparseModel, k: int,
                     *, n_labels: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Predict -> top-k: (vals, idx) each (n, k), idx in true label ids.

    Padding label rows (id >= n_labels) are masked to NEG_INF between the
    two kernels so a block-padded model never serves phantom labels. Fully
    pruned real labels keep their exact-zero score, as on the dense path.
    """
    return _topk_masked(bsr_predict(x, model), k, n_labels)


def bsr_predict_int8_topk(x: torch.Tensor, model: Int8BlockSparseModel,
                          k: int, *, n_labels: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 predict -> top-k: the `int8` backend's entry point, with the
    masks of `bsr_predict_topk` (an all-zero block quantizes to scale 0,
    so fully pruned labels keep their exact zero)."""
    return _topk_masked(bsr_predict_int8(x, model), k, n_labels)


def max_blocks_per_row(model) -> int:
    """The most packed blocks of any row block (>= 1): the JAX kernels'
    inner grid extent, kept for API parity and accounting (the CUDA
    kernels loop over each row block's own count)."""
    ptr = to_numpy(model.row_ptr)
    return max(1, int(np.max(ptr[1:] - ptr[:-1])))


def bsr_predict_gather(x: torch.Tensor, model: BlockSparseModel,
                       sel) -> torch.Tensor:
    """Scores for only the row blocks listed in `sel` (B,) int32 (any
    order, no duplicates) -> (n, B * bl): columns [i*bl, (i+1)*bl) are row
    block sel[i]'s label scores. A selected row block with no surviving
    blocks comes back exact zero."""
    x = _pad_features(x.float(), model)
    return bsr_predict_gather_blocks(x, model, torch.as_tensor(sel))


def bsr_predict_gather_int8(x: torch.Tensor, model: Int8BlockSparseModel,
                            sel) -> torch.Tensor:
    """`bsr_predict_gather` over the int8 artifact."""
    return bsr_predict_gather(x, model, sel)


def bsr_predict_gather_pq(x: torch.Tensor, model: BlockSparseModel,
                          sel) -> torch.Tensor:
    """Per-query gathered scores: sel (n, B) int32, each row sorted, no
    duplicates -> (n, B * bl), row q's columns [i*bl, (i+1)*bl) being row
    block sel[q, i]'s label scores (a per-row layout; the top-k wrapper
    translates it per row)."""
    return bsr_predict_gather(x, model, sel)


def _gather_topk(scores: torch.Tensor, sel: torch.Tensor, bl: int, k: int,
                 n_labels: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask block padding and translate the top-k candidates back to label
    ids through the selection: (B,) shared or (n, B) per query."""
    sel = sel.to(scores.device).long()
    label_ids = (sel[..., None] * bl + torch.arange(bl, device=sel.device)
                 ).reshape(*sel.shape[:-1], -1)
    if n_labels is not None:
        scores = torch.where(label_ids < n_labels, scores, NEG_INF)
    vals, idx = topk_ops.topk(scores, k)
    if sel.dim() == 1:
        return vals, label_ids[idx.long()]
    return vals, torch.gather(label_ids, 1, idx.long())


def _pq_translate_topk(scores: torch.Tensor, sel: torch.Tensor, bl: int,
                       k: int, n_labels: int | None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-query top-k tail: padding masked per row, row q's
    candidates translated through sel[q]."""
    return _gather_topk(scores, sel, bl, k, n_labels)


def bsr_predict_gather_topk(x: torch.Tensor, model: BlockSparseModel, sel,
                            k: int, *, n_labels: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathered predict -> top-k over the shortlisted labels only: (vals,
    idx) each (n, k), idx in true label ids. With `sel` sorted and covering
    every row block this is `bsr_predict_topk`, tie order included."""
    sel = torch.as_tensor(sel)
    scores = bsr_predict_gather(x, model, sel)
    return _gather_topk(scores, sel, model.block_shape[0], k, n_labels)


def bsr_predict_gather_int8_topk(x: torch.Tensor,
                                 model: Int8BlockSparseModel, sel, k: int,
                                 *, n_labels: int | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`bsr_predict_gather_topk` over the int8 artifact."""
    return bsr_predict_gather_topk(x, model, sel, k, n_labels=n_labels)


def bsr_predict_gather_pq_topk(x: torch.Tensor, model: BlockSparseModel,
                               sel, k: int, *, n_labels: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query gathered predict -> top-k over each row's own shortlist;
    idx in true label ids."""
    sel = torch.as_tensor(sel)
    scores = bsr_predict_gather_pq(x, model, sel)
    return _pq_translate_topk(scores, sel, model.block_shape[0], k,
                              n_labels)


# The per-query forms pick the int8 kernel from the model's type.
bsr_predict_gather_pq_int8 = bsr_predict_gather_pq
bsr_predict_gather_pq_int8_topk = bsr_predict_gather_pq_topk


def model_flops(model, n: int) -> int:
    """FLOPs actually executed: 2 * n * bl * bd per surviving block."""
    bl, bd = model.block_shape
    return 2 * n * bl * bd * model.n_blocks


def _selected_block_count(model, sel) -> int:
    ptr = to_numpy(model.row_ptr)
    sel = to_numpy(sel)
    return int((ptr[sel + 1] - ptr[sel]).sum())


def gather_flops(model, n: int, sel) -> int:
    """FLOPs of the shared gathered fine stage for one batch: 2 * n * bl *
    bd per surviving block of the selected row blocks."""
    bl, bd = model.block_shape
    return 2 * n * bl * bd * _selected_block_count(model, sel)


def gather_pq_flops(model, sel) -> int:
    """FLOPs of the per-query fine stage: 2 * bl * bd per surviving block
    of each row's own selected row blocks (sel is (n, B))."""
    bl, bd = model.block_shape
    return 2 * bl * bd * _selected_block_count(model, sel)


def predict_bytes(model: BlockSparseModel, n: int) -> int:
    """Bytes the exhaustive fp32 predict moves through device memory in
    the JAX package's traffic model: every packed block once, plus x
    streamed per row block, plus the output."""
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    weights = 4 * model.n_blocks * bl * bd
    x_bytes = 4 * n * Dp * (Lp // bl)        # x re-read per row block
    out = 4 * n * Lp
    return weights + x_bytes + out


def predict_bytes_int8(model, n: int) -> int:
    """The same traffic model for the int8 artifact: 1-byte blocks and
    4-byte per-block scales; x and the fp32 output are unchanged."""
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    weights = model.n_blocks * bl * bd + 4 * model.n_blocks
    x_bytes = 4 * n * Dp * (Lp // bl)
    out = 4 * n * Lp
    return weights + x_bytes + out
