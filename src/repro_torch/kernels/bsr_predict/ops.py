"""Public wrapper: BSR prediction over a pruned DiSMEC model.

`bsr_predict` yields the (n, Lp) score matrix; `bsr_predict_topk` joins it
to the blocked top-k (kernels/topk) as the serving entry point of
`repro_torch.serve.xmc.BsrBackend`. `bsr_predict_blocks` runs the CUDA
kernel (csrc/bsr_predict.cu) on a CUDA tensor and its plain version
(ref.py) on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.pruning import BlockSparseModel
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_predict import ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk.ref import NEG_INF

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def bsr_predict_cuda(x: torch.Tensor, blocks: torch.Tensor,
                     block_cols: torch.Tensor, row_ptr: torch.Tensor,
                     n_row_blocks: int) -> torch.Tensor:
    """Launch the BSR predict kernel: x (n, Dp) f32, blocks (nb, bl, bd)
    f32, block_cols (nb,) i32, row_ptr (n_row_blocks + 1,) i32, all
    contiguous on one card -> (n, n_row_blocks * bl) f32.
    `bsr_predict_cuda.launches` counts the launches."""
    n, Dp = x.shape
    nb, bl, bd = blocks.shape
    tensors = (x, blocks, block_cols, row_ptr)
    if any(t.device != x.device or not t.is_contiguous() for t in tensors) \
            or x.device.type != "cuda":
        raise ValueError("bsr_predict_cuda takes contiguous tensors on one "
                         "CUDA device")
    if (x.dtype, blocks.dtype, block_cols.dtype, row_ptr.dtype) != (
            torch.float32, torch.float32, torch.int32, torch.int32):
        raise ValueError("bsr_predict_cuda takes float32 x and blocks, "
                         "int32 block_cols and row_ptr")
    if Dp % bd or bd % 4 or row_ptr.shape != (n_row_blocks + 1,) or n < 1:
        raise ValueError(f"bsr_predict_cuda: x {tuple(x.shape)}, blocks "
                         f"{tuple(blocks.shape)}, row_ptr "
                         f"{tuple(row_ptr.shape)} for {n_row_blocks} row "
                         "blocks (needs Dp % bd == 0, bd % 4 == 0, n >= 1)")
    if x.data_ptr() % 16 or blocks.data_ptr() % 16:
        raise ValueError("bsr_predict_cuda copies 16-byte pieces: x and "
                         "blocks must start on a 16-byte boundary")
    Lp = n_row_blocks * bl
    out = torch.empty((n, Lp), dtype=torch.float32, device=x.device)
    fn = _build.function("bsr_predict", "bsr_predict_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bsr_predict_cuda.launches += 1
    _build.check(fn, fn(x.data_ptr(), blocks.data_ptr(),
                        block_cols.data_ptr(), row_ptr.data_ptr(),
                        out.data_ptr(), n, Dp, Lp, n_row_blocks, bl, bd,
                        x.device.index or 0, stream))
    return out


bsr_predict_cuda.launches = 0


def bsr_predict_blocks(x: torch.Tensor, model: BlockSparseModel
                       ) -> torch.Tensor:
    """x (n, Dp) against the packed blocks -> (n, Lp): the kernel on the
    card, its plain version on the CPU."""
    R = model.shape[0] // model.block_shape[0]
    if x.device.type == "cpu":
        return ref.bsr_predict(x, model.blocks, model.block_rows,
                               model.block_cols, R)
    x = x.float().contiguous()
    if x.data_ptr() % 16:                  # a view into a larger buffer
        x = x.clone()
    return bsr_predict_cuda(x, model.blocks, model.block_cols, model.row_ptr,
                            R)


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


def bsr_predict_topk(x: torch.Tensor, model: BlockSparseModel, k: int,
                     *, n_labels: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Predict -> top-k: (vals, idx) each (n, k), idx in true label ids.

    Padding label rows (id >= n_labels) are masked to NEG_INF between the
    two kernels so a block-padded model never serves phantom labels. Fully
    pruned real labels keep their exact-zero score, as on the dense path.
    """
    scores = bsr_predict(x, model)
    if n_labels is not None and n_labels < scores.shape[1]:
        scores[:, n_labels:] = NEG_INF     # in place: scores is ours
    return topk_ops.topk(scores, k)


def model_flops(model: BlockSparseModel, n: int) -> int:
    """FLOPs actually executed: 2 * n * bl * bd per surviving block."""
    bl, bd = model.block_shape
    return 2 * n * bl * bd * model.n_blocks


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
