"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a card every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: BSR scores within 1e-5 of the magnitude |x| @ |W|^T of their
terms (the same fp32 products, summed in another order; both sides in
full fp32, TF32 off); top-k values and ids exactly, since the top-k only
selects.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.pruning import to_block_sparse
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import ref as topk_ref

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    return torch.device("cuda")


def _model(L, D, density, block, seed, device):
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    bl, bd = block
    keep = rng.random((-(-L // bl), -(-D // bd))) < density
    keep[0] = False                                # one empty row block
    W *= np.kron(keep, np.ones(block, np.float32))[:L, :D]
    return to_block_sparse(W, block, device=device)


def _x(n, Dp, seed, device):
    x = np.random.default_rng(seed).normal(size=(n, Dp))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _check_bsr(model, x):
    R = model.shape[0] // model.block_shape[0]
    args = (model.blocks, model.block_rows, model.block_cols, R)
    got = bsr_ops.bsr_predict_cuda(x, model.blocks, model.block_cols,
                                   model.row_ptr, R)
    want = bsr_ref.bsr_predict(x, *args)
    mag = bsr_ref.bsr_predict(x.abs(), model.blocks.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * mag).all())
    return got


@pytest.mark.parametrize("L,D,density,block", [
    (300, 520, 0.3, (16, 16)), (256, 1024, 0.2, (128, 128)),
    (500, 256, 0.5, (256, 64)), (90, 300, 0.4, (8, 32))])
@pytest.mark.parametrize("n", [1, 8, 9, 33, 64, 256])
def test_bsr_kernel_matches_plain(cuda, L, D, density, block, n):
    model = _model(L, D, density, block, seed=L + n, device=cuda)
    out = _check_bsr(model, _x(n, model.shape[1], n, cuda))
    bl = block[0]
    empty = (model.row_ptr[1:] - model.row_ptr[:-1]) == 0
    assert bool(empty[0])
    assert bool((out.reshape(n, -1, bl)[:, empty] == 0).all())


def test_bsr_kernel_sentinel_writes_zeros(cuda):
    model = to_block_sparse(np.zeros((200, 300), np.float32), (128, 128),
                            device=cuda)
    assert model.n_blocks == 1
    out = _check_bsr(model, _x(5, model.shape[1], 0, cuda))
    assert bool((out == 0).all())


@pytest.mark.parametrize("bL", [128, 256, 512, 1024])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_topk_kernel_matches_plain(cuda, bL, k):
    rng = np.random.default_rng(bL + k)
    n, L = 7, 4 * bL
    s = rng.normal(size=(n, L)).astype(np.float32)
    s[0] = 0.0                                     # all ties
    s[1] = 0.0
    s[1, 700 % L] = 1.0
    s[2] = rng.integers(0, 3, L)                   # few levels
    s[3] = -3.0e38                                 # all padding
    s = torch.tensor(s, device=cuda)
    v_k, i_k = topk_ops.blocked_topk_cuda(s, k, bL=bL)
    v_p, i_p = topk_ref.blocked_topk(s, k, bL=bL)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_p) and torch.equal(i_k, i_p)
    # The whole top-k equals the stable sort, except on the row of nothing
    # but padding, where the blocked stage (as on the TPU) repeats id 0.
    v, i = topk_ops.topk(s, k, bL=bL)
    v_r, i_r = topk_ref.topk(s, k)
    rows = [0, 1, 2, 4, 5, 6]
    assert torch.equal(i[rows], i_r[rows]) and torch.equal(v, v_r)


def test_full_path_matches_plain_and_counts_launches(cuda):
    model = _model(1000, 2000, 0.1, (128, 128), seed=3, device=cuda)
    x = _x(40, 2000, 4, cuda)
    before = (bsr_ops.bsr_predict_cuda.launches,
              topk_ops.blocked_topk_cuda.launches)
    v, i = bsr_ops.bsr_predict_topk(x, model, 5, n_labels=1000)
    after = (bsr_ops.bsr_predict_cuda.launches,
             topk_ops.blocked_topk_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)
    scores = bsr_ref.bsr_predict(bsr_ops._pad_features(x, model),
                                 model.blocks, model.block_rows,
                                 model.block_cols, model.shape[0] // 128)
    scores[:, 1000:] = topk_ref.NEG_INF
    v_r, i_r = topk_ref.topk(scores, 6)
    decisive = (v_r[:, 4] - v_r[:, 5]) > 1e-6
    assert bool(decisive.any())
    assert torch.equal(i[decisive], i_r[decisive, :5])
    assert int(i.max()) < 1000


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    model = _model(256, 256, 0.5, (128, 128), seed=1, device=cuda)
    x = _x(4, 256, 0, cuda)
    with pytest.raises(ValueError):
        bsr_ops.bsr_predict_cuda(x.double(), model.blocks,
                                 model.block_cols, model.row_ptr, 2)
    with pytest.raises(ValueError):
        bsr_ops.bsr_predict_cuda(x, model.blocks, model.block_cols.long(),
                                 model.row_ptr, 2)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(4 * 256 + 1, device=cuda)
        xs = flat[1:].view(4, 256)            # contiguous, 4 bytes past
        bsr_ops.bsr_predict_cuda(xs, model.blocks, model.block_cols,
                                 model.row_ptr, 2)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 300), device=cuda), 3,
                                   bL=128)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 512), device=cuda).t(),
                                   3, bL=256)
