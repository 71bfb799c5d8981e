"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a card every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: BSR scores within 1e-5 of the magnitude |x| @ |W|^T of their
terms (the same fp32 products, summed in another order; both sides in
full fp32, TF32 off; |W| = |q| * scale for int8 blocks); the gathered and
per-query kernels bit for bit equal to the kernel they must reproduce
(`torch.equal`); top-k values and ids exactly, since the top-k only
selects. The training kernels (hinge, HVP): f, grad and Hv within 1e-5 of
the same sums taken over absolute values (`_train_magnitudes`), for the
same reason; `act` identical wherever |z| > 1e-5; two launches on the
same inputs identical bit for bit (no atomics, fixed summation order).
"""

import copy
import time
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core.pruning import quantize_block_sparse, to_block_sparse
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref
from repro_torch.kernels.hvp import ops as hvp_ops
from repro_torch.kernels.hvp import ref as hvp_ref
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
                                   bL=1025)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 300), device=cuda), 0,
                                   bL=128)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 512), device=cuda).t(),
                                   3, bL=256)


def _int8_model(L, D, density, block, seed, device):
    return quantize_block_sparse(_model(L, D, density, block, seed, device))


def _within(got, want, mag):
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * mag).all())


INT8_CASES = [(300, 520, 0.3, (16, 16)), (256, 1024, 0.2, (128, 128)),
              (500, 256, 0.5, (256, 64)), (90, 300, 0.4, (8, 32))]


@pytest.mark.parametrize("L,D,density,block", INT8_CASES)
@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 32, 64, 65, 256])
def test_int8_kernels_match_plain(cuda, L, D, density, block, n,
                                  monkeypatch):
    """Kernels 4 and 6 against their plain versions; kernel 6 with a sorted
    full selection equals kernel 4 bit for bit (contract b); kernel 4's
    two designs (`gather_kernel` up to `INT8_GATHER_MAX_N` rows,
    `bsr_kernel` above) give the same bits at every n; the emptied row
    block 0 scores exact zeros."""
    q = _int8_model(L, D, density, block, seed=L + n, device=cuda)
    x = _x(n, q.shape[1], n, cuda)
    R = q.shape[0] // block[0]
    absq = q.blocks.abs()
    got = bsr_ops.bsr_predict_int8_cuda(x, q.blocks, q.scales, q.block_cols,
                                        q.row_ptr, R)
    _within(got, bsr_ref.bsr_predict_int8(x, q.blocks, q.scales,
                                          q.block_rows, q.block_cols, R),
            bsr_ref.bsr_predict_int8(x.abs(), absq, q.scales, q.block_rows,
                                     q.block_cols, R))
    assert bool((got[:, :block[0]] == 0).all())             # row block 0
    for switch in (0, 64):
        monkeypatch.setattr(bsr_ops, "INT8_GATHER_MAX_N", switch)
        assert torch.equal(got, bsr_ops.bsr_predict_int8_cuda(
            x, q.blocks, q.scales, q.block_cols, q.row_ptr, R))
    monkeypatch.undo()
    full = torch.arange(R, dtype=torch.int32, device=cuda)
    assert torch.equal(got, bsr_ops.bsr_predict_gather_int8_cuda(
        x, q.blocks, q.scales, q.block_cols, q.row_ptr, full))
    sel = torch.tensor([R - 1, 0, R // 2], dtype=torch.int32, device=cuda)
    g = bsr_ops.bsr_predict_gather_int8_cuda(x, q.blocks, q.scales,
                                             q.block_cols, q.row_ptr, sel)
    _within(g, bsr_ref.bsr_predict_gather_int8(x, q.blocks, q.scales,
                                               q.block_cols, q.row_ptr, sel),
            bsr_ref.bsr_predict_gather_int8(x.abs(), absq, q.scales,
                                            q.block_cols, q.row_ptr, sel))
    assert bool((g[:, block[0]:2 * block[0]] == 0).all())   # row block 0


@pytest.mark.parametrize("L,D,density,block", [
    (300, 520, 0.3, (16, 16)), (256, 1024, 0.2, (128, 128)),
    (500, 256, 0.5, (256, 64)), (90, 300, 0.4, (8, 32))])
@pytest.mark.parametrize("n", [1, 9, 33, 64])
def test_gather_kernels_match_plain(cuda, L, D, density, block, n):
    """Kernel 5 against its plain version (unsorted selection, an empty
    row block) and against kernel 3 at a sorted full selection (contract
    a); kernel 7 against its plain version, and at n = 1 against kernel 5
    (contract c)."""
    model = _model(L, D, density, block, seed=L * n, device=cuda)
    x = _x(n, model.shape[1], n + 1, cuda)
    bl, R = block[0], model.shape[0] // block[0]
    args = (model.blocks, model.block_cols, model.row_ptr)
    absargs = (model.blocks.abs(), model.block_cols, model.row_ptr)
    full = torch.arange(R, dtype=torch.int32, device=cuda)
    assert torch.equal(bsr_ops.bsr_predict_gather_cuda(x, *args, full),
                       bsr_ops.bsr_predict_cuda(x, *args, R))
    sel = torch.tensor([R - 1, 0, R // 2], dtype=torch.int32, device=cuda)
    g = bsr_ops.bsr_predict_gather_cuda(x, *args, sel)
    _within(g, bsr_ref.bsr_predict_gather(x, *args, sel),
            bsr_ref.bsr_predict_gather(x.abs(), *absargs, sel))
    assert bool((g[:, bl:2 * bl] == 0).all())     # row block 0 is empty
    gen = torch.Generator(device="cpu").manual_seed(n)
    B = max(1, R // 2)
    sel_pq = torch.sort(torch.stack([torch.randperm(R, generator=gen)[:B]
                                     for _ in range(n)]), dim=1)[0]
    sel_pq = sel_pq.to(device=cuda, dtype=torch.int32).contiguous()
    pq = bsr_ops.bsr_predict_gather_pq_cuda(x, *args, sel_pq)
    _within(pq, bsr_ref.bsr_predict_gather_pq(x, *args, sel_pq),
            bsr_ref.bsr_predict_gather_pq(x.abs(), *absargs, sel_pq))
    for q in range(min(n, 3)):
        one = bsr_ops.bsr_predict_gather_pq_cuda(x[q:q + 1].contiguous(),
                                                 *args, sel_pq[q:q + 1])
        assert torch.equal(one, bsr_ops.bsr_predict_gather_cuda(
            x[q:q + 1].contiguous(), *args, sel_pq[q].contiguous()))


# (L, D, block): bl of 8, 48 and 256 against the gathered kernels' label
# tile of 32; bd of 16 and 32; at D = 4,800 and bd = 16 a row block of 300
# blocks, more than the 256 whose columns one pass stages.
GATHER_EDGES = [(90, 300, (8, 32)), (300, 520, (48, 16)),
                (600, 512, (256, 32)), (384, 4800, (128, 16))]


@pytest.mark.parametrize("L,D,block", GATHER_EDGES)
@pytest.mark.parametrize("n", [1, 8, 9, 32, 33, 64, 65])
def test_gather_kernels_at_tile_edges(cuda, L, D, block, n):
    """Kernels 5 and 6 at the edges of their tiles, ring and passes: row
    block 0 emptied, 1 with exactly one packed block, 2 with every column
    block (more stages than the ring holds). Against their plain versions;
    B = R bit for bit equal to kernels 3 and 4 (contracts a, b); B = 1
    equal to its slot of a longer selection; ids outside [0, R) and the
    emptied row block exact zeros, the other slots unchanged by them."""
    bl, bd = block
    rng = np.random.default_rng(L + D + n)
    rb, cb = -(-L // bl), -(-D // bd)
    keep = rng.random((rb, cb)) < 0.3
    keep[0] = keep[1] = False
    keep[1, cb // 2] = keep[2] = True
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    W *= np.kron(keep, np.ones(block, np.float32))[:L, :D]
    model = to_block_sparse(W, block, device=cuda)
    q = quantize_block_sparse(model)
    R = model.shape[0] // bl
    counts = (model.row_ptr[1:] - model.row_ptr[:-1]).tolist()
    assert counts[:3] == [0, 1, cb]
    x = _x(n, model.shape[1], n, cuda)
    fp = (model.blocks, model.block_cols, model.row_ptr)
    i8 = (q.blocks, q.scales, q.block_cols, q.row_ptr)
    full = torch.arange(R, dtype=torch.int32, device=cuda)
    assert torch.equal(bsr_ops.bsr_predict_gather_cuda(x, *fp, full),
                       bsr_ops.bsr_predict_cuda(x, *fp, R))
    assert torch.equal(bsr_ops.bsr_predict_gather_int8_cuda(x, *i8, full),
                       bsr_ops.bsr_predict_int8_cuda(x, *i8, R))
    sel = torch.tensor([R - 1, 2, 1, 0], dtype=torch.int32, device=cuda)
    mixed = torch.tensor([R - 1, 2, -1, 1, 0, R], dtype=torch.int32,
                         device=cuda)
    for kernel, plain, args in (
            (bsr_ops.bsr_predict_gather_cuda, bsr_ref.bsr_predict_gather,
             fp),
            (bsr_ops.bsr_predict_gather_int8_cuda,
             bsr_ref.bsr_predict_gather_int8, i8)):
        absargs = (args[0].abs(),) + args[1:]
        g = kernel(x, *args, sel)
        _within(g, plain(x, *args, sel), plain(x.abs(), *absargs, sel))
        assert torch.equal(kernel(x, *args, sel[1:2]), g[:, bl:2 * bl])
        m = kernel(x, *args, mixed).reshape(n, 6, bl)
        torch.cuda.synchronize()
        assert torch.equal(m[:, [0, 1, 3]], g.reshape(n, 4, bl)[:, :3])
        assert bool((m[:, [2, 4, 5]] == 0).all())


def test_gathered_kernels_repeat_bit_for_bit(cuda):
    """Kernels 5, 6, 7 and 8 (which share their source): 100 launches on
    one input, then pairs of launches on two streams at once, each equal to
    the first bit for bit (no atomics, a fixed order: a race would show).
    The per-query kernels also at a skewed selection of n = 256 rows, each
    row's own permutation with row block 7 first (four chunks of it)."""
    model = _model(1000, 4096, 0.3, (128, 128), seed=5, device=cuda)
    q = quantize_block_sparse(model)
    fp = (model.blocks, model.block_cols, model.row_ptr)
    i8 = (q.blocks, q.scales, q.block_cols, q.row_ptr)
    sel = torch.tensor([7, 0, 3, 5, 1], dtype=torch.int32, device=cuda)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n in (1, 32, 65, 256):
        x = _x(n, model.shape[1], n, cuda)
        sel_pq = sel.repeat(n, 1).contiguous()
        if n == 256:
            sel_pq = torch.stack([torch.randperm(8, generator=gen)[:5]
                                  for _ in range(n)])
            sel_pq[:, 0] = 7
            sel_pq = sel_pq.to(device=cuda, dtype=torch.int32).contiguous()
        for fn in (
                lambda: bsr_ops.bsr_predict_gather_cuda(x, *fp, sel),
                lambda: bsr_ops.bsr_predict_gather_int8_cuda(x, *i8, sel),
                lambda: bsr_ops.bsr_predict_gather_pq_cuda(x, *fp, sel_pq),
                lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(x, *i8,
                                                                sel_pq)):
            first = fn()
            outs = [fn() for _ in range(100)]
            torch.cuda.synchronize()
            for _ in range(10):
                with torch.cuda.stream(s1):
                    outs.append(fn())
                with torch.cuda.stream(s2):
                    outs.append(fn())
            torch.cuda.synchronize()
            assert all(torch.equal(o, first) for o in outs)


# (L, D, block) for kernel 3: bl of 8, 48, 128 and 256 against the label
# tiles of 64 and 128; bd of 16 (a stage of 32 features past the block),
# 36 (a last stage of 4 features) and 128; L and D not multiples of them;
# at D = 4,800 and bd = 16 a row block of 300 blocks.
EX_EDGES = [(90, 300, (8, 32)), (300, 520, (48, 16)),
            (1000, 1100, (128, 128)), (600, 520, (256, 36)),
            (384, 4800, (128, 16))]


@pytest.mark.parametrize("L,D,block", EX_EDGES)
@pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 17, 33, 63, 64, 65, 255, 256,
                               300])
def test_exhaustive_kernel_at_tile_edges(cuda, L, D, block, n):
    """Kernel 3 at the edges of its tiles and row tiles, on a model whose
    row block 0 is empty, 1 holds one block and 2 every column block:
    within tolerance of its plain version; the empty row block exact
    zeros; a sorted full selection through kernel 5 bit for bit equal
    (contract a)."""
    model = _edge_model(L, D, block, seed=L + D + n, device=cuda)
    bl = block[0]
    R = model.shape[0] // bl
    fp = (model.blocks, model.block_cols, model.row_ptr)
    x = _x(n, model.shape[1], n, cuda)
    got = _check_bsr(model, x)
    assert bool((got.reshape(n, R, bl)[:, 0] == 0).all())
    full = torch.arange(R, dtype=torch.int32, device=cuda)
    assert torch.equal(bsr_ops.bsr_predict_gather_cuda(x, *fp, full), got)


def test_exhaustive_kernel_on_the_sentinel_and_skewed_rows(cuda):
    """Kernel 3 on the fully pruned sentinel (row_ptr all
    zeros): exact zeros; and on a power-law model, one row block holding
    most of the blocks and half of them none, within tolerance."""
    zero = to_block_sparse(np.zeros((200, 300), np.float32), (128, 128),
                           device=cuda)
    rng = np.random.default_rng(4)
    L, D, bl, bd = 1280, 2048, 128, 128
    keep = np.zeros((L // bl, D // bd), bool)
    keep[3] = True
    for r in range(5, L // bl):
        keep[r, rng.choice(D // bd, 1 + 8 // r, replace=False)] = True
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    W *= np.kron(keep, np.ones((bl, bd), np.float32))
    skewed = to_block_sparse(W, (bl, bd), device=cuda)
    for n in (1, 8, 32, 100):
        out = _check_bsr(zero, _x(n, zero.shape[1], n, cuda))
        assert bool((out == 0).all())
        _check_bsr(skewed, _x(n, D, n, cuda))


def test_exhaustive_kernel_repeats_bit_for_bit(cuda):
    """Kernel 3: 50 launches on one input, then 10 pairs
    of launches on two streams at once, each equal to the first bit for
    bit (no atomics, a fixed order: a race would show)."""
    model = _edge_model(1000, 4096, (128, 128), seed=9, device=cuda)
    R = model.shape[0] // 128
    fp = (model.blocks, model.block_cols, model.row_ptr)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for n in (1, 8, 32, 64, 256):
        x = _x(n, model.shape[1], n, cuda)
        first = bsr_ops.bsr_predict_cuda(x, *fp, R)
        outs = [bsr_ops.bsr_predict_cuda(x, *fp, R) for _ in range(50)]
        torch.cuda.synchronize()
        for _ in range(10):
            with torch.cuda.stream(s1):
                outs.append(bsr_ops.bsr_predict_cuda(x, *fp, R))
            with torch.cuda.stream(s2):
                outs.append(bsr_ops.bsr_predict_cuda(x, *fp, R))
        torch.cuda.synchronize()
        assert all(torch.equal(o, first) for o in outs)


def _topk_rows(L: int, seed: int) -> np.ndarray:
    """Rows where the round rule decides: all ties (0.0 and -0.0), all
    NEG_INF, all -inf, -inf at every other id, few levels, the maximum in
    the last (short) block, a +inf entry, and plain normal scores."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(8, L)).astype(np.float32)
    s[0] = 0.0
    s[0, 1::3] = -0.0
    s[1] = topk_ref.NEG_INF
    s[2] = -np.inf
    s[3, ::2] = -np.inf
    s[4] = rng.integers(0, 3, L)
    s[5, -1] = 5.0
    s[6, L // 3] = np.inf
    return s


def _padded(s: torch.Tensor, bL: int) -> torch.Tensor:
    return torch.nn.functional.pad(s, (0, (-s.shape[1]) % bL),
                                   value=topk_ref.NEG_INF).contiguous()


@pytest.mark.parametrize("bL", [128, 200, 256, 512, 1000, 1024])
@pytest.mark.parametrize("k", [1, 5, 8, 16])
def test_topk_kernel_reads_unpadded_scores(cuda, bL, k):
    """Kernel 9 on the unpadded (n, L), L not a multiple of bL: a last
    block with fewer than k real entries (or 1), a last block of 36, and a
    view 4 bytes off a 16-byte boundary (one float a slot): the strip
    equals the kernel's on the input padded with NEG_INF and the plain
    version's on it; the whole top-k equals the CPU path's (which pads)."""
    for L in (3 * bL + max(1, k - 1), 2 * bL + 36):
        s = torch.tensor(_topk_rows(L, bL + k + L), device=cuda)
        flat = torch.empty(s.numel() + 1, device=cuda)
        view = flat[1:].view(s.shape)
        view.copy_(s)
        pad = _padded(s, bL)
        v_p, i_p = topk_ops.blocked_topk_cuda(pad, k, bL=bL)
        v_r, i_r = topk_ref.blocked_topk(pad, k, bL=bL)
        torch.cuda.synchronize()
        assert torch.equal(v_p, v_r) and torch.equal(i_p, i_r)
        for scores in (s, view):
            v_k, i_k = topk_ops.blocked_topk_cuda(scores, k, bL=bL)
            torch.cuda.synchronize()
            assert torch.equal(v_k, v_r) and torch.equal(i_k, i_r)
        v, i = topk_ops.topk(s, k, bL=bL)
        v_c, i_c = topk_ops.topk(s.cpu(), k, bL=bL)
        assert torch.equal(v.cpu(), v_c) and torch.equal(i.cpu(), i_c)


def test_topk_kernel_at_the_main_path_shapes(cuda):
    """Kernel 9 at the serving width (n, 30,976), n = 1 and 256, and the LM
    vocabulary (2, 32,001), k = 5, bL = 512, against the plain version on
    the padded input; and 70,000 rows, more than a grid's second
    dimension holds."""
    rng = np.random.default_rng(0)
    for n, L, bL in ((1, 30_976, 512), (256, 30_976, 512), (2, 32_001, 512),
                     (70_000, 300, 128)):
        s = torch.tensor(rng.normal(size=(n, L)).astype(np.float32),
                         device=cuda)
        s[:, :64] = 0.25                              # ties
        v_k, i_k = topk_ops.blocked_topk_cuda(s, 5, bL=bL)
        v_r, i_r = topk_ref.blocked_topk(_padded(s, bL), 5, bL=bL)
        torch.cuda.synchronize()
        assert torch.equal(v_k, v_r) and torch.equal(i_k, i_r)


def test_topk_on_the_card_pads_nothing(cuda):
    """`topk` on a CUDA tensor launches the kernel on the unpadded scores:
    no F.pad, one launch, and the CPU path's answer."""
    s = torch.tensor(_topk_rows(1000, 1), device=cuda)
    before = topk_ops.blocked_topk_cuda.launches
    with mock.patch.object(topk_ops.F, "pad",
                           side_effect=AssertionError("F.pad on the card")):
        v, i = topk_ops.topk(s, 5)
    assert topk_ops.blocked_topk_cuda.launches == before + 1
    v_c, i_c = topk_ops.topk(s.cpu(), 5)
    assert torch.equal(v.cpu(), v_c) and torch.equal(i.cpu(), i_c)


# (L, D, block): bl of 8, 48, 128 and 256 against the per-query kernel's
# label tiles of 32 and 64; bd of 16, 32 and 128; at D = 4,800 and bd = 16
# a row block of 300 blocks, two passes of staged columns.
PQ_EDGES = [(90, 300, (8, 32)), (300, 520, (48, 16)), (600, 512, (256, 32)),
            (384, 4800, (128, 16)), (500, 1024, (128, 128))]


def _edge_model(L, D, block, seed, device):
    """Row block 0 emptied, 1 with exactly one packed block, 2 with every
    column block, the rest at density 0.3."""
    bl, bd = block
    rng = np.random.default_rng(seed)
    rb, cb = -(-L // bl), -(-D // bd)
    keep = rng.random((rb, cb)) < 0.3
    keep[0] = keep[1] = False
    keep[1, cb // 2] = keep[2] = True
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    W *= np.kron(keep, np.ones(block, np.float32))[:L, :D]
    model = to_block_sparse(W, block, device=device)
    counts = (model.row_ptr[1:] - model.row_ptr[:-1]).tolist()
    assert counts[:3] == [0, 1, cb]
    return model


def _pq_selections(n, R, seed, device):
    """Per-query selections at the kernel's edges: B = 5 (at most R + 2)
    drawn with repeats from [-1, R], unsorted, with row block 2 (every
    column block) chosen by every query and the empty row block 0 by row
    0; B = 1; B = R, each row its own permutation."""
    rng = np.random.default_rng(seed)
    B = min(5, R + 2)
    mixed = rng.integers(-1, R + 1, size=(n, B))
    mixed[:, 0] = 2
    mixed[0, -1] = 0
    one = rng.integers(0, R, size=(n, 1))
    perm = np.stack([rng.permutation(R) for _ in range(n)])
    return [torch.tensor(s, dtype=torch.int32, device=device)
            for s in (mixed, one, perm)]


@pytest.mark.parametrize("L,D,block", PQ_EDGES)
@pytest.mark.parametrize("n", [1, 8, 9, 63, 64, 65, 256, 300])
def test_pq_kernels_at_tile_edges(cuda, L, D, block, n):
    """Kernels 7 and 8 (`pq_kernel`) at the edges of their chunks, label
    tiles, ring and passes, at unsorted selections with repeated ids and
    ids outside [0, R): against their plain versions on the ids inside,
    exact zeros on the others, no element left unwritten (the output's
    memory is filled with NaN just before); bit for bit equal to the
    shared kernels 5 and 6 run on one row (contracts c, d) and, at B = R,
    to the exhaustive kernels 3 and 4 in each row's order (contract e)."""
    bl = block[0]
    model = _edge_model(L, D, block, L + D + n, cuda)
    q = quantize_block_sparse(model)
    R = model.shape[0] // bl
    x = _x(n, model.shape[1], n, cuda)
    fp = (model.blocks, model.block_cols, model.row_ptr)
    i8 = (q.blocks, q.scales, q.block_cols, q.row_ptr)
    exhaustive = (bsr_ops.bsr_predict_cuda(x, *fp, R),
                  bsr_ops.bsr_predict_int8_cuda(x, *i8, R))
    for s_i, sel in enumerate(_pq_selections(n, R, L + n, cuda)):
        B = sel.shape[1]
        inside = (sel >= 0) & (sel < R)
        clamped = sel.clamp(0, R - 1).contiguous()
        for kernel, shared, plain, args, exh in (
                (bsr_ops.bsr_predict_gather_pq_cuda,
                 bsr_ops.bsr_predict_gather_cuda,
                 bsr_ref.bsr_predict_gather_pq, fp, exhaustive[0]),
                (bsr_ops.bsr_predict_gather_pq_int8_cuda,
                 bsr_ops.bsr_predict_gather_int8_cuda,
                 bsr_ref.bsr_predict_gather_pq_int8, i8, exhaustive[1])):
            # Freed at once: the caching allocator gives this block of the
            # same size to the kernel's output next.
            torch.full((n, B * bl), float("nan"), device=cuda)
            got = kernel(x, *args, sel)
            assert not bool(got.isnan().any()), (s_i, kernel.__name__)
            absargs = (args[0].abs(),) + args[1:]
            want = plain(x, *args, clamped).reshape(n, B, bl)
            mag = plain(x.abs(), *absargs, clamped).reshape(n, B, bl)
            g3 = got.reshape(n, B, bl)
            _within(g3[inside], want[inside], mag[inside])
            assert bool((g3[~inside] == 0).all())
            assert bool((g3[sel == 0] == 0).all())   # the empty row block
            for r in sorted({0, n // 2, n - 1}):
                assert torch.equal(got[r], shared(
                    x[r:r + 1].contiguous(), *args,
                    sel[r].contiguous())[0]), (s_i, r)
            if B == R:
                e3 = exh.reshape(n, R, bl)
                rows = torch.arange(n, device=cuda)[:, None]
                assert torch.equal(g3, e3[rows, sel.long()])


@pytest.mark.parametrize("L,D,density,block", [
    (300, 520, 0.3, (16, 16)), (256, 1024, 0.2, (128, 128)),
    (500, 256, 0.5, (256, 64)), (90, 300, 0.4, (8, 32))])
@pytest.mark.parametrize("n", [1, 9, 33, 64])
def test_gather_pq_int8_kernel_matches_plain(cuda, L, D, density, block, n):
    """Kernel 8 against its plain version (per-row selections holding the
    empty row block 0); at n = 1 against kernel 6 and, where a row's list
    is every row block, against kernel 4, bit for bit."""
    q = _int8_model(L, D, density, block, seed=L * n + 1, device=cuda)
    x = _x(n, q.shape[1], n + 2, cuda)
    R = q.shape[0] // block[0]
    args = (q.blocks, q.scales, q.block_cols, q.row_ptr)
    absargs = (q.blocks.abs(), q.scales, q.block_cols, q.row_ptr)
    gen = torch.Generator(device="cpu").manual_seed(n + 7)
    B = max(1, R // 2)
    sel = torch.sort(torch.stack([torch.randperm(R, generator=gen)[:B]
                                  for _ in range(n)]), dim=1)[0]
    sel[0, 0] = 0                                  # the empty row block
    sel = torch.sort(sel, dim=1)[0]
    sel = sel.to(device=cuda, dtype=torch.int32).contiguous()
    got = bsr_ops.bsr_predict_gather_pq_int8_cuda(x, *args, sel)
    _within(got, bsr_ref.bsr_predict_gather_pq_int8(x, *args, sel),
            bsr_ref.bsr_predict_gather_pq_int8(x.abs(), *absargs, sel))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    bl = block[0]
    for i in range(B):                             # row 0's empty slot
        if int(sel[0, i]) == 0:
            assert bool((got[0, i * bl:(i + 1) * bl] == 0).all())
    for r in range(min(n, 3)):
        xr = x[r:r + 1].contiguous()
        assert torch.equal(
            bsr_ops.bsr_predict_gather_pq_int8_cuda(xr, *args,
                                                    sel[r:r + 1]),
            bsr_ops.bsr_predict_gather_int8_cuda(xr, *args,
                                                 sel[r].contiguous()))
    full = torch.arange(R, dtype=torch.int32, device=cuda)
    assert torch.equal(
        bsr_ops.bsr_predict_gather_pq_int8_cuda(
            x, *args, full.repeat(n, 1).contiguous()),
        bsr_ops.bsr_predict_int8_cuda(x, q.blocks, q.scales, q.block_cols,
                                      q.row_ptr, R))


def test_gather_pq_int8_kernel_writes_zeros(cuda):
    """The sentinel model, an empty selected row block and an id outside
    [0, R) all score exact zeros in kernel 8."""
    sentinel = quantize_block_sparse(to_block_sparse(
        np.zeros((200, 320), np.float32), (128, 128), device=cuda))
    x = _x(5, sentinel.shape[1], 0, cuda)
    sel = torch.tensor([[0, 1]] * 5, dtype=torch.int32, device=cuda)
    out = bsr_ops.bsr_predict_gather_pq_int8_cuda(
        x, sentinel.blocks, sentinel.scales, sentinel.block_cols,
        sentinel.row_ptr, sel)
    torch.cuda.synchronize()
    assert out.shape == (5, 256) and bool((out == 0).all())
    q = _int8_model(256, 512, 0.5, (64, 128), seed=3, device=cuda)
    x = _x(3, q.shape[1], 1, cuda)
    sel = torch.tensor([[0, 2], [1, 4], [0, -1]], dtype=torch.int32,
                       device=cuda)
    out = bsr_ops.bsr_predict_gather_pq_int8_cuda(
        x, q.blocks, q.scales, q.block_cols, q.row_ptr, sel)
    torch.cuda.synchronize()
    assert bool((out[0, :64] == 0).all())          # row block 0 is empty
    assert bool((out[2] == 0).all())               # empty, then out of range
    assert bool((out[1, 64:] == 0).all())          # id 4 >= R = 4


def test_gather_kernels_on_the_sentinel_write_zeros(cuda):
    model = to_block_sparse(np.zeros((200, 300), np.float32), (128, 128),
                            device=cuda)
    q = quantize_block_sparse(model)
    x = _x(5, model.shape[1], 0, cuda)
    sel = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    args = (model.block_cols, model.row_ptr)
    for out in (bsr_ops.bsr_predict_gather_cuda(x, model.blocks, *args, sel),
                bsr_ops.bsr_predict_int8_cuda(x, q.blocks, q.scales, *args,
                                              2),
                bsr_ops.bsr_predict_gather_int8_cuda(x, q.blocks, q.scales,
                                                     *args, sel),
                bsr_ops.bsr_predict_gather_pq_cuda(
                    x, model.blocks, *args,
                    sel.repeat(5, 1).contiguous())):
        torch.cuda.synchronize()
        assert bool((out == 0).all())


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    model = _model(256, 256, 0.5, (128, 128), seed=1, device=cuda)
    q = quantize_block_sparse(model)
    x = _x(4, 256, 0, cuda)
    sel = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    cases = [
        lambda: bsr_ops.bsr_predict_int8_cuda(x, q.blocks.float(), q.scales,
                                              q.block_cols, q.row_ptr, 2),
        lambda: bsr_ops.bsr_predict_int8_cuda(x, q.blocks, q.scales[:-1],
                                              q.block_cols, q.row_ptr, 2),
        lambda: bsr_ops.bsr_predict_gather_cuda(x, model.blocks,
                                                model.block_cols,
                                                model.row_ptr, sel.long()),
        lambda: bsr_ops.bsr_predict_gather_int8_cuda(
            x, q.blocks, q.scales, q.block_cols, q.row_ptr, sel.cpu()),
        lambda: bsr_ops.bsr_predict_gather_pq_cuda(
            x, model.blocks, model.block_cols, model.row_ptr, sel),
        lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(
            x, q.blocks, q.scales, q.block_cols, q.row_ptr, sel),
        lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(
            x, model.blocks, q.scales, q.block_cols, q.row_ptr,
            sel.repeat(4, 1).contiguous()),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()
    small = _model(64, 64, 1.0, (16, 8), seed=2, device=cuda)   # bd = 8
    sq = quantize_block_sparse(small)
    with pytest.raises(ValueError, match="% 16"):
        bsr_ops.bsr_predict_int8_cuda(_x(2, 64, 0, cuda), sq.blocks,
                                      sq.scales, sq.block_cols, sq.row_ptr,
                                      4)


@pytest.mark.parametrize("spec", [
    dict(backend="int8"), dict(backend="bsr", int8=True),
    dict(backend="shortlist", shortlist_blocks=3),
    dict(backend="shortlist", shortlist_blocks=3, int8=True),
    dict(backend="shortlist", shortlist_blocks=3, shortlist_per_query=True),
    dict(backend="shortlist", shortlist_blocks=3, shortlist_per_query=True,
         int8=True)])
def test_shortlist_and_int8_engines_count_launches(cuda, tmp_path, spec):
    """Each engine launches its kernel, and serves the plain path's ids on
    every decisive row."""
    from repro_torch.checkpoint.io import save_block_sparse
    from repro_torch.specs import ServeSpec
    from repro_torch.xmc_api import CheckpointHandle
    model = _model(1000, 2000, 0.2, (128, 128), seed=5, device="cpu")
    save_block_sparse(model, str(tmp_path), meta={"n_labels": 1000,
                                                  "n_features": 2000})
    fns = {"int8": bsr_ops.bsr_predict_int8_cuda,
           "gather": bsr_ops.bsr_predict_gather_cuda,
           "gather_int8": bsr_ops.bsr_predict_gather_int8_cuda,
           "gather_pq": bsr_ops.bsr_predict_gather_pq_cuda,
           "gather_pq_int8": bsr_ops.bsr_predict_gather_pq_int8_cuda}
    gather = "gather_pq" if spec.get("shortlist_per_query") else "gather"
    want = ((gather + "_int8" if spec.get("int8") else gather)
            if spec["backend"] == "shortlist" else "int8")
    before = {k: f.launches for k, f in fns.items()}
    engine = CheckpointHandle.open(str(tmp_path)).engine(
        ServeSpec(k=5, buckets=(1, 8, 64), warmup=False, **spec))
    x = _x(40, 2000, 9, "cpu").numpy()
    got = engine.serve([x[:1], x[1:40]])
    assert fns[want].launches > before[want]
    assert all(fns[k].launches == before[k] for k in fns if k != want)
    ids = np.concatenate([r.labels for r in got])
    cpu = CheckpointHandle.open(str(tmp_path), device="cpu").engine(
        ServeSpec(k=6, buckets=(1, 8, 64), warmup=False, **spec))
    ref = cpu.serve([x[:1], x[1:40]])
    v_r = np.concatenate([r.scores for r in ref])
    i_r = np.concatenate([r.labels for r in ref])
    rows = (v_r[:, 4] - v_r[:, 5]) > 1e-5
    assert rows.sum() > 20
    np.testing.assert_array_equal(ids[rows], i_r[rows, :5])


@pytest.mark.parametrize("spec", [
    dict(backend="bsr"),
    dict(backend="shortlist", shortlist_blocks=3, shortlist_per_query=True),
    dict(backend="shortlist", shortlist_blocks=3, shortlist_per_query=True,
         int8=True)])
def test_server_on_the_card_matches_step(cuda, tmp_path, spec):
    """An `XMCServer` on the card, its threads running and its batches
    formed by arrival time, answers with the ids and scores of
    `engine.step()`: each of these backends scores a row the same way
    whatever rows share its micro-batch."""
    from repro_torch.checkpoint.io import save_block_sparse
    from repro_torch.specs import ServeSpec
    from repro_torch.xmc_api import CheckpointHandle
    model = _model(1000, 2000, 0.2, (128, 128), seed=6, device="cpu")
    save_block_sparse(model, str(tmp_path), meta={"n_labels": 1000,
                                                  "n_features": 2000})
    handle = CheckpointHandle.open(str(tmp_path))
    serve = ServeSpec(k=5, buckets=(1, 4, 16), warmup=False,
                      max_batch_delay_ms=1.0, **spec)
    rng = np.random.default_rng(8)
    x = _x(60, 2000, 10, "cpu").numpy()
    reqs, off = [], 0
    while off < len(x):
        n = int(rng.integers(1, 6))
        reqs.append(x[off:off + n])
        off += n
    sync = handle.engine(serve).serve(reqs)
    server = handle.server(serve)
    futures = []
    for r in reqs:
        futures.append(server.submit(r))
        time.sleep(float(rng.exponential(5e-4)))
    server.stop()
    assert server.counters["batches"] > 1
    for s, f in zip(sync, futures):
        a = f.result(timeout=0)
        np.testing.assert_array_equal(a.labels, s.labels)
        np.testing.assert_array_equal(a.scores, s.scores)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_to_device_in_pieces_is_the_plain_copy(cuda, monkeypatch, dtype):
    """A host tensor past `COPY_CHUNK_BYTES` reaches the card in pieces,
    the last one short, with the bytes and shape of `t.to("cuda")`."""
    import repro_torch.device as device_mod
    monkeypatch.setattr(device_mod, "COPY_CHUNK_BYTES", 1000)
    t = torch.from_numpy(np.random.default_rng(3).normal(
        size=(37, 11, 13)).astype(np.float32) * 50).to(dtype)
    got = device_mod.to_device(t, "cuda")
    assert got.shape == t.shape and got.dtype == dtype
    assert torch.equal(got.cpu(), t)


def test_refresh_from_on_the_card_serves_the_new_model(cuda, tmp_path):
    """`XMCServer.refresh_from` loads the new model while the server
    answers; after it returns, answers are the new model's, equal to its
    own `engine.step()`."""
    from repro_torch.checkpoint.io import save_block_sparse
    from repro_torch.specs import ServeSpec
    from repro_torch.xmc_api import CheckpointHandle
    dirs = []
    for seed in (6, 7):
        d = tmp_path / f"m{seed}"
        save_block_sparse(_model(1000, 2000, 0.2, (128, 128), seed=seed,
                                 device="cpu"), str(d),
                          meta={"n_labels": 1000, "n_features": 2000})
        dirs.append(str(d))
    serve = ServeSpec(backend="bsr", k=5, buckets=(1, 4, 16), warmup=False,
                      max_batch_delay_ms=1.0)
    x = _x(12, 2000, 11, "cpu").numpy()
    reqs = [x[i:i + 3] for i in range(0, 12, 3)]
    server = CheckpointHandle.open(dirs[0]).server(serve)
    before = [server.submit(r) for r in reqs]
    handle, prev = server.refresh_from(dirs[1], serve_override=serve)
    after = [server.submit(r) for r in reqs]
    server.stop()
    assert prev is server.previous_engine and handle.directory == dirs[1]
    want = handle.engine(serve).serve(reqs)
    for w, f in zip(want, after):
        np.testing.assert_array_equal(f.result(0).labels, w.labels)
        np.testing.assert_array_equal(f.result(0).scores, w.scores)
    assert all(f.result(0).labels.shape == (3, 5) for f in before)


def _train_inputs(L, N, D, seed, device, w_scale=1.0):
    """Sparse unit-norm rows X, signs S with few positives, weights W and
    directions V, all float32 on `device`."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * (rng.random((N, D)) < 0.05)
    X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-8
    S = np.where(rng.random((L, N)) < 0.1, 1.0, -1.0)
    W = w_scale * rng.normal(size=(L, D))
    V = rng.normal(size=(L, D))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (W, X, S, V)]


def _train_magnitudes(W, X, S, act, C):
    """Per element, the sums over absolute values of the terms the kernels
    add: |z| and the score error scale m = |W| |X|^T for f; 2|W| +
    2C (act * (m + |S|)) |X| for grad."""
    m = W.abs() @ X.abs().T
    z = 1.0 - S * (W @ X.T)
    f_mag = (W * W).sum(-1) + C * (act * (z.abs() + m) ** 2).sum(-1)
    g_mag = 2.0 * W.abs() + 2.0 * C * ((act * (m + S.abs())) @ X.abs())
    return f_mag, g_mag, z


# Training-kernel shapes: the general ones first, then the alignment
# edges: D = 1, 2, 3 (mod 4) (X's rows 4- or 8-byte aligned, copied by the
# wrappers into 16-byte-aligned rows), D = 0 (mod 4) (read in place), odd
# N, L of 1, 63, 65 and 129 around the 64-row warpgroup and 128-row tile
# edges.
TRAIN_SHAPES = [
    (1, 1, 1), (1, 5, 300), (130, 1, 257), (129, 131, 1000),
    (300, 257, 4099), (128, 128, 128), (7, 300, 33), (200, 600, 9000),
    (63, 77, 4097), (65, 129, 4098), (1, 333, 2050), (129, 255, 515),
    (65, 1, 6), (63, 130, 4100)]


@pytest.mark.parametrize("L,N,D", TRAIN_SHAPES)
@pytest.mark.parametrize("w_scale", [0.0, 1.0])
def test_hinge_kernel_matches_plain(cuda, L, N, D, w_scale):
    """Also: X as a row-strided view with 16-byte-aligned rows (read by
    TMA) gives the same bits as X contiguous."""
    C = 0.7
    W, X, S, _ = _train_inputs(L, N, D, L * N + D, cuda, w_scale)
    f, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    f_p, g_p, act_p = hinge_ref.objective_grad_act(W, X, S, C)
    torch.cuda.synchronize()
    f_mag, g_mag, z = _train_magnitudes(W, X, S, torch.maximum(act, act_p),
                                        C)
    decided = z.abs() > 1e-5
    assert torch.equal(act[decided], act_p[decided])
    assert bool(((f - f_p).abs() <= 1e-5 * f_mag).all())
    assert bool(((g - g_p).abs() <= 1e-5 * g_mag).all())
    again = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    for a, b in zip((f, g, act), again):
        assert torch.equal(a, b)
    strided = hinge_ops.aligned_rows(X)
    assert hinge_ops.row_stride(strided) % 4 == 0
    # A copy only where rows are not aligned: a single row always is.
    assert (strided is X) == (D % 4 == 0 or N == 1)
    for a, b in zip((f, g, act),
                    hinge_ops.hinge_obj_grad_cuda(W, strided, S, C)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,N,D", [
    (1, 1, 1), (1, 5, 300), (130, 1, 257), (129, 131, 1000),
    (300, 257, 4099), (7, 300, 33), (200, 600, 9000),
    (63, 77, 4097), (65, 129, 4098), (1, 333, 2050), (129, 255, 515),
    (65, 1, 6), (63, 130, 4100)])
def test_hvp_kernel_matches_plain(cuda, L, N, D):
    C = 1.3
    W, X, S, V = _train_inputs(L, N, D, L + N * D, cuda)
    _, _, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    hv = hvp_ops.hvp_cuda(V, X, act, C)
    hv_p = hvp_ref.hessian_vp(V, X, act, C)
    mag = 2.0 * V.abs() + 2.0 * C * ((act * (V.abs() @ X.abs().T))
                                     @ X.abs())
    torch.cuda.synchronize()
    assert bool(((hv - hv_p).abs() <= 1e-5 * mag).all())
    assert torch.equal(hv, hvp_ops.hvp_cuda(V, X, act, C))
    assert torch.equal(hv, hvp_ops.hvp_cuda(V, hinge_ops.aligned_rows(X),
                                            act, C))


def test_training_kernels_against_fp64(cuda):
    """grad and Hv against an fp64 product of the same fp32 inputs, dense
    X: the largest error stays within 1e-5 of the magnitude, as the plain
    fp32 version's does. Measured on an H100 80GB HBM3 at 700 W: grad
    5.3e-9 of the magnitude (plain version 8.8e-9), Hv 4.8e-9."""
    L, N, D, C = 129, 300, 4099, 0.7
    rng = np.random.default_rng(11)
    X = torch.tensor(rng.normal(size=(N, D)) / np.sqrt(D),
                     dtype=torch.float32, device=cuda)
    W, S, V = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.normal(size=(L, D)), np.where(rng.random((L, N)) < 0.1, 1.0,
                                          -1.0), rng.normal(size=(L, D))))
    _, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    hv = hvp_ops.hvp_cuda(V, X, act, C)
    Wd, Xd, Sd, Vd, ad = (t.double() for t in (W, X, S, V, act))
    g64 = 2.0 * Wd + 2.0 * C * ((ad * (Wd @ Xd.T - Sd)) @ Xd)
    hv64 = 2.0 * Vd + 2.0 * C * ((ad * (Vd @ Xd.T)) @ Xd)
    g_mag = 2.0 * Wd.abs() + 2.0 * C * ((ad * (Wd.abs() @ Xd.abs().T
                                               + Sd.abs())) @ Xd.abs())
    hv_mag = 2.0 * Vd.abs() + 2.0 * C * ((ad * (Vd.abs() @ Xd.abs().T))
                                         @ Xd.abs())
    g_share = float(((g.double() - g64).abs() / g_mag).max())
    hv_share = float(((hv.double() - hv64).abs() / hv_mag).max())
    plain = float(((hinge_ref.objective_grad_act(W, X, S, C)[1].double()
                    - g64).abs() / g_mag).max())
    print(f"fp64 shares: grad {g_share:.3e} (plain {plain:.3e}), "
          f"Hv {hv_share:.3e}")
    assert g_share <= 1e-5 and hv_share <= 1e-5 and plain <= 1e-5


def test_training_kernels_repeat_bit_for_bit(cuda):
    """20 launches of each training kernel on the same inputs, every one
    `torch.equal` to the first (no atomics, no split-K)."""
    L, N, D, C = 129, 300, 4100, 1.0
    W, X, S, V = _train_inputs(L, N, D, 21, cuda)
    X = hinge_ops.aligned_rows(X)
    first = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    hv0 = hvp_ops.hvp_cuda(V, X, first[2], C)
    for _ in range(19):
        for a, b in zip(first, hinge_ops.hinge_obj_grad_cuda(W, X, S, C)):
            assert torch.equal(a, b)
        assert torch.equal(hv0, hvp_ops.hvp_cuda(V, X, first[2], C))


def test_training_wrappers_route_and_count(cuda):
    W, X, S, V = _train_inputs(40, 50, 300, 5, cuda)
    before = (hinge_ops.hinge_obj_grad_cuda.launches,
              hvp_ops.hvp_cuda.launches)
    f, g, act = hinge_ops.objective_grad_act(W.double(), X, S.half(), 1.0)
    hv = hvp_ops.hessian_vp(V, X, act, 1.0)
    assert (hinge_ops.hinge_obj_grad_cuda.launches,
            hvp_ops.hvp_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert f.dtype == g.dtype == act.dtype == hv.dtype == torch.float32
    with pytest.raises(ValueError, match="active mask"):
        hvp_ops.hessian_vp(V, X, act[:, :-1], 1.0)
    with pytest.raises(ValueError):
        hinge_ops.hinge_obj_grad_cuda(W, X.t().contiguous().t(), S, 1.0)
    with pytest.raises(ValueError):
        hvp_ops.hvp_cuda(V, X.cpu(), act, 1.0)


def test_fit_on_the_card(cuda, tmp_path):
    """`fit` with the kernel ops on the card: complete, the training kernels
    launched, bytes identical with overlap on and off, and the same model
    as the CPU's plain ops to 1e-4 (blocks) with the same top-k ids on
    every decisive row."""
    import json
    from repro_torch.checkpoint.io import load_block_sparse
    from repro_torch.data.xmc import make_xmc_dataset
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import CheckpointHandle, XMCSpec, fit
    d = make_xmc_dataset(n_features=4096, n_labels=256, n_train=400,
                         n_test=100, seed=0)

    def spec(ops, overlap=True):
        return XMCSpec(solver=SolverSpec(ops=ops),
                       schedule=ScheduleSpec(label_batch=128,
                                             overlap=overlap),
                       serve=ServeSpec(warmup=False))

    before = (hinge_ops.hinge_obj_grad_cuda.launches,
              hvp_ops.hvp_cuda.launches)
    card = fit(d.X_train, d.Y_train, spec("pallas"), str(tmp_path / "a"))
    assert card.result.complete and card.device.type == "cuda"
    assert hinge_ops.hinge_obj_grad_cuda.launches > before[0]
    assert hvp_ops.hvp_cuda.launches > before[1]
    fit(d.X_train, d.Y_train, spec("pallas", overlap=False),
        str(tmp_path / "b"))
    cpu = fit(d.X_train, d.Y_train, spec("jnp"), str(tmp_path / "c"),
              device="cpu")
    manifests = [json.loads((tmp_path / x / "bsr_manifest.json").read_text())
                 for x in "abc"]
    assert manifests[0] == manifests[1]
    assert manifests[0]["solver"]["impl"] == "repro_torch/cuda"
    assert manifests[2]["solver"]["impl"] == "repro_torch/cpu"
    for entry in manifests[0]["shards"].values():
        a = np.load(tmp_path / "a" / entry["file"])
        b = np.load(tmp_path / "b" / entry["file"])
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    Wa = load_block_sparse(str(tmp_path / "a"), device="cpu")[0].to_dense()
    Wc = load_block_sparse(str(tmp_path / "c"), device="cpu")[0].to_dense()
    np.testing.assert_allclose(Wa.numpy(), Wc.numpy(), rtol=0, atol=1e-4)
    ids_a = card.engine().serve([d.X_test])[0].labels
    ids_c = CheckpointHandle.open(str(tmp_path / "c"), device="cpu") \
        .engine().serve([d.X_test])[0].labels
    s = np.sort(d.X_test @ Wc.numpy()[:256, :4096].T, axis=1)[:, ::-1]
    rows = (s[:, 4] - s[:, 5]) > 1e-4
    assert rows.sum() > 50
    np.testing.assert_array_equal(ids_a[rows], ids_c[rows])



@pytest.mark.parametrize("shape,shard_data,ops", [
    ((1, 4), False, "pallas"), ((2, 2), True, "jnp")])
def test_sharded_solve_on_one_card(cuda, shape, shard_data, ops):
    """`make_batch_solver` on a mesh of cuda:0 against the single-device
    solve with the same arithmetic, within 1e-5 of the magnitude (a weight
    pruned on one side only must lie within it of Delta, where the prune
    moved): label shards with the kernel ops (the training kernels
    launched from the four shard threads) against the kernel ops; with
    `shard_data`, whose closures are torch ops (no kernel launch),
    against the plain ops."""
    from repro_torch.core import dismec
    from repro_torch.data.xmc import make_xmc_dataset
    from repro_torch.launch.mesh import make_host_mesh
    d = make_xmc_dataset(n_features=4096, n_labels=256, n_train=401,
                         n_test=10, seed=0)
    S = dismec.signs_from_labels(torch.from_numpy(d.Y_train)).to(cuda)
    one = dismec.make_batch_solver(d.X_train, dismec.DiSMECConfig(ops=ops),
                                   device=cuda)(S)
    fns = (hinge_ops.hinge_obj_grad_cuda, hvp_ops.hvp_cuda)
    before = [f.launches for f in fns]
    got = dismec.make_batch_solver(
        d.X_train, dismec.DiSMECConfig(ops="pallas"), make_host_mesh(
            *shape, devices=["cuda:0"] * (shape[0] * shape[1])),
        shard_data=shard_data)(S)
    torch.cuda.synchronize()
    launched = [f.launches > b for f, b in zip(fns, before)]
    assert launched == [not shard_data] * 2
    assert got.shape == one.shape and got.device == one.device
    tol = 1e-5 * max(1.0, float(one.abs().max()))
    diff = (got - one).abs()
    flip = (got == 0) != (one == 0)
    near = torch.maximum(got.abs(), one.abs()) < 0.01 + tol
    ok = (diff <= tol) | (flip & near)
    assert bool(ok.all()), (float(diff[~ok].max()), int(flip.sum()))


def test_predict_topk_sharded_on_one_card(cuda):
    """`predict_topk_sharded` on a (1, 4) mesh of cuda:0: the top-k kernel
    launched once per shard and once for the merge, the ids of the dense
    product's stable sort on every decisive row and on the zero row (the
    lowest ids), scores within 1e-5."""
    from repro_torch.core.prediction import (predict_topk,
                                             predict_topk_sharded)
    from repro_torch.launch.mesh import make_host_mesh
    rng = np.random.default_rng(3)
    W = torch.tensor(0.1 * rng.normal(size=(1000, 512)), dtype=torch.float32,
                     device=cuda)
    X = _x(33, 512, 4, cuda)
    X[5] = 0.0
    before = topk_ops.blocked_topk_cuda.launches
    s, i = predict_topk_sharded(X, W, 5, make_host_mesh(
        1, 4, devices=["cuda:0"] * 4), n_labels=998)
    torch.cuda.synchronize()
    assert topk_ops.blocked_topk_cuda.launches == before + 5
    s0, i0 = predict_topk(X, W[:998], 6)
    rows = ((s0[:, 4] - s0[:, 5]) > 1e-4).cpu()
    rows[5] = True
    assert int(rows.sum()) > 25
    assert torch.equal(i.cpu()[rows], i0[:, :5].cpu()[rows])
    assert i[5].tolist() == [0, 1, 2, 3, 4]
    assert float((s - s0[:, :5]).abs().max()) <= 1e-5


def test_sharded_backend_default_mesh_on_the_card(cuda):
    """The `sharded` factory with no mesh on a model on the card: one
    shard per card from the model's own on, each densified on its card
    from its rows; the ids of `dense` on every decisive row, the top-k
    kernel launched."""
    from repro_torch.serve.xmc import make_backend
    rng = np.random.default_rng(5)
    W = (0.1 * rng.normal(size=(1000, 512))).astype(np.float32)
    W[np.abs(W) < 0.05] = 0.0
    bsr = to_block_sparse(W, (128, 128), device=cuda)
    be = make_backend("sharded", bsr, 5)
    assert len(be._shards) == torch.cuda.device_count()
    assert [t.device for t in be._shards] == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    X = _x(33, 512, 4, cuda)
    before = topk_ops.blocked_topk_cuda.launches
    _, ids = be.topk(X)
    torch.cuda.synchronize()
    assert topk_ops.blocked_topk_cuda.launches > before
    s0 = X @ torch.from_numpy(W).to(cuda).T
    v0, i0 = torch.sort(s0, dim=1, descending=True, stable=True)
    rows = ((v0[:, 4] - v0[:, 5]) > 1e-4).cpu()
    assert int(rows.sum()) > 25
    assert torch.equal(ids.long().cpu()[rows], i0[:, :5].cpu()[rows])

# ---------------------------------------------------------------------------
# Banded attention (the LM's local layers) and the LM serving path.
# Tolerances, those of the JAX kernel test: 2e-4 in float32 (the same fp32
# products summed in another order); 3e-2 in bfloat16, where the plain
# version rounds the softmax weights and the output to bf16 and the bf16
# kernel rounds the unnormalized probabilities and the output.
# ---------------------------------------------------------------------------

BANDED_CASES = [  # (B, T, H, KV, hd, window): the JAX kernel test's four,
    (1, 256, 4, 2, 32, 64),                   # then hymba-1.5b's heads,
    (2, 512, 4, 4, 64, 128),                  # then the bf16 kernel's tile
    (1, 1024, 8, 2, 64, 256),                 # edges: T no tile divides,
    (2, 384, 6, 2, 32, 100),                  # window 1, window under the
    (2, 2304, 25, 5, 64, 1024),               # 64-key tile, window >= T;
    (1, 300, 5, 1, 16, 33),                   # G of 1, 5 and 8; hd of 16,
    (2, 200, 8, 1, 64, 1),                    # 32, 64 and 128
    (1, 200, 8, 8, 32, 50),
    (1, 777, 10, 2, 128, 129),
    (1, 300, 10, 2, 128, 500),
    (1, 65, 3, 3, 16, 7),
    (1, 4608, 48, 8, 128, 4096),              # mixtral-8x22b's heads
]


def _band_inputs(B, Tq, Tk, H, KV, hd, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((B, Tq, H, hd), generator=g, device=device)
            .to(dtype),
            torch.randn((B, Tk, KV, hd), generator=g, device=device)
            .to(dtype),
            torch.randn((B, Tk, KV, hd), generator=g, device=device)
            .to(dtype))


@pytest.mark.parametrize("B,T,H,KV,hd,window", BANDED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_kernel_matches_plain(cuda, B, T, H, KV, hd, window, dtype):
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    q, k, v = _band_inputs(B, T, T, H, KV, hd, dtype, T + window, cuda)
    before = band_ops.banded_attention_cuda.launches
    got = band_ops.banded_attention(q, k, v, window=window)
    again = band_ops.banded_attention(q, k, v, window=window)
    want = band_ref.banded_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert band_ops.banded_attention_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (B, T, H * hd)
    assert torch.equal(got, again)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_banded_kernel_window_beyond_t_and_ragged(cuda):
    """A window wider than the sequence (plain causal attention) and a
    length no tile divides."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    g = torch.Generator(device=cuda).manual_seed(1)
    for T, window in ((300, 500), (777, 129)):
        q = torch.randn((1, T, 10, 128), generator=g, device=cuda)
        k = torch.randn((1, T, 2, 128), generator=g, device=cuda)
        v = torch.randn((1, T, 2, 128), generator=g, device=cuda)
        got = band_ops.banded_attention(q, k, v, window=window)
        want = band_ref.banded_attention(q, k, v, window=window)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_kernel_softcap_and_fewer_queries(cuda, dtype):
    """A tanh softcap at B = 2, and Tq < Tk (the queries are the first Tq
    positions)."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    for Tq, Tk, softcap in ((300, 300, 5.0), (200, 333, None)):
        q, k, v = _band_inputs(2, Tq, Tk, 4, 2, 64, dtype, Tq + Tk, cuda)
        got = band_ops.banded_attention(q, k, v, window=100, softcap=softcap)
        want = band_ref.banded_attention(q, k, v, window=100,
                                         softcap=softcap)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_banded_kernel_repeats_bit_for_bit(cuda):
    """20 launches of the bf16 kernel at hymba-1.5b's heads, each equal to
    the first (no atomics, a fixed order)."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    q, k, v = _band_inputs(2, 2304, 2304, 25, 5, 64, torch.bfloat16, 3,
                           cuda)
    first = band_ops.banded_attention(q, k, v, window=1024)
    outs = [band_ops.banded_attention(q, k, v, window=1024)
            for _ in range(19)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


def test_banded_kernel_takes_a_misaligned_view(cuda):
    """A contiguous bf16 view 2 bytes past a 16-byte boundary, which a
    tensor map cannot describe: `banded_attention_cuda` refuses it with a
    ValueError, `banded_attention` copies it and gives the aligned copy's
    bits."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    q, k, v = _band_inputs(1, 200, 200, 4, 2, 64, torch.bfloat16, 9, cuda)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    view = flat[1:].view(q.shape)
    view.copy_(q)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        band_ops.banded_attention_cuda(view, k, v, window=50)
    assert torch.equal(band_ops.banded_attention(view, k, v, window=50),
                       band_ops.banded_attention(q, k, v, window=50))


def test_banded_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.banded_attn import ops as band_ops
    q = torch.zeros((1, 16, 4, 32), device=cuda)
    k = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        band_ops.banded_attention_cuda(torch.zeros((1, 16, 4, 48),
                                                   device=cuda),
                                       torch.zeros((1, 16, 2, 48),
                                                   device=cuda),
                                       torch.zeros((1, 16, 2, 48),
                                                   device=cuda), window=4)
    with pytest.raises(ValueError, match="type"):
        band_ops.banded_attention_cuda(q, k.bfloat16(), k, window=4)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        band_ops.banded_attention_cuda(q, k[:, :8], k[:, :8], window=4)
    with pytest.raises(ValueError, match="contiguous"):
        band_ops.banded_attention_cuda(q.transpose(1, 2), k, k, window=4)


def test_lm_prefill_and_decode_on_the_card(cuda):
    """hymba-1.5b-smoke on the card against the same weights on the CPU:
    prefill at T = 2,304 launches the banded kernel once per local layer
    and gives the CPU's top-5 ids; two greedy decode steps follow."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_windows_static
    cfg = get_config("hymba-1.5b", smoke=True)
    card, host = build_model(cfg), build_model(cfg, device="cpu")
    p_host = host.init(torch.Generator().manual_seed(0))
    p_card = copy.deepcopy(p_host).to(cuda)
    toks = np.random.default_rng(0).integers(2, cfg.vocab, size=(2, 2304))
    n_local = sum(1 for w in layer_windows_static(cfg, use_swa=True) if w)
    before = band_ops.banded_attention_cuda.launches
    v, i, c = card.prefill(p_card, {"tokens": toks}, use_swa=True)
    torch.cuda.synchronize()
    assert band_ops.banded_attention_cuda.launches == before + n_local
    hv, hi, hc = host.prefill(p_host, {"tokens": toks}, use_swa=True)
    np.testing.assert_array_equal(i.cpu().numpy(), hi.numpy())
    torch.testing.assert_close(v.cpu(), hv, rtol=1e-3, atol=1e-3)
    for key in ("k", "v"):
        torch.testing.assert_close(c[key].cpu().float(), hc[key].float(),
                                   rtol=2.0 ** -6, atol=1e-3)
    before = topk_ops.blocked_topk_cuda.launches
    out = card.decode_step(p_card, {
        **c, **{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, 2))
                for k in ("k", "v")}}, i[:, :1], 2304, use_swa=True)
    assert topk_ops.blocked_topk_cuda.launches == before + 1
    assert out[1].shape == (2, 5) and out[1].device.type == "cuda"


# --- the Table 2 baselines (repro_torch.baselines) --------------------------

BASELINES = ("l1_svm", "leml", "sleec", "fastxml", "pd_sparse")


@pytest.fixture(scope="module")
def baseline_data():
    from repro_torch.data.xmc import make_xmc_dataset
    return make_xmc_dataset(n_train=300, n_test=100, n_features=1024,
                            n_labels=64, seed=0)


def _train_baseline(name, d, device, **kw):
    from repro_torch import baselines
    if name == "pd_sparse":
        kw.setdefault("n_steps", 100)
    return getattr(baselines, f"train_{name}")(d.X_train, d.Y_train,
                                               device=device, **kw)


def _to_card(name, m, device):
    """A CPU-trained baseline's model, carried to `device`."""
    from repro_torch import convert
    if name in ("l1_svm", "pd_sparse"):
        return convert.linear_model_from_numpy(m.W.numpy(), device=device)
    if name == "leml":
        return convert.leml_model_from_numpy(m.U.numpy(), m.V.numpy(),
                                             device=device)
    if name == "sleec":
        return convert.sleec_model_from_numpy(
            m.centroids.numpy(), [a.numpy() for a in m.regressors],
            [a.numpy() for a in m.embeddings], [a.numpy() for a in m.labels],
            knn=m.knn, device=device)
    return convert.fastxml_model_from_numpy(
        [dict(splits=t.splits.numpy(), children=t.children.numpy(),
              leaves=t.leaves.numpy(), root=t.root, depth=t.depth)
         for t in m.trees], n_labels=m.n_labels, device=device)


def _decisive_rows(s: np.ndarray, tol: float, k: int = 5) -> np.ndarray:
    top = -np.sort(-s, axis=1)
    return (top[:, k - 1] - top[:, k]) > 2 * tol * np.abs(s).max(axis=1)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_predict_on_the_card(cuda, baseline_data, name):
    """A CPU-trained baseline on the card: `predict_topk` launches the
    top-k kernel (SLEEC also for its kNN sets) and gives the CPU's ids on
    every row whose 5th and 6th scores lie more than 2e-5 of the row's
    largest |score| apart, and the plain path's (a stable sort of the
    card's own scores) on every row."""
    d = baseline_data
    host = _train_baseline(name, d, "cpu")
    card = _to_card(name, host, cuda)
    before = topk_ops.blocked_topk_cuda.launches
    vals, ids = card.predict_topk(d.X_test, 5)
    torch.cuda.synchronize()
    launched = topk_ops.blocked_topk_cuda.launches - before
    assert launched >= (2 if name == "sleec" else 1)
    s_card = card.scores(d.X_test)
    want = topk_ref.topk(s_card, 5)
    assert torch.equal(ids, want[1]) and torch.equal(vals, want[0])
    s = host.scores(d.X_test).numpy()
    rows = _decisive_rows(s, 1e-5)
    assert rows.sum() >= 30
    np.testing.assert_array_equal(ids.cpu().numpy()[rows],
                                  host.predict_topk(d.X_test, 5)[1]
                                  .numpy()[rows])


@pytest.mark.parametrize("name,tol", [("l1_svm", 5e-4), ("leml", 1e-4),
                                      ("sleec", 1e-4), ("pd_sparse", 1e-5)])
def test_baseline_trained_on_the_card(cuda, baseline_data, name, tol):
    """Each baseline trained on the card against the same port on the CPU,
    to the CPU tests' bounds against the JAX package: L1-SVM's weights
    within 5e-4 of their magnitude, LEML's and SLEEC's scores within 1e-4,
    PD-Sparse's 100 steps within 1e-5; ids on decisive rows."""
    d = baseline_data
    host = _train_baseline(name, d, "cpu")
    card = _train_baseline(name, d, cuda)
    s_host = host.scores(d.X_test).numpy()
    s_card = card.scores(d.X_test).cpu().numpy()
    if name in ("l1_svm", "pd_sparse"):
        err = float((card.W.cpu() - host.W).abs().max() / host.W.abs().max())
        assert err <= tol, err
    else:
        err = np.abs(s_card - s_host).max() / np.abs(s_host).max()
        assert err <= tol, err
    rows = _decisive_rows(s_host, tol)
    assert rows.sum() >= 30
    np.testing.assert_array_equal(
        card.predict_topk(d.X_test, 5)[1].cpu().numpy()[rows],
        host.predict_topk(d.X_test, 5)[1].numpy()[rows])


def test_pd_sparse_on_the_card_bit_for_bit(cuda, baseline_data):
    """M @ X in place of the scatter-add: two card runs give the same W."""
    d = baseline_data
    a = _train_baseline("pd_sparse", d, cuda, n_steps=300)
    b = _train_baseline("pd_sparse", d, cuda, n_steps=300)
    assert torch.equal(a.W, b.W)


def test_fastxml_card_tree_is_the_cpu_tree(cuda, baseline_data):
    """The same draws, splits within 1e-5 of their magnitude, the same
    children and leaves, and the same ids on every row."""
    d = baseline_data
    host = _train_baseline("fastxml", d, "cpu")
    card = _train_baseline("fastxml", d, cuda)
    for h, c in zip(host.trees, card.trees):
        assert (h.root, h.depth) == (c.root, c.depth)
        assert torch.equal(h.children, c.children.cpu())
        assert torch.equal(h.leaves, c.leaves.cpu())
        err = (c.splits.cpu() - h.splits).abs().max() / h.splits.abs().max()
        assert float(err) <= 1e-5
    np.testing.assert_array_equal(card.predict_topk(d.X_test, 5)[1].cpu()
                                  .numpy(),
                                  host.predict_topk(d.X_test, 5)[1].numpy())


# --- LM training (train/trainer.py): no kernel runs in training --------------

def _kernel_launches() -> dict:
    from repro_torch.kernels.banded_attn import ops as band_ops
    fns = (bsr_ops.bsr_predict_cuda, bsr_ops.bsr_predict_int8_cuda,
           bsr_ops.bsr_predict_gather_cuda,
           bsr_ops.bsr_predict_gather_int8_cuda,
           bsr_ops.bsr_predict_gather_pq_cuda,
           bsr_ops.bsr_predict_gather_pq_int8_cuda,
           topk_ops.blocked_topk_cuda, hinge_ops.hinge_obj_grad_cuda,
           hvp_ops.hvp_cuda, band_ops.banded_attention_cuda)
    return {fn.__name__: fn.launches for fn in fns}


def _lm_train_setup(arch, T, accum=2, micro=2, steps=3, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.data.lm import make_lm_batch_iterator
    from repro_torch.models.model import build_model
    cfg = get_config(arch, smoke=True)
    host = build_model(cfg, device="cpu")
    p0 = host.init(torch.Generator().manual_seed(seed))
    it = make_lm_batch_iterator(cfg.vocab, T, accum * micro, seed=seed)
    batches = [{k: v.reshape(accum, micro, T) for k, v in next(it).items()}
               for _ in range(steps)]
    return cfg, host, build_model(cfg), p0, batches


def _run_steps(model, p, batches, accum=2):
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import init_train_state, make_train_step
    step = make_train_step(model, lr_fn=linear_warmup_cosine(3e-4, 2, 8),
                           accum=accum)
    st = init_train_state(p)
    opt, s, losses = st.opt, st.step, []
    for b in batches:
        p, opt, met = step(p, opt, s, b)
        s = s + 1
        losses.append(float(met["loss"]))
    return p, losses


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-0.5b"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke config (fp32), `make_train_step` with accum = 2 on the
    card against the port on the CPU: the first step's gradients within
    1e-5 of the largest |element|, `adamw_update` of the card's gradients
    on both within 1e-6 relative, three steps' losses within 1e-4."""
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train.trainer import loss_and_grads
    cfg, host, card, p0, batches = _lm_train_setup(arch, 64)
    _, _, gh = loss_and_grads(host, copy.deepcopy(p0), batches[0], 2)
    _, _, gc = loss_and_grads(card, copy.deepcopy(p0).to(cuda), batches[0],
                              2)
    mag = max(float(g.abs().max()) for g in gh.values())
    for n, g in gh.items():
        assert float((gc[n].cpu() - g).abs().max()) <= 1e-5 * mag, n
    updated = []
    for dev in ("cpu", cuda):
        p = copy.deepcopy(p0).to(dev)
        adamw_update(p, {n: g.to(dev) for n, g in gc.items()},
                     adamw_init(p), 1.5e-4)
        updated.append([t.detach().cpu() for t in p.parameters()])
    for a, b in zip(*updated):
        assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-9).all())
    _, lh = _run_steps(host, copy.deepcopy(p0), batches)
    _, lc = _run_steps(card, copy.deepcopy(p0).to(cuda), batches)
    np.testing.assert_allclose(lc, lh, rtol=1e-4)


def test_lm_train_steps_repeat_bit_for_bit(cuda):
    """Three steps twice from the same weights and batches on the card:
    the same losses and weights, bit for bit."""
    cfg, _, card, p0, batches = _lm_train_setup("hymba-1.5b", 64)
    pa, la = _run_steps(card, copy.deepcopy(p0).to(cuda), batches)
    pb, lb = _run_steps(card, copy.deepcopy(p0).to(cuda), batches)
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa.parameters(),
                                                 pb.parameters()))


@pytest.mark.parametrize("T", [2304, 4096])
def test_lm_forward_backward_above_dense_t_on_the_card(cuda, T):
    """hymba-1.5b-smoke's `train_loss` and its backward at T = 2,304 and
    4,096 (blockwise attention in every layer, the SSD over 9 and 16
    chunks): finite loss and gradients, and none of the ten kernels
    launched."""
    from repro_torch.train.trainer import loss_and_grads
    cfg, _, card, p0, batches = _lm_train_setup("hymba-1.5b", T, accum=1,
                                                micro=1, steps=1)
    before = _kernel_launches()
    loss, _, grads = loss_and_grads(card, copy.deepcopy(p0).to(cuda),
                                    {k: v[0] for k, v in batches[0].items()})
    torch.cuda.synchronize()
    assert _kernel_launches() == before
    assert bool(torch.isfinite(loss))
    for n, g in grads.items():
        assert bool(torch.isfinite(g).all()), n


# --- the MoE, xLSTM and prefix families --------------------------------------

def _moe_cfg(E, k, d=256, f=192, shared=0):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("qwen2-moe-a2.7b", smoke=True), d_model=d, n_experts=E,
        moe_top_k=k, moe_d_ff=f, n_shared_experts=shared,
        shared_d_ff=2 * f if shared else None, capacity_factor=1.0)


@pytest.mark.parametrize("E,k,dtype", [(60, 4, torch.bfloat16),
                                       (8, 2, torch.float32)])
def test_moe_combine_repeats_bit_for_bit(cuda, E, k, dtype):
    """`moe_ffn` at qwen2-moe's (60 experts, top-4, a shared expert) and
    mixtral's (8, top-2) routing over 4,096 tokens, forward and backward,
    twice: the same bits (no atomic adds in the dispatch or the combine),
    with assignments dropped at a capacity factor of 1."""
    from repro_torch.models import moe
    cfg = _moe_cfg(E, k, shared=1 if E == 60 else 0)
    g = torch.Generator(device=cuda).manual_seed(E)
    p = moe.init_moe(cfg, g, dtype)
    x = torch.randn((2, 2048, cfg.d_model), generator=g, device=cuda) \
        .to(dtype)
    runs = []
    for _ in range(2):
        p.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        with moe.count_dropped() as drops:
            out, aux = moe.moe_ffn(cfg, p, xi)
        loss = out.float().square().sum() + aux
        grads = torch.autograd.grad(loss, [xi, *p.parameters()])
        runs.append((out.detach(), aux.detach(), grads,
                     int(drops[0][1])))
    assert runs[0][3] == runs[1][3] > 0
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


def test_expert_products_on_the_card(cuda):
    """`moe._f32_bmm` on bf16 operands: without a gradient to take,
    `bmm(out_dtype=float32)`; with one, the widened product (and its
    backward). Both within 1e-5 of the products' magnitude of each other,
    each twice bit for bit."""
    from repro_torch.models import moe
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((60, 341, 512), generator=g, device=cuda).bfloat16()
    b = (torch.randn((60, 512, 352), generator=g, device=cuda) * 0.05) \
        .bfloat16()
    with torch.no_grad():
        served = [moe._f32_bmm(a, b) for _ in range(2)]
    b.requires_grad_(True)
    trained = [moe._f32_bmm(a, b) for _ in range(2)]
    grad = torch.autograd.grad(trained[0].sum(), b)[0]
    mag = torch.bmm(a.float().abs(), b.detach().float().abs())
    assert served[0].dtype == trained[0].dtype == torch.float32
    assert torch.equal(*served) and torch.equal(*trained)
    assert bool(((served[0] - trained[0]).abs() <= 1e-5 * mag).all())
    assert grad.dtype == torch.bfloat16 and bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("E,k", [(8, 2), (60, 4)])
def test_router_topk_matches_the_stable_sort(cuda, E, k):
    """The router's top-k on the blocked top-k kernel at mixtral's and
    qwen2-moe's widths: the stable sort's ids (the lowest id first on a
    tie), rows of ties included, and the gate values gathered from the
    probabilities."""
    from repro_torch.models import moe
    rng = np.random.default_rng(E)
    P = rng.random((3000, E)).astype(np.float32)
    P[::3] = np.round(P[::3] * 3) / 3 + 0.1         # rows of exact ties
    P[1, :] = 0.25
    P /= P.sum(axis=1, keepdims=True)
    probs = torch.from_numpy(P).to(cuda)
    before = topk_ops.blocked_topk_cuda.launches
    vals, idx = moe.route(probs, k)
    torch.cuda.synchronize()
    assert topk_ops.blocked_topk_cuda.launches == before + 1
    _, want = topk_ref.topk(torch.from_numpy(P), k)
    assert torch.equal(idx.cpu(), want.long())
    g = torch.gather(torch.from_numpy(P), 1, want.long())
    torch.testing.assert_close(vals.cpu(), g / g.sum(dim=1, keepdim=True),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("T", [256, 512])
def test_mlstm_chunks_match_its_decode_on_the_card(cuda, T):
    """xlstm-125m-smoke's mLSTM on the card: the chunked form against T
    one-token steps, outputs and the final state (T a multiple of the
    256-row chunk), within 1e-4 of their magnitudes."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("xlstm-125m", smoke=True)
    g = torch.Generator(device=cuda).manual_seed(T)
    p = ssm.init_mlstm(cfg, g, torch.float32)
    x = torch.randn((2, T, cfg.d_model), generator=g, device=cuda)
    out, st = ssm.mlstm(cfg, p, x, return_state=True)
    ds = ssm.mlstm_init_state(cfg, 2, device=cuda)
    outs = []
    for t in range(T):
        y, ds = ssm.mlstm_decode(cfg, p, x[:, t:t + 1], ds)
        outs.append(y)
    dec = torch.cat(outs, dim=1)
    assert float((dec - out).abs().max()) <= 1e-4 * float(out.abs().max())
    wc = st.C * torch.exp(st.m)[..., None, None]
    wd = ds.C * torch.exp(ds.m)[..., None, None]
    assert float((wc - wd).norm() / wd.norm()) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b",
                                  "xlstm-125m", "internvl2-26b"])
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """The smoke config (fp32) on the card against the same weights on the
    CPU: prefill's top-5 ids (mixtral at T = 2,304 on the banded kernel,
    internvl2 with its prefix), the blocked top-k kernel launched, the
    MoE's dropped counts equal; then `make_train_step` with accum = 2:
    the loss within 1e-4 relative."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.models import moe
    cfg, host, card, p0, batches = _lm_train_setup(arch, 64, steps=1)
    T = 2304 if cfg.swa_always else 320
    toks = np.random.default_rng(1).integers(2, cfg.vocab, size=(2, T))
    b = {"tokens": toks}
    if cfg.n_prefix:
        b["prefix"] = np.random.default_rng(2).normal(
            size=(2, cfg.n_prefix, cfg.d_model)).astype(np.float32) * 0.05
        for x in batches:
            x["prefix"] = np.full((2, 2, cfg.n_prefix, cfg.d_model), 0.01,
                                  np.float32)
    out = {}
    for dev, m, p in (("cpu", host, p0), ("cuda", card,
                                          copy.deepcopy(p0).to(cuda))):
        before = _kernel_launches()
        with moe.count_dropped() as drops:
            v, i, _ = m.prefill(p, b, use_swa=cfg.swa_always)
        after = _kernel_launches()
        out[dev] = (v.cpu(), i.cpu(), [int(d) for _, d in drops],
                    {k: after[k] - before[k] for k in after})
        _, lo = _run_steps(m, p, batches)
        out[dev] += (lo,)
    (hv, hi, hd, _, hl), (cv, ci, cd, launches, cl) = out["cpu"], \
        out["cuda"]
    assert torch.equal(ci, hi) and hd == cd
    torch.testing.assert_close(cv, hv, rtol=1e-3, atol=1e-3)
    assert launches["blocked_topk_cuda"] >= 1
    if cfg.swa_always:
        assert launches["banded_attention_cuda"] == cfg.n_layers
    np.testing.assert_allclose(cl, hl, rtol=1e-4)


# --- the encoder-decoder and LM training over a mesh ------------------------

def test_encdec_on_the_card_matches_the_cpu(cuda):
    """seamless-m4t-medium's smoke config (fp32) on the card against the
    same weights on the CPU: prefill's top-5 (random frames), the four
    caches, 4 decode steps, kernel 9 once a prefill and once a step; then
    `make_train_step` with accum = 2, the loss within 1e-4 relative."""
    cfg, host, card, p0, batches = _lm_train_setup("seamless-m4t-medium",
                                                   32, steps=1)
    rng = np.random.default_rng(3)
    frames = (0.05 * rng.normal(size=(2, cfg.n_prefix, cfg.d_model))
              ).astype(np.float32)
    b = {"tokens": rng.integers(2, cfg.vocab, size=(2, 40)),
         "prefix": frames}
    batches[0]["prefix"] = (0.05 * rng.normal(
        size=(2, 2, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    out = {}
    for dev, m, p in (("cpu", host, p0), ("cuda", card,
                                          copy.deepcopy(p0).to(cuda))):
        before = _kernel_launches()
        v, i, cache = m.prefill(p, b)
        cache = {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4))
                 if k in ("k", "v") else t for k, t in cache.items()}
        steps = []
        for s in range(4):
            dv, di, cache = m.decode_step(p, cache, b["tokens"][:, s:s + 1],
                                          40 + s)
            steps.append(dv.cpu())
        after = _kernel_launches()
        _, lo = _run_steps(m, p, batches)
        out[dev] = (v.cpu(), i.cpu(), {k: t.float().cpu()
                                       for k, t in cache.items()}, steps,
                    {k: after[k] - before[k] for k in after}, lo)
    (hv, hi, hc, hs, _, hl), (cv, ci, cc, cs, launches, cl) = \
        out["cpu"], out["cuda"]
    assert torch.equal(ci, hi)
    torch.testing.assert_close(cv, hv, rtol=1e-3, atol=1e-3)
    for k in hc:
        torch.testing.assert_close(cc[k], hc[k], rtol=2.0 ** -6, atol=1e-3)
    for a, w in zip(cs, hs):
        torch.testing.assert_close(a, w, rtol=1e-2, atol=1e-2)
    assert launches["blocked_topk_cuda"] == 5
    assert sum(launches.values()) == 5
    np.testing.assert_allclose(cl, hl, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_lm_mesh_step_on_the_card(cuda, arch):
    """`make_train_step` over a (2, 2) grid of cuda:0 cells, batch axes
    ("data",): the loss within 1e-4 relative of the same step over a grid
    of the CPU, the MoE's drops per shard equal, two card runs bit for
    bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg, host, card, p0, batches = _lm_train_setup(arch, 32, steps=1)
    b = batches[0]
    if cfg.n_prefix:
        b["prefix"] = (0.05 * np.random.default_rng(4).normal(
            size=(2, 2, cfg.n_prefix, cfg.d_model))).astype(np.float32)

    def run(dev, m, p):
        mesh = make_host_mesh(2, 2, devices=[dev] * 4)
        with torch.no_grad(), moe.count_dropped() as d:
            m.train_loss(p, {k: v[0] for k, v in b.items()}, mesh=mesh,
                         batch_axes=("data",))
        step = make_train_step(m, lr_fn=linear_warmup_cosine(3e-4, 2, 8),
                               mesh=mesh, batch_axes=("data",), accum=2)
        st = init_train_state(p)
        p, _, met = step(p, st.opt, st.step, b)
        return (float(met["loss"]), [int(x) for _, x in d],
                [t.detach().cpu() for t in p.parameters()])
    hl, hd, _ = run("cpu", host, p0)
    (cl, cd, cp), (cl2, _, cp2) = (
        run("cuda:0", card, copy.deepcopy(p0).to(cuda)) for _ in range(2))
    np.testing.assert_allclose(cl, hl, rtol=1e-4)
    assert cd == hd
    assert cl == cl2 and all(torch.equal(x, y) for x, y in zip(cp, cp2))
