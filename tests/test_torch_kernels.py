"""The port's kernel modules (`repro_torch.kernels`) against the JAX
package's, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as the JAX package's own
kernel tests do. Inputs are made from a seed with numpy and handed to both.

Tolerance for scores: rtol 1e-5, atol 1e-6 — both sides sum the same fp32
products, in another order. Top-k ids and values are compared exactly:
the top-k only selects, and every top-k in the port orders by descending
value, then ascending label id, as `_topk_kernel` and `lax.top_k` do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.pruning import to_block_sparse as jax_to_block_sparse
from repro.kernels.bsr_predict import ops as jax_bsr_ops
from repro.kernels.bsr_predict import ref as jax_bsr_ref
from repro.kernels.topk import ops as jax_topk_ops
from repro.kernels.topk.kernel import blocked_topk_pallas
from repro_torch.convert import block_sparse_from_numpy
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import ref as topk_ref

RTOL, ATOL = 1e-5, 1e-6


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


# -- top-k -------------------------------------------------------------------

@pytest.mark.parametrize("n,L", [(2, 128), (8, 1024), (3, 1000), (16, 4096)])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_matches_jax(n, L, k):
    """The shapes of the JAX package's top-k kernel test."""
    s = np.random.default_rng(n * L + k).normal(size=(n, L)).astype(
        np.float32)
    v_j, i_j = jax_topk_ops.topk(jnp.asarray(s), k, bL=256)
    v_t, i_t = topk_ops.topk(torch.from_numpy(s), k, bL=256)
    np.testing.assert_array_equal(_np(v_t), np.asarray(v_j))
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    v_r, i_r = topk_ref.topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(_np(v_r), np.asarray(v_j))
    np.testing.assert_array_equal(_np(i_r), np.asarray(i_j))


def _tie_rows(L: int) -> np.ndarray:
    """Rows where ties decide the order: exact zeros, zeros with one 1.0 at
    id 700, few distinct levels, all negative, and all equal negative."""
    rng = np.random.default_rng(L)
    spike = np.zeros(L, np.float32)
    spike[700 % L] = 1.0
    return np.stack([
        np.zeros(L, np.float32),
        spike,
        rng.integers(0, 3, L).astype(np.float32),
        -np.abs(rng.normal(size=L)).astype(np.float32) - 1.0,
        np.full(L, -2.5, np.float32),
    ])


@pytest.mark.parametrize("L,bL", [(1000, 256), (1000, 512), (300, 128),
                                  (4096, 512)])
@pytest.mark.parametrize("k", [1, 5])
def test_topk_tie_order_matches_jax(L, bL, k):
    s = _tie_rows(L)
    v_j, i_j = jax_topk_ops.topk(jnp.asarray(s), k, bL=bL)
    v_t, i_t = topk_ops.topk(torch.from_numpy(s), k, bL=bL)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(_np(v_t), np.asarray(v_j))
    np.testing.assert_array_equal(_np(topk_ref.topk(torch.from_numpy(s),
                                                    k)[1]), np.asarray(i_j))
    if L >= 701 and k == 5:
        np.testing.assert_array_equal(_np(i_t)[:2],
                                      [[0, 1, 2, 3, 4], [700, 0, 1, 2, 3]])


@pytest.mark.parametrize("n,L,bL,k", [(3, 1024, 256, 5), (5, 1536, 512, 3),
                                      (2, 256, 128, 1)])
def test_blocked_stage_matches_pallas_kernel(n, L, bL, k):
    """The plain version of the blocked stage gives the TPU kernel's
    candidate strip exactly, ties included."""
    rng = np.random.default_rng(L + k)
    s = rng.normal(size=(n, L)).astype(np.float32)
    s[0] = 0.0
    s[1, ::3] = 0.5
    v_j, i_j = blocked_topk_pallas(jnp.asarray(s), k, bL=bL, interpret=True)
    v_t, i_t = topk_ref.blocked_topk(torch.from_numpy(s), k, bL=bL)
    np.testing.assert_array_equal(_np(v_t), np.asarray(v_j))
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))


def test_topk_wrapper_rejects_unaligned_blocked_width():
    with pytest.raises(ValueError, match="multiple"):
        topk_ref.blocked_topk(torch.zeros((2, 300)), 3, bL=128)


# -- BSR predict ---------------------------------------------------------------

def _sparse_W(L, D, density, seed, block):
    """Block-sparse weights of the scale DiSMEC learns (|w| ~ 0.1)."""
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    bl, bd = block
    keep = rng.random((-(-L // bl), -(-D // bd))) < density
    mask = np.kron(keep, np.ones((bl, bd), np.float32))[:L, :D]
    return W * mask


def _requests(n, D, seed):
    """L2-normalised rows, as tf-idf requests are."""
    x = np.random.default_rng(seed).normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _models(W, block):
    """The same packed weights in both packages."""
    jm = jax_to_block_sparse(jnp.asarray(W), block)
    fields = {f: np.asarray(getattr(jm, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    tm = block_sparse_from_numpy(fields, shape=jm.shape,
                                 block_shape=jm.block_shape,
                                 orig_shape=jm.orig_shape, device="cpu")
    return jm, tm


BSR_CASES = [
    # (L, D, density, block): ragged L and D, empty row blocks, dense.
    (64, 64, 0.3, (16, 16)),
    (100, 200, 0.25, (16, 16)),
    (256, 128, 0.6, (32, 32)),
    (90, 300, 0.15, (8, 32)),
    (64, 64, 1.0, (16, 16)),
]


@pytest.mark.parametrize("L,D,density,block", BSR_CASES)
@pytest.mark.parametrize("n", [1, 8])
def test_bsr_predict_matches_jax(L, D, density, block, n):
    W = _sparse_W(L, D, density, seed=L + D, block=block)
    jm, tm = _models(W, block)
    x = _requests(n, D, seed=n)
    out_t = _np(bsr_ops.bsr_predict(torch.from_numpy(x), tm))
    out_k = np.asarray(jax_bsr_ops.bsr_predict(jnp.asarray(x), jm,
                                               interpret=True))
    xp = np.pad(x, ((0, 0), (0, jm.shape[1] - D)))   # the oracle takes Dp
    out_r = np.asarray(jax_bsr_ref.bsr_predict(jnp.asarray(xp), jm))
    assert out_t.shape == out_k.shape == (n, tm.shape[0])
    np.testing.assert_allclose(out_t, out_k, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_t, out_r, rtol=RTOL, atol=ATOL)
    # Row blocks with no packed block score exact zeros.
    bl = block[0]
    empty = np.diff(_np(tm.row_ptr)) == 0
    assert np.all(out_t.reshape(n, -1, bl)[:, empty] == 0.0)


@pytest.mark.parametrize("L,D,density,block", BSR_CASES)
def test_bsr_plain_version_matches_dense(L, D, density, block):
    """The plain version (gather, einsum, index_add_) is x @ W.T."""
    W = _sparse_W(L, D, density, seed=7 * L + D, block=block)
    _, tm = _models(W, block)
    x = _requests(4, D, seed=3)
    xp = bsr_ops._pad_features(torch.from_numpy(x), tm)
    R = tm.shape[0] // block[0]
    out = _np(bsr_ref.bsr_predict(xp, tm.blocks, tm.block_rows,
                                  tm.block_cols, R))
    np.testing.assert_allclose(out[:, :L], x @ W.T, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(tm.to_dense())[:L, :D], W)


@pytest.mark.parametrize("L,D,density,block", BSR_CASES)
@pytest.mark.parametrize("k", [1, 5])
def test_bsr_predict_topk_matches_jax(L, D, density, block, k):
    W = _sparse_W(L, D, density, seed=L * D, block=block)
    jm, tm = _models(W, block)
    x = _requests(6, D, seed=k)
    x[0] = 0.0                                  # every label ties at 0.0
    v_j, i_j = jax_bsr_ops.bsr_predict_topk(jnp.asarray(x), jm, k,
                                            n_labels=L, interpret=True)
    v_t, i_t = bsr_ops.bsr_predict_topk(torch.from_numpy(x), tm, k,
                                        n_labels=L)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    np.testing.assert_allclose(_np(v_t), np.asarray(v_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(_np(i_t)[0], np.arange(k))


def test_padding_labels_never_returned():
    """Block padding scores 0.0 before the mask; with every real score
    negative it would win the top-k unless masked to NEG_INF."""
    L, D, k = 20, 48, 5
    W = -np.abs(np.random.default_rng(0).normal(size=(L, D))).astype(
        np.float32)
    jm, tm = _models(W, (16, 16))
    x = np.abs(np.random.default_rng(1).normal(size=(3, D))).astype(
        np.float32)
    _, i_t = bsr_ops.bsr_predict_topk(torch.from_numpy(x), tm, k,
                                      n_labels=L)
    _, i_j = jax_bsr_ops.bsr_predict_topk(jnp.asarray(x), jm, k,
                                          n_labels=L, interpret=True)
    assert _np(i_t).max() < L
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))


def test_fully_pruned_sentinel_predicts_zero():
    """One zero block and row_ptr all zeros: every score is exact 0.0 and
    the top-k is labels 0..k-1, as in the JAX package."""
    W = np.zeros((40, 50), np.float32)
    jm, tm = _models(W, (16, 16))
    assert tm.n_blocks == 1 and int(tm.row_ptr.abs().sum()) == 0
    x = np.ones((2, 50), np.float32)
    out = _np(bsr_ops.bsr_predict(torch.from_numpy(x), tm))
    assert out.shape == (2, 48) and np.all(out == 0.0)
    _, i_t = bsr_ops.bsr_predict_topk(torch.from_numpy(x), tm, 3,
                                      n_labels=40)
    _, i_j = jax_bsr_ops.bsr_predict_topk(jnp.asarray(x), jm, 3,
                                          n_labels=40, interpret=True)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(_np(i_t), [[0, 1, 2], [0, 1, 2]])


def test_wider_request_than_model_raises():
    W = _sparse_W(32, 40, 0.5, seed=1, block=(16, 16))
    _, tm = _models(W, (16, 16))                 # Dp = 48
    with pytest.raises(ValueError, match="exceeds the model's padded"):
        bsr_ops.bsr_predict(torch.zeros((1, 49)), tm)
    with pytest.raises(ValueError, match="exceeds the model's padded"):
        bsr_ops.bsr_predict_topk(torch.zeros((1, 49)), tm, 2)
    # D between the true and the padded width is accepted (zero-padded).
    assert bsr_ops.bsr_predict(torch.zeros((1, 48)), tm).shape == (1, 32)


def test_flop_and_byte_accounting_matches_jax():
    W = _sparse_W(128, 256, 0.3, seed=5, block=(32, 32))
    jm, tm = _models(W, (32, 32))
    for n in (1, 32, 256):
        assert bsr_ops.model_flops(tm, n) == jax_bsr_ops.model_flops(jm, n)
        assert bsr_ops.predict_bytes(tm, n) == jax_bsr_ops.predict_bytes(jm,
                                                                         n)


def test_wrappers_raise_on_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a card is
    refused by the kernel wrappers."""
    s = torch.zeros((2, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        topk_ops.topk(s, 3, bL=128)
    W = _sparse_W(32, 32, 1.0, seed=2, block=(16, 16))
    _, tm = _models(W, (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        bsr_ops.bsr_predict_cuda(torch.zeros((1, 32), device="meta"),
                                 tm.blocks, tm.block_cols, tm.row_ptr, 2)
