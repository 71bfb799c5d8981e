"""The port's l1 losses, model statistics and `dense_flops` against the JAX
package's, on the CPU: `core/losses.py`'s `objective_and_grad`,
`l1_objective_smooth_part`, `l1_grad_smooth_part` and `soft_threshold`;
`core/pruning.py`'s `nnz`, `sparsity`, `ambiguous_fraction` and
`weight_histogram` (Fig. 2's statistics); `kernels/bsr_predict/ops.py`'s
`dense_flops`.

Inputs are made from a seed with numpy and handed to both. Tolerances:
the losses within rtol 1e-5 and atol 1e-5 (the same fp32 products summed
in another order); `soft_threshold`, `nnz`, `sparsity`,
`ambiguous_fraction` and `dense_flops` exactly; histogram counts equal,
except that a value within an ulp of a bin edge may fall on the other
side of it: `torch.linspace` and `jnp.linspace` round an edge apart by up
to two ulps of `lim` (measured: 59 of the 82 edges of [-0.2, 0.2] differ,
by at most 1.49e-8, one ulp of 0.2; the middle edge of [-0.05, 0.05] by
7.45e-9, two ulps of 0.05), and a value between the two is within an ulp
of one of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import losses as jax_losses
from repro.core import pruning as jax_pruning
from repro.kernels.bsr_predict import ops as jax_bsr_ops
from repro_torch import core
from repro_torch.core import losses, pruning
from repro_torch.kernels.bsr_predict import ops as bsr_ops

SHAPES = [(3, 7, 5), (13, 130, 257), (64, 300, 1024), (1, 1, 1)]
C = 0.8


def _inputs(L, N, D, seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((N, D)) * (rng.random((N, D)) < 0.3)).astype(np.float32)
    S = np.where(rng.random((L, N)) < 0.3, 1.0, -1.0).astype(np.float32)
    W = (0.05 * rng.normal(size=(L, D))).astype(np.float32)
    return W, X, S


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


def _weights(seed, shape=(64, 1024), scale=0.05):
    """Weights as training leaves them: mostly small, some exact zeros,
    a few outside [-0.2, 0.2], and values on the histogram's edges."""
    rng = np.random.default_rng(seed)
    W = (scale * rng.standard_t(3, size=shape)).astype(np.float32)
    W[rng.random(shape) < 0.3] = 0.0
    edges = np.linspace(-0.2, 0.2, 82).astype(np.float32)
    flat = W.reshape(-1)
    flat[:82] = edges
    flat[82:84] = (-0.2, 0.2)
    return W


@pytest.mark.parametrize("L,N,D", SHAPES)
def test_objective_and_grad_matches_jax(L, N, D):
    W, X, S = _inputs(L, N, D, L + N + D)
    f, g = losses.objective_and_grad(*map(torch.from_numpy, (W, X, S)), C)
    fj, gj = jax_losses.objective_and_grad(*map(jnp.asarray, (W, X, S)), C)
    _close(f, fj)
    _close(g, gj)


@pytest.mark.parametrize("L,N,D", SHAPES)
def test_l1_smooth_part_matches_jax(L, N, D):
    W, X, S = _inputs(L, N, D, 3 * L + D)
    args = tuple(map(torch.from_numpy, (W, X, S)))
    jargs = tuple(map(jnp.asarray, (W, X, S)))
    _close(losses.l1_objective_smooth_part(*args, C),
           jax_losses.l1_objective_smooth_part(*jargs, C))
    _close(losses.l1_grad_smooth_part(*args, C),
           jax_losses.l1_grad_smooth_part(*jargs, C))


@pytest.mark.parametrize("tau", [0.0, 0.01, 0.05, np.float32(0.0123)])
def test_soft_threshold_matches_jax_exactly(tau):
    W = _weights(1)
    got = losses.soft_threshold(torch.from_numpy(W), tau)
    want = np.asarray(jax_losses.soft_threshold(jnp.asarray(W), tau))
    np.testing.assert_array_equal(got.numpy(), want)
    # A 0-d float32 tensor tau (the FISTA step times lam) gives the same.
    t = torch.tensor(tau, dtype=torch.float32)
    np.testing.assert_array_equal(
        losses.soft_threshold(torch.from_numpy(W), t).numpy(),
        np.asarray(jax_losses.soft_threshold(jnp.asarray(W),
                                             jnp.float32(tau))))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delta", [0.01, 0.05])
def test_sparsity_statistics_match_jax_exactly(seed, delta):
    W = _weights(seed)
    Wt, Wj = torch.from_numpy(W), jnp.asarray(W)
    assert int(pruning.nnz(Wt)) == int(jax_pruning.nnz(Wj))
    assert float(pruning.sparsity(Wt)) == float(jax_pruning.sparsity(Wj))
    assert float(pruning.ambiguous_fraction(Wt, delta)) == \
        float(jax_pruning.ambiguous_fraction(Wj, delta))
    # The pruned model: every weight below delta is zero.
    P = pruning.prune(Wt, delta)
    assert float(pruning.ambiguous_fraction(P, delta)) == \
        float(pruning.sparsity(P))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bins,lim", [(81, 0.2), (10, 0.05), (1, 0.3)])
def test_weight_histogram_matches_jax(seed, bins, lim):
    W = _weights(seed)
    counts, edges = pruning.weight_histogram(torch.from_numpy(W), bins, lim)
    cj, ej = jax_pruning.weight_histogram(jnp.asarray(W), bins, lim)
    ej = np.asarray(ej)
    assert counts.dtype == torch.int64 and counts.shape == (bins,)
    ulp = float(np.spacing(np.float32(lim)))
    np.testing.assert_allclose(edges.numpy(), ej, rtol=0, atol=2 * ulp)
    # Values within an ulp of an edge of either side may land apart; every
    # other value is in the same bin on both sides.
    e = np.union1d(edges.numpy(), ej)
    v = W.reshape(-1)
    near = np.abs(v[:, None] - e[None, :]) <= ulp
    n_near = int(near.any(axis=1).sum())
    diff = np.abs(counts.numpy() - np.asarray(cj, np.int64))
    assert int(diff.sum()) <= 2 * n_near, (diff, n_near)
    # Away from the edges the counts are equal.
    far = ~near.any(axis=1)
    c_far, _ = pruning.weight_histogram(torch.from_numpy(v[far]), bins, lim)
    cj_far, _ = jax_pruning.weight_histogram(jnp.asarray(v[far]), bins, lim)
    np.testing.assert_array_equal(c_far.numpy(), np.asarray(cj_far, np.int64))


def test_weight_histogram_bins_are_half_open_the_last_closed():
    edges = torch.linspace(-1.0, 1.0, 5)
    W = torch.cat([edges, torch.tensor([-1.5, 1.5, 0.1])])
    counts, _ = pruning.weight_histogram(W, bins=4, lim=1.0)
    # [-1, -.5) [-.5, 0) [0, .5) [.5, 1]: each edge starts its bin, 1.0
    # falls in the last, +-1.5 nowhere.
    assert counts.tolist() == [1, 1, 2, 2]
    cj, _ = jax_pruning.weight_histogram(jnp.asarray(W.numpy()), 4, 1.0)
    assert np.asarray(cj, np.int64).tolist() == counts.tolist()


def test_core_exports_the_statistics():
    for name in ("nnz", "sparsity", "ambiguous_fraction",
                 "weight_histogram", "prune"):
        assert getattr(core, name) is getattr(pruning, name)
        assert name in core.__all__


@pytest.mark.parametrize("L,D,block,n", [(300, 520, (16, 16), 7),
                                         (256, 1024, (128, 128), 64),
                                         (90, 300, (8, 32), 1)])
def test_dense_flops_matches_jax(L, D, block, n):
    W = _weights(L + D, (L, D))
    model = pruning.to_block_sparse(W, block, device="cpu")
    jmodel = jax_pruning.to_block_sparse(W, block)
    assert bsr_ops.dense_flops(model, n) == jax_bsr_ops.dense_flops(jmodel, n)
    assert bsr_ops.dense_flops(model, n) >= bsr_ops.model_flops(model, n)
