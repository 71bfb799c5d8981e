"""The port's plain solver ops (`repro_torch.core.losses`) against the JAX
package's `repro.core.losses`, on the CPU, at (L, N, D) that are multiples
of nothing useful.

Inputs are made from a seed with numpy and handed to both. Tolerance:
rtol 1e-5 with atol 1e-5 for f, grad, Hv and the margins (both sides sum
the same fp32 products in another order, XLA's CPU matmul against
PyTorch's); the active mask is identical wherever |z| > 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import losses as jax_losses
from repro_torch.core import losses

SHAPES = [(3, 7, 5), (13, 130, 257), (130, 61, 300), (1, 1, 1)]
C = 0.8


def _inputs(L, N, D, seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((N, D)) * (rng.random((N, D)) < 0.3)).astype(np.float32)
    S = np.where(rng.random((L, N)) < 0.3, 1.0, -1.0).astype(np.float32)
    W = rng.normal(size=(L, D)).astype(np.float32)
    V = rng.normal(size=(L, D)).astype(np.float32)
    return W, X, S, V


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L,N,D", SHAPES)
def test_objective_grad_act_matches_jax(L, N, D):
    W, X, S, _ = _inputs(L, N, D, L + N + D)
    f, g, act = losses.objective_grad_act(*map(torch.from_numpy, (W, X, S)),
                                          C)
    fj, gj, actj = jax_losses.objective_grad_act(
        *map(jnp.asarray, (W, X, S)), C)
    _close(f, fj)
    _close(g, gj)
    z = np.asarray(jax_losses.margins(*map(jnp.asarray, (W, X, S))))
    decided = np.abs(z) > 1e-5
    np.testing.assert_array_equal(act.numpy()[decided],
                                  np.asarray(actj)[decided])


@pytest.mark.parametrize("L,N,D", SHAPES)
def test_margins_mask_objective_match_jax(L, N, D):
    W, X, S, _ = _inputs(L, N, D, 7 * L + D)
    Wt, Xt, St = map(torch.from_numpy, (W, X, S))
    Wj, Xj, Sj = map(jnp.asarray, (W, X, S))
    z = losses.margins(Wt, Xt, St)
    _close(z, jax_losses.margins(Wj, Xj, Sj))
    decided = np.abs(z.numpy()) > 1e-5
    np.testing.assert_array_equal(
        losses.active_mask(Wt, Xt, St).numpy()[decided],
        np.asarray(jax_losses.active_mask(Wj, Xj, Sj))[decided])
    _close(losses.objective(Wt, Xt, St, C),
           jax_losses.objective(Wj, Xj, Sj, C))
    # objective == the f of objective_grad_act (the mask form of the sum)
    _close(losses.objective(Wt, Xt, St, C),
           losses.objective_grad_act(Wt, Xt, St, C)[0])


@pytest.mark.parametrize("L,N,D", SHAPES)
def test_hessian_vp_matches_jax(L, N, D):
    W, X, S, V = _inputs(L, N, D, 3 * N + 1)
    _, _, act = jax_losses.objective_grad_act(*map(jnp.asarray, (W, X, S)),
                                              C)
    act = np.array(act)
    hv = losses.hessian_vp(*map(torch.from_numpy, (V, X, act)), C)
    _close(hv, jax_losses.hessian_vp(*map(jnp.asarray, (V, X, act)), C))


def test_hessian_is_the_gradients_derivative():
    """Away from the hinge's kink, g(W + t V) - g(W) = t H V for small t."""
    W, X, S, V = _inputs(4, 50, 20, 0)
    Wt, Xt, St, Vt = (torch.from_numpy(a).double() for a in (W, X, S, V))
    _, g0, act = losses.objective_grad_act(Wt, Xt, St, C)
    t = 1e-6
    _, g1, act1 = losses.objective_grad_act(Wt + t * Vt, Xt, St, C)
    assert torch.equal(act, act1)
    torch.testing.assert_close((g1 - g0) / t,
                               losses.hessian_vp(Vt, Xt, act, C),
                               rtol=1e-5, atol=1e-5)
