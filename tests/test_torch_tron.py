"""The port's batched TRON (`repro_torch.core.tron`) against the JAX
package's (`repro.core.tron`), on the CPU, on the same numpy problems.

Both solvers run the same masked algorithm; the port's loops are Python
loops over the same `where` nestings. Held: per-label `n_newton`, `n_cg`
and `converged` equal; W and f within rtol 1e-4, atol 1e-5 (the same fp32
arithmetic in another order, compounded over the Newton steps). The port
runs with both of its solver-ops kinds ("jnp", the plain ops, and
"pallas", whose wrappers take their plain versions on CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dismec as jax_dismec
from repro.core import losses as jax_losses
from repro.core import tron as jax_tron
from repro_torch.convert import tron_result_from_numpy, warm_start_from_numpy
from repro_torch.core import dismec, losses, tron

KINDS = ["jnp", "pallas"]


def _problem(L, N, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    X = (scale * rng.normal(size=(N, D))).astype(np.float32)
    S = np.sign(rng.normal(size=(L, N))).astype(np.float32)
    return X, S


@pytest.fixture(scope="module", params=[(12, 96, 48, 0), (20, 150, 300, 1)],
                ids=["small", "wide"])
def problem(request):
    L, N, D, seed = request.param
    X, S = _problem(L, N, D, seed, scale=0.3)
    cfg = dict(C=1.0, eps=1e-3, max_newton=30, max_cg=25)
    ref = jax_dismec.train_label_batch(
        jnp.asarray(X), jnp.asarray(S), jax_dismec.DiSMECConfig(**cfg))
    return X, S, cfg, {k: np.array(v) for k, v in ref._asdict().items()}


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.n_newton.numpy(), ref["n_newton"])
    np.testing.assert_array_equal(res.n_cg.numpy(), ref["n_cg"])
    np.testing.assert_array_equal(res.converged.numpy(), ref["converged"])
    np.testing.assert_allclose(res.W.numpy(), ref["W"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.f.numpy(), ref["f"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_counters_and_solution_match_jax(problem, kind):
    X, S, cfg, ref = problem
    res = dismec.train_label_batch(torch.from_numpy(X), torch.from_numpy(S),
                                   dismec.DiSMECConfig(ops=kind, **cfg))
    assert res.n_newton.dtype == res.n_cg.dtype == torch.int32
    assert ref["n_newton"].min() < ref["n_newton"].max() or \
        ref["n_cg"].min() < ref["n_cg"].max()           # labels differ
    _assert_same(res, ref)


@pytest.mark.parametrize("max_newton,max_cg", [(2, 3), (4, 1)])
def test_cut_loops_match_jax(max_newton, max_cg):
    """Loops stopped by their iteration caps, not by convergence."""
    X, S = _problem(9, 70, 33, 3)
    cfg = dict(C=2.0, eps=1e-4, max_newton=max_newton, max_cg=max_cg)
    ref = jax_dismec.train_label_batch(
        jnp.asarray(X), jnp.asarray(S), jax_dismec.DiSMECConfig(**cfg))
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert not ref["converged"].all()
    res = dismec.train_label_batch(torch.from_numpy(X), torch.from_numpy(S),
                                   dismec.DiSMECConfig(**cfg))
    _assert_same(res, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_warm_start_with_gnorm_ref_matches_jax(problem, kind):
    """Warm start half-way to the solution, the tolerance anchored at
    ||g(0)||: the same counters and solution as the JAX solver."""
    X, S, cfg, ref = problem
    W0 = (0.5 * ref["W"]).astype(np.float32)
    jcfg = jax_dismec.DiSMECConfig(**cfg)
    want = jax_dismec.train_label_batch(jnp.asarray(X), jnp.asarray(S), jcfg,
                                        W0=jnp.asarray(W0))
    res = dismec.train_label_batch(
        torch.from_numpy(X), torch.from_numpy(S),
        dismec.DiSMECConfig(ops=kind, **cfg),
        W0=warm_start_from_numpy(W0, device="cpu"))
    _assert_same(res, {k: np.asarray(v) for k, v in want._asdict().items()})


def test_dead_labels_do_no_work(problem):
    """Labels that start converged (the warm start is the solution, the
    tolerance the cold one) are masked no-ops: no Newton or CG step is
    counted and their weights come back bit for bit."""
    X, S, cfg, ref = problem
    Xt, St = torch.from_numpy(X), torch.from_numpy(S)
    L, D = S.shape[0], X.shape[1]
    W0 = torch.from_numpy(ref["W"]).clone()
    W0[L // 2:] = 0.0                       # the other half starts cold
    og = lambda W: losses.objective_grad_act(W, Xt, St, cfg["C"])  # noqa
    hv = lambda V, a: losses.hessian_vp(V, Xt, a, cfg["C"])        # noqa
    _, g_zero, _ = og(torch.zeros((L, D)))
    gref = torch.linalg.vector_norm(g_zero, dim=-1)
    _, g_warm, _ = og(W0)
    dead = torch.linalg.vector_norm(g_warm, dim=-1) <= cfg["eps"] * gref
    assert bool(dead[:L // 2].all()) and not bool(dead[L // 2:].any())
    res = tron.tron_solve(og, hv, W0, eps=cfg["eps"],
                          max_newton=cfg["max_newton"],
                          max_cg=cfg["max_cg"], gnorm_ref=gref)
    assert not res.n_newton[dead].any() and not res.n_cg[dead].any()
    assert torch.equal(res.W[dead], W0[dead])
    assert bool(res.converged.all()) and bool((res.n_newton[~dead] > 0).all())


def test_all_negative_label_goes_to_zero_weight():
    """A padding label (all signs -1) over mild instances stays near w = 0
    (the scheduler pads partial batches with such labels)."""
    rng = np.random.default_rng(4)
    X = torch.from_numpy((rng.normal(size=(64, 16)) * 0.01)
                         .astype(np.float32))
    S = -torch.ones((1, 64))
    res = dismec.train_label_batch(X, S, dismec.DiSMECConfig())
    assert float(torch.linalg.vector_norm(res.W)) < 0.5
    want = jax_dismec.train_label_batch(jnp.asarray(X.numpy()),
                                        jnp.asarray(S.numpy()),
                                        jax_dismec.DiSMECConfig())
    np.testing.assert_allclose(res.W.numpy(), np.asarray(want.W), rtol=1e-4,
                               atol=1e-6)


def test_boundary_tau_matches_jax():
    rng = np.random.default_rng(8)
    d, p = (rng.normal(size=(50, 7)).astype(np.float32) for _ in range(2))
    delta = (np.abs(rng.normal(size=50)) * 3).astype(np.float32)
    delta[:5] = 0.0
    got = tron._boundary_tau(*map(torch.from_numpy, (d, p, delta)))
    want = jax_tron._boundary_tau(*map(jnp.asarray, (d, p, delta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert bool((got >= 0).all())


def test_select_aux_over_a_tuple_payload():
    accept = torch.tensor([True, False, True])
    new = (torch.ones((3, 4)), torch.full((3,), 2.0))
    old = (torch.zeros((3, 4)), torch.full((3,), 5.0))
    a, b = tron._select_aux(accept, new, old)
    assert a[:, 0].tolist() == [1.0, 0.0, 1.0]
    assert b.tolist() == [2.0, 5.0, 2.0]
    assert torch.equal(tron._select_aux(accept, new[0], old[0]), a)


def test_tron_result_from_numpy(problem):
    _, _, _, ref = problem
    res = tron_result_from_numpy(ref, device="cpu")
    assert res.n_cg.dtype == torch.int32 and res.converged.dtype == torch.bool
    np.testing.assert_array_equal(res.W.numpy(), ref["W"])


def test_margin_cache_matches_recomputing_the_mask(problem):
    """Threading the cached mask gives the same result as re-deriving it
    from W at every Hessian product (the legacy protocol, emulated by
    passing W itself as the payload)."""
    X, S, cfg, _ = problem
    Xt, St = torch.from_numpy(X), torch.from_numpy(S)
    C = cfg["C"]
    cached = tron.tron_solve(
        lambda W: losses.objective_grad_act(W, Xt, St, C),
        lambda V, a: losses.hessian_vp(V, Xt, a, C),
        torch.zeros((S.shape[0], X.shape[1])), eps=cfg["eps"])

    def og_legacy(W):
        f, g, _ = losses.objective_grad_act(W, Xt, St, C)
        return f, g, W

    legacy = tron.tron_solve(
        og_legacy,
        lambda V, W: losses.hessian_vp(V, Xt, losses.active_mask(W, Xt, St),
                                       C),
        torch.zeros((S.shape[0], X.shape[1])), eps=cfg["eps"])
    assert torch.equal(cached.W, legacy.W)
    assert torch.equal(cached.n_cg, legacy.n_cg)
