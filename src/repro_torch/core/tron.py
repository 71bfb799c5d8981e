"""Batched trust-region Newton (TRON) solver for DiSMEC's per-label
problems.

Liblinear solves each binary problem with TRON [Lin, Weng, Keerthi 2008]:
an outer trust-region Newton loop whose steps come from Steihaug-Toint
truncated conjugate gradient on the generalized Hessian. Here a whole label
batch is solved by ONE batched loop: every per-label scalar of the
classical algorithm (trust radius, CG residuals, convergence flag) is a
vector of length L, and labels that are done become masked no-ops instead
of leaving the loop. The masking is the JAX package's `core/tron.py`
exactly (every `jnp.where` nesting kept), so the per-label counters
`n_newton` and `n_cg` come out the same.

The solver does not know how X is laid out: callers pass
`obj_grad_fn(W) -> (f, grad, act_aux)` and `hvp_fn(V, act_aux) -> H V`.
`act_aux` is the active-set payload (a tensor, or a tuple of tensors, each
leading with the label axis) that `obj_grad_fn` derived from the score pass
it already ran; it rides the Newton loop and is handed back to every
Hessian product at the same iterate, so CG runs one score-shaped
contraction per iteration. On a rejected step the incumbent's payload is
kept, on acceptance the trial's.

`lax.while_loop` becomes a Python loop. Its condition is the one thing that
leaves the card: one bool per CG iteration ("some label still iterating")
and one per Newton iteration ("some label still live"). At the trainer's
shape one Hessian product is about 88 ms of fp32 work on an H100, so
reading one bool costs far less than running masked iterations past the
point where every label is done. Nothing else is read back inside a solve.
While a profiler records, each Newton iteration is a `tron.newton` span
(`repro_torch.obs`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import obs

# Liblinear's trust-region constants.
ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


class TronResult(NamedTuple):
    W: torch.Tensor            # (L, D) solution
    f: torch.Tensor            # (L,) final objective
    gnorm: torch.Tensor        # (L,) final gradient norm
    n_newton: torch.Tensor     # (L,) int32 Newton iterations used
    n_cg: torch.Tensor         # (L,) int32 total CG iterations used
    converged: torch.Tensor    # (L,) bool


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _boundary_tau(d: torch.Tensor, p: torch.Tensor,
                  delta: torch.Tensor) -> torch.Tensor:
    """Smallest tau >= 0 with ||d + tau p|| = delta, batched over labels:
    the positive root of ||p||^2 tau^2 + 2<d,p> tau + ||d||^2 - delta^2."""
    pp = _rowdot(p, p)
    dp = _rowdot(d, p)
    dd = _rowdot(d, d)
    rad = torch.sqrt(torch.clamp_min(dp * dp + pp * (delta * delta - dd),
                                     0.0))
    tau = torch.where(dp >= 0.0,
                      (delta * delta - dd) / (dp + rad + 1e-38),
                      (rad - dp) / (pp + 1e-38))
    return torch.clamp_min(tau, 0.0)


def _steihaug_cg(hvp: Callable[[torch.Tensor], torch.Tensor],
                 g: torch.Tensor, delta: torch.Tensor, cg_tol: torch.Tensor,
                 max_cg: int, live: torch.Tensor):
    """Batched Steihaug-Toint CG: approximately solve H d = -g with
    ||d|| <= delta. Labels not `live` are born done and do no work (their
    updates are masked; the loop runs in lockstep). Returns (d, iterations
    used per label)."""
    L = g.shape[0]
    d = torch.zeros_like(g)
    r = -g
    p = r
    rtr = _rowdot(r, r)
    done = ~live
    iters = torch.zeros((L,), dtype=torch.int32, device=g.device)
    k = 0
    while k < max_cg and not bool(done.all()):     # one bool per iteration
        Hp = hvp(p)
        pHp = _rowdot(p, Hp)
        alpha = rtr / torch.where(pHp != 0.0, pHp, 1.0)
        neg_curv = pHp <= 0.0

        d_try = d + alpha[:, None] * p
        over = torch.sqrt(_rowdot(d_try, d_try)) >= delta
        hit_boundary = (neg_curv | over) & ~done

        tau = _boundary_tau(d, p, delta)
        d_bound = d + tau[:, None] * p

        d_new = torch.where(done[:, None], d,
                            torch.where(hit_boundary[:, None], d_bound,
                                        d_try))
        r_new = torch.where((done | hit_boundary)[:, None], r,
                            r - alpha[:, None] * Hp)
        rtr_new = _rowdot(r_new, r_new)
        small = torch.sqrt(rtr_new) <= cg_tol
        done_new = done | hit_boundary | small

        beta = rtr_new / torch.where(rtr != 0.0, rtr, 1.0)
        p = torch.where(done_new[:, None], p, r_new + beta[:, None] * p)
        iters = iters + (~done).to(torch.int32)
        d, r, rtr, done = d_new, r_new, rtr_new, done_new
        k += 1
    return d, iters


def _select_aux(accept: torch.Tensor, new, old):
    """Per-label select over the active-set payload: a tensor or a tuple of
    tensors, each leading with the label axis (on a mesh with
    `shard_data`, each on its own data device)."""
    def sel(a, b):
        acc = accept.to(a.device).reshape(
            accept.shape + (1,) * (a.dim() - 1))
        return torch.where(acc, a, b)
    if isinstance(new, tuple):
        return tuple(sel(a, b) for a, b in zip(new, old))
    return sel(new, old)


def tron_solve(obj_grad_fn: Callable, hvp_fn: Callable, W0: torch.Tensor,
               *, eps: float = 0.01, max_newton: int = 50, max_cg: int = 40,
               gnorm_ref: Optional[torch.Tensor] = None) -> TronResult:
    """Solve min_w f_l(w_l) for all labels l at once.

    obj_grad_fn(W) -> (f, grad, act_aux): objective, gradient and the
        active-set payload at W, which is cached and handed to every
        Hessian product at the same iterate (see the module docstring).
    hvp_fn(V, act_aux) -> H V using the cached active set.
    eps: relative gradient-norm tolerance, ||g|| <= eps * ||g_0||.
    gnorm_ref: optional (L,) anchor of the relative tolerance in place of
        ||g(W0)||. A warm start (W0 from a prior checkpoint) keeps the
        cold-start stopping rule eps * ||g(0)||; otherwise the warm
        iterate's small gradient would tighten the tolerance and drive
        converged labels through extra Newton steps.
    """
    L = W0.shape[0]
    f, g, act = obj_grad_fn(W0)
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    delta = gnorm                              # liblinear: Delta_0 = ||g_0||
    gref = gnorm if gnorm_ref is None else gnorm_ref
    tol = eps * gref
    W = W0
    live = gnorm > tol
    zeros = torch.zeros((L,), dtype=torch.int32, device=W0.device)
    n_newton, n_cg = zeros, zeros.clone()
    k = 0
    while k < max_newton and bool(live.any()):    # one bool per iteration
        with obs.span("tron.newton"):
            cg_tol = torch.clamp(torch.sqrt(gnorm / (gref + 1e-38)),
                                 max=0.1) * gnorm
            act_now = act
            d, cg_iters = _steihaug_cg(lambda V: hvp_fn(V, act_now), g, delta,
                                       cg_tol, max_cg, live)

            W_try = W + d
            f_try, g_try, act_try = obj_grad_fn(W_try)

            # Quadratic-model decrease -(<g,d> + 0.5 <d, H d>), H at W, cached
            Hd = hvp_fn(d, act)
            pred = -(_rowdot(g, d) + 0.5 * _rowdot(d, Hd))
            actual = f - f_try
            rho = actual / torch.where(pred != 0.0, pred, 1.0)

            accept = (rho > ETA0) & live
            dnorm = torch.linalg.vector_norm(d, dim=-1)

            # Trust-radius update (liblinear schedule).
            delta_new = torch.where(
                rho < ETA0, SIGMA1 * torch.minimum(dnorm, delta),
                torch.where(
                    rho < ETA1, torch.maximum(SIGMA1 * delta, SIGMA2 * dnorm),
                    torch.where(rho < ETA2, delta,
                                torch.maximum(delta, SIGMA3 * dnorm))))
            delta = torch.where(live, delta_new, delta)

            W = torch.where(accept[:, None], W_try, W)
            act = _select_aux(accept, act_try, act)
            f = torch.where(accept, f_try, f)
            g = torch.where(accept[:, None], g_try, g)
            gnorm = torch.linalg.vector_norm(g, dim=-1)
            # A label that entered this iteration live did one more Newton
            # step; labels done earlier are masked no-ops and do not count.
            n_newton = n_newton + live.to(torch.int32)
            n_cg = n_cg + cg_iters
            live = live & (gnorm > tol)
        k += 1
    return TronResult(W=W, f=f, gnorm=gnorm, n_newton=n_newton, n_cg=n_cg,
                      converged=~live)
