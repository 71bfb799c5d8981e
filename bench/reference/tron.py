"""Reference DiSMEC solve of a set of labels: the squared-hinge one-vs-rest
objective (paper Eq. 2.2), liblinear's trust-region Newton method with
Steihaug-Toint CG, batched over labels with per-label masks, and
Delta-pruning (Algorithm 1, step 7). Written from the algorithm, in plain
fp32 products with TF32 off; "tf32" rounds every product's operands.

The numbers compare a program's solved, pruned rows with the reference's
on the same labels, through the objective both are meant to minimise.
"""

from __future__ import annotations

import torch

from bench.reference import fp32_products, tf32

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


class Problem:
    """f(w) = ||w||^2 + C sum_i max(0, 1 - s_i w.x_i)^2 for each label's
    signs s (rows of S), over one X."""

    def __init__(self, X: torch.Tensor, S: torch.Tensor, C: float,
                 precision: str = "fp32"):
        self.C = C
        self.rounded = precision == "tf32"
        self.X = tf32(X) if self.rounded else X
        self.S = S

    def _mm(self, a, b):
        return (tf32(a) if self.rounded else a) @ b

    def obj_grad(self, W):
        scores = self._mm(W, self.X.T)
        z = 1.0 - self.S * scores
        act = (z > 0.0).float()
        r = act * (scores - self.S)
        f = (W * W).sum(-1) + self.C * (act * z * z).sum(-1)
        grad = 2.0 * W + 2.0 * self.C * self._mm(r, self.X)
        return f, grad, act

    def hvp(self, V, act):
        u = act * self._mm(V, self.X.T)
        return 2.0 * V + 2.0 * self.C * self._mm(u, self.X)


def _dot(a, b):
    return (a * b).sum(-1)


def _cg(hvp, g, delta, tol, max_cg, live):
    d = torch.zeros_like(g)
    r = -g
    p = r
    rtr = _dot(r, r)
    done = ~live
    k = 0
    while k < max_cg and not bool(done.all()):
        Hp = hvp(p)
        pHp = _dot(p, Hp)
        alpha = rtr / torch.where(pHp != 0.0, pHp, 1.0)
        d_try = d + alpha[:, None] * p
        hit = ((pHp <= 0.0) | (torch.sqrt(_dot(d_try, d_try)) >= delta)) \
            & ~done
        # tau >= 0 with ||d + tau p|| = delta
        pp, dp, dd = _dot(p, p), _dot(d, p), _dot(d, d)
        rad = torch.sqrt(torch.clamp_min(dp * dp + pp * (delta * delta - dd),
                                         0.0))
        tau = torch.clamp_min(torch.where(
            dp >= 0.0, (delta * delta - dd) / (dp + rad + 1e-38),
            (rad - dp) / (pp + 1e-38)), 0.0)
        d_new = torch.where(done[:, None], d, torch.where(
            hit[:, None], d + tau[:, None] * p, d_try))
        r_new = torch.where((done | hit)[:, None], r, r - alpha[:, None] * Hp)
        rtr_new = _dot(r_new, r_new)
        done_new = done | hit | (torch.sqrt(rtr_new) <= tol)
        beta = rtr_new / torch.where(rtr != 0.0, rtr, 1.0)
        p = torch.where(done_new[:, None], p, r_new + beta[:, None] * p)
        d, r, rtr, done = d_new, r_new, rtr_new, done_new
        k += 1
    return d


def solve(problem: Problem, n_labels: int, D: int, *, eps: float,
          max_newton: int, max_cg: int, delta: float) -> torch.Tensor:
    """TRON from W = 0 to ||g|| <= eps ||g(0)|| per label, then prune:
    the (n_labels, D) rows DiSMEC returns for these labels."""
    with fp32_products():
        W = torch.zeros((n_labels, D), dtype=torch.float32,
                        device=problem.X.device)
        f, g, act = problem.obj_grad(W)
        gnorm = torch.linalg.vector_norm(g, dim=-1)
        gref, radius, tol = gnorm, gnorm, eps * gnorm
        live = gnorm > tol
        k = 0
        while k < max_newton and bool(live.any()):
            cg_tol = torch.clamp(torch.sqrt(gnorm / (gref + 1e-38)),
                                 max=0.1) * gnorm
            act_now = act
            d = _cg(lambda V: problem.hvp(V, act_now), g, radius, cg_tol,
                    max_cg, live)
            f_try, g_try, act_try = problem.obj_grad(W + d)
            pred = -(_dot(g, d) + 0.5 * _dot(d, problem.hvp(d, act)))
            rho = (f - f_try) / torch.where(pred != 0.0, pred, 1.0)
            accept = (rho > ETA0) & live
            dnorm = torch.linalg.vector_norm(d, dim=-1)
            new_radius = torch.where(
                rho < ETA0, SIGMA1 * torch.minimum(dnorm, radius),
                torch.where(rho < ETA1,
                            torch.maximum(SIGMA1 * radius, SIGMA2 * dnorm),
                            torch.where(rho < ETA2, radius,
                                        torch.maximum(radius,
                                                      SIGMA3 * dnorm))))
            radius = torch.where(live, new_radius, radius)
            W = torch.where(accept[:, None], W + d, W)
            act = torch.where(accept[:, None], act_try, act)
            f = torch.where(accept, f_try, f)
            g = torch.where(accept[:, None], g_try, g)
            gnorm = torch.linalg.vector_norm(g, dim=-1)
            live = live & (gnorm > tol)
            k += 1
        return torch.where(W.abs() < delta, torch.zeros_like(W), W)


def numbers(W_prog: torch.Tensor, W_ref: torch.Tensor,
            problem: Problem) -> dict:
    """The program's rows against the reference's, label by label (each
    number the worst label's):

    f_gap : |f(W_prog) - f(W_ref)| / f(W_ref), both pruned;
    w_gap : ||W_prog - W_ref|| / ||W_ref||;
    g_rel : ||grad f(W_prog)|| / ||grad f(0)||, how far the program's
            pruned rows are from a stationary point;
    nnz_gap : |nnz(W_prog) - nnz(W_ref)| / nnz(W_ref);
    score_gap : the largest |x_i . (w_prog - w_ref)| over the labels and
            every training instance: how far a served score would move.
    """
    with fp32_products():
        f_p, g_p, _ = problem.obj_grad(W_prog)
        f_r, _, _ = problem.obj_grad(W_ref)
        _, g0, _ = problem.obj_grad(torch.zeros_like(W_ref))
        score_gap = (problem.X @ (W_prog - W_ref).T).abs().amax()
    norm = torch.linalg.vector_norm
    w_gap = norm(W_prog - W_ref, dim=-1) / norm(W_ref, dim=-1).clamp_min(
        1e-30)
    nnz_p = (W_prog != 0).sum(-1).float()
    nnz_r = (W_ref != 0).sum(-1).float().clamp_min(1.0)
    return {"f_gap": float(((f_p - f_r).abs() / f_r).max()),
            "w_gap": float(w_gap.max()),
            "w_gap_median": float(w_gap.median()),
            "g_rel": float((norm(g_p, dim=-1) / norm(g0, dim=-1)).max()),
            "nnz_gap": float(((nnz_p - nnz_r).abs() / nnz_r).max()),
            "score_gap": float(score_gap)}
