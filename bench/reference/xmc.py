"""Reference top-k scoring over packed row blocks, and the numbers that
compare served answers with it.

Each label's score is its row block's packed blocks against the row's
feature slices, summed block by block in fp32 (TF32 off); labels past
n_labels (the padding of the last row block) are never candidates.
"""

from __future__ import annotations

import torch

from bench.reference import fp32_products, tf32


def scores(x: torch.Tensor, blocks: torch.Tensor, block_cols, row_ptr,
           n_labels: int, Dp: int, *, precision: str = "fp32",
           absolute: bool = False) -> torch.Tensor:
    """x (n, D) -> (n, n_labels) fp32 scores (or, with `absolute`, the same
    sum over |x| and |w|: the magnitude a score's rounding is held to).
    `precision` "tf32" rounds both operands of every product to TF32."""
    n, D = x.shape
    nb, bl, bd = blocks.shape
    ptr = row_ptr.tolist()
    R = len(ptr) - 1
    xp = torch.zeros((n, Dp), dtype=torch.float32, device=x.device)
    xp[:, :D] = x
    if absolute:
        xp.abs_()
    xv = xp.view(n, Dp // bd, bd)
    out = torch.zeros((n, R * bl), dtype=torch.float32, device=x.device)
    with fp32_products():
        for r in range(R):
            a, b = ptr[r], ptr[r + 1]
            if a == b:
                continue
            w = blocks[a:b]
            if absolute:
                w = w.abs()
            xg = xv[:, block_cols[a:b].long()].reshape(n, (b - a) * bd)
            w = w.permute(1, 0, 2).reshape(bl, (b - a) * bd)
            if precision == "tf32":
                xg, w = tf32(xg), tf32(w)
            out[:, r * bl:(r + 1) * bl] = xg @ w.T
    return out[:, :n_labels]


def numbers(served_scores: torch.Tensor, served_ids: torch.Tensor,
            ref: torch.Tensor, mag: torch.Tensor, k: int) -> dict:
    """How far served answers (n, k) lie from the reference's, on one scale
    per row (the largest |x| . |w| among the labels compared):

    bad_ids   : rows whose served ids are out of range, repeated or not k;
    score_err : the largest |served score - reference score of that label|;
    rank_gap  : the largest amount by which the j-th best served label's
                reference score lies below the reference's j-th best.
    """
    n = ref.shape[0]
    ids = served_ids.long()
    ok = (ids.shape == (n, k)) and bool(((ids >= 0)
                                         & (ids < ref.shape[1])).all())
    if not ok:
        return {"bad_ids": float(n), "score_err": float("inf"),
                "rank_gap": float("inf")}
    repeated = (ids.sort(dim=1)[0].diff(dim=1) == 0).any(dim=1)
    at = ref.gather(1, ids)
    best_vals, best_ids = ref.topk(k, dim=1)
    scale = torch.maximum(mag.gather(1, ids).amax(dim=1),
                          mag.gather(1, best_ids).amax(dim=1))
    scale = scale.clamp_min(torch.finfo(torch.float32).tiny)[:, None]
    err = ((served_scores.float() - at).abs() / scale).amax()
    gap = ((best_vals - at.sort(dim=1, descending=True)[0]) / scale).amax()
    return {"bad_ids": float(repeated.sum()), "score_err": float(err),
            "rank_gap": float(gap)}
