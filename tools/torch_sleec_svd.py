#!/usr/bin/env python3
"""SLEEC's local embeddings on the card against the CPU's, cluster by
cluster, to show which SVD the card should run and where the model is
not unique.

    PYTHONPATH=src python3 tools/torch_sleec_svd.py [--dataset NAME]

On a `load_paper_like` dataset (seed 0; default wiki31k_like), clusters
the training rows as `baselines.sleec.train_sleec` does (on the CPU, then
on the card: the assignments must agree) and, for each cluster's 0/1
label submatrix Yc, prints one JSON line: its size, the gap at the rank
cut (the r-th less the (r+1)-th singular value, over the largest), and
how far Z Z^T (Z = U_r S_r, the only part of the embedding the scores
see) lies from LAPACK's on the CPU when cuSOLVER computes the SVD with
torch's default driver and with each of `gesvd`, `gesvdj` and `gesvda`
(relative to Z Z^T's largest entry; "failed" where cuSOLVER refuses),
and how far the card's ridge solve lies from the CPU's on the same
inputs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu() - b).abs().max() / b.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="wiki31k_like")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_sleec_svd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.baselines import sleec
    from repro_torch.data.xmc import load_paper_like
    d = load_paper_like(args.dataset, seed=0)
    X = torch.from_numpy(d.X_train)
    Y = torch.from_numpy(d.Y_train).float()
    rank, ridge = 32, 0.1                     # train_sleec's defaults
    _, a = sleec._kmeans(X, 4)
    _, a_card = sleec._kmeans(X.cuda(), 4)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "assignment_equal": bool(torch.equal(a,
                                                           a_card.cpu()))}))
    for c in range(4):
        idx = torch.nonzero(a == c)[:, 0]
        Xc, Yc = X[idx], Y[idx]
        r = min(rank, *Yc.shape)
        U, s, _ = torch.linalg.svd(Yc, full_matrices=False)
        Z = U[:, :r] * s[:r]
        zz = Z @ Z.T
        row = {"cluster": c, "rows": int(len(idx)),
               "gap": float((s[r - 1] - s[r]) / s[0]) if r < len(s)
               else None}
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            try:
                Ug, sg, _ = torch.linalg.svd(Yc.cuda(), full_matrices=False,
                                             driver=driver)
            except RuntimeError:
                row[f"zz_{driver or 'default'}"] = "failed"
                continue
            Zg = Ug[:, :r] * sg[:r]
            row[f"zz_{driver or 'default'}"] = rel(Zg @ Zg.T, zz)
        G = Xc.T @ Xc + ridge * torch.eye(X.shape[1])
        B = Xc.T @ Z
        row["solve"] = rel(torch.linalg.solve(G.cuda(), B.cuda()),
                           torch.linalg.solve(G, B))
        print(json.dumps(row))


if __name__ == "__main__":
    main()
