#!/usr/bin/env python3
"""Digest of every CUDA kernel's output of the PyTorch port on fixed
inputs, to show that a change left a kernel's bits as they were.

    PYTHONPATH=src python3 tools/torch_kernel_digests.py [--out FILE]

Builds the port's kernels (nvcc, on a machine with a card), runs each of
the ten kernels once on inputs drawn from a fixed seed with numpy, and
prints one JSON object: kernel name (and the case) -> sha256 of the
output bytes. Run it from two checkouts on one card and compare the two
objects: equal digests are equal bits. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().flatten().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_digests: needs a CUDA card")
    from repro_torch.core.pruning import (quantize_block_sparse,
                                          to_block_sparse)
    from repro_torch.kernels import _build
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.kernels.topk import ops as topk_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    # Training kernels (1, 2): X in 16-byte-aligned rows, as `fit` has it.
    L, N, D, C = 300, 1000, 4099, 0.7
    X = hinge_ops.aligned_rows(t(rng.normal(size=(N, D)) / np.sqrt(D)))
    W, V = t(rng.normal(size=(L, D))), t(rng.normal(size=(L, D)))
    S = t(np.where(rng.random((L, N)) < 0.1, 1.0, -1.0))
    f, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    out["hinge_obj_grad"] = digest(f, g, act)
    out["hvp"] = digest(hvp_ops.hvp_cuda(V, X, act, C))

    # Serving kernels (3-9) on a pruned model with an empty row block.
    L, D, bl, bd = 1000, 4096, 128, 128
    Wm = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    keep = rng.random((-(-L // bl), D // bd)) < 0.3
    keep[0] = False
    Wm *= np.kron(keep, np.ones((bl, bd), np.float32))[:L]
    model = to_block_sparse(Wm, (bl, bd), device=dev)
    q = quantize_block_sparse(model)
    R = model.shape[0] // bl
    fp = (model.blocks, model.block_cols, model.row_ptr)
    i8 = (q.blocks, q.scales, q.block_cols, q.row_ptr)
    sel = t([7, 0, 3, 5, 1], torch.int32)
    for n in (1, 8, 9, 16, 17, 32, 64, 65, 256):
        x = rng.normal(size=(n, model.shape[1]))
        x = t(x / np.linalg.norm(x, axis=1, keepdims=True))
        sel_pq = sel.repeat(n, 1).contiguous()
        out[f"bsr_predict n={n}"] = digest(bsr_ops.bsr_predict_cuda(x, *fp,
                                                                    R))
        out[f"bsr_predict_int8 n={n}"] = digest(
            bsr_ops.bsr_predict_int8_cuda(x, *i8, R))
        out[f"bsr_gather n={n}"] = digest(
            bsr_ops.bsr_predict_gather_cuda(x, *fp, sel))
        out[f"bsr_gather_int8 n={n}"] = digest(
            bsr_ops.bsr_predict_gather_int8_cuda(x, *i8, sel))
        out[f"bsr_gather_pq n={n}"] = digest(
            bsr_ops.bsr_predict_gather_pq_cuda(x, *fp, sel_pq))
        out[f"bsr_gather_pq_int8 n={n}"] = digest(
            bsr_ops.bsr_predict_gather_pq_int8_cuda(x, *i8, sel_pq))
    scores = t(rng.normal(size=(64, 4096)))
    out["blocked_topk"] = digest(*topk_ops.blocked_topk_cuda(scores, 5,
                                                             bL=256))

    # Banded attention (10) at hymba-1.5b's heads, both types.
    B, T, H, KV, hd, w = 2, 2304, 25, 5, 64, 1024
    qkv = [rng.normal(size=(B, T, n, hd)) for n in (H, KV, KV)]
    for dt in (torch.float32, torch.bfloat16):
        q_, k_, v_ = (t(a).to(dt) for a in qkv)
        out[f"banded_attention {str(dt)[6:]}"] = digest(
            band_ops.banded_attention_cuda(q_, k_, v_, window=w))
    torch.cuda.synchronize()
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "digests": out})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
