#!/usr/bin/env python3
"""Digest of every CUDA kernel's output of the PyTorch port on fixed
inputs, to show that a change left a kernel's bits as they were.

    PYTHONPATH=src python3 tools/torch_kernel_digests.py [--out FILE]
        [--times]

Builds the port's kernels (nvcc, on a machine with a card), runs each of
the ten kernels once on inputs drawn from a fixed seed with numpy, and
prints one JSON object: kernel name (and the case) -> sha256 of the
output bytes. Run it from two checkouts on one card and compare the two
objects: equal digests are equal bits. Needs a CUDA card.

--times also times kernels 3, 7, 8 and 9 on a model at Wiki10-31K
serving width drawn from a fixed seed (242 row blocks of 128 labels, 40 of
the 797 column blocks of 128 features each, weights N(0, 0.02^2), int8 by
per-block absmax scales) and tf-idf-like unit rows: kernel 3 (the
exhaustive fp32 product) and, at B = 31 row blocks a query, kernels 7 and
8 at the top 31 of x against 242 random centroids ("centroid") or drawn
by a Zipf popularity ("skewed"), each at n = 1, 8, 32, 64, 256; kernel 9
on the scores of 256 rows (30,976 labels, the padding labels at NEG_INF):
the kernel on the input padded to 31,232 and the whole `topk` on the
unpadded scores. Each time is the median of 20 launches timed with CUDA
events, the L2 overwritten before each, beside a digest of each output.
Last, the `bsr` backend's card stage at n = 64 (`bsr_predict_topk`: the
product, the padding labels' mask and the top-5) on the host clock,
synchronised before and after, the median of 21, as `chip_smoke.py`'s
phase 4 times `card_topk`.
To compare two checkouts' times, run this file from one checkout with
each checkout's `src` on PYTHONPATH in one call (parent, change, change,
parent); the JSON object then also holds the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().flatten().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def median_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    fn()
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_ms(fn, flush: torch.Tensor, iters: int = 21) -> float:
    fn()
    laps = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        laps.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(laps))


def times(bsr_ops, topk_ops, out: dict) -> dict:
    """--times: kernels 3, 7, 8 and 9 at Wiki10-31K width (the docstring);
    adds each output's digest to `out` and returns the times in ms."""
    R, C, BL, BD, PER_ROW, B = 242, 797, 128, 128, 40, 31
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cols = np.concatenate([np.sort(rng.choice(C, PER_ROW, replace=False))
                           for _ in range(R)])
    cols = torch.tensor(cols, dtype=torch.int32, device=dev)
    ptr = torch.arange(0, (R + 1) * PER_ROW, PER_ROW, dtype=torch.int32,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = 0.02 * torch.randn((R * PER_ROW, BL, BD), generator=gen,
                                device=dev)
    scales = (blocks.abs().amax(dim=(1, 2)) / 127).contiguous()
    qblocks = torch.round(blocks / scales[:, None, None]).to(torch.int8)
    centroids = torch.randn((R, C * BD), generator=gen, device=dev)
    popularity = np.arange(1, R + 1) ** -0.8
    popularity /= popularity.sum()
    flush = torch.empty(64 * 2**20, device=dev)          # 256 MB
    ms = {}

    def timed(key, fn):
        got = fn()
        out[key] = digest(*got) if isinstance(got, tuple) else digest(got)
        ms[key] = median_ms(fn, flush)
        print(f"   {key}: {ms[key]:.4f} ms", flush=True)

    for n in (1, 8, 32, 64, 256):
        x = np.zeros((n, C * BD), np.float32)
        for i in range(n):
            f = rng.choice(C * BD, 300, replace=False)
            x[i, f] = rng.random(300)
        x = torch.tensor(x / np.linalg.norm(x, axis=1, keepdims=True),
                         device=dev)
        timed(f"bsr_predict wiki10 n={n}",
              lambda: bsr_ops.bsr_predict_cuda(x, blocks, cols, ptr, R))
        sels = {
            "centroid": torch.topk(x @ centroids.T, B).indices,
            "skewed": torch.tensor(np.stack([
                rng.choice(R, B, replace=False, p=popularity)
                for _ in range(n)]), device=dev)}
        for case, sel in sels.items():
            sel = sel.to(torch.int32).contiguous()
            timed(f"bsr_gather_pq wiki10 {case} n={n}",
                  lambda: bsr_ops.bsr_predict_gather_pq_cuda(
                      x, blocks, cols, ptr, sel))
            timed(f"bsr_gather_pq_int8 wiki10 {case} n={n}",
                  lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(
                      x, qblocks, scales, cols, ptr, sel))
        if n == 64:
            x64 = x
        if n == 256:
            scores = bsr_ops.bsr_predict_cuda(x, blocks, cols, ptr, R)
    scores[:, 30_938:] = -3.0e38                  # Wiki10-31K's labels
    padded = torch.nn.functional.pad(scores, (0, 256), value=-3.0e38)
    timed("blocked_topk wiki10 (256, 31232) k=5",
          lambda: topk_ops.blocked_topk_cuda(padded, 5, bL=512))
    timed("topk wiki10 unpadded (256, 30976) k=5",
          lambda: topk_ops.topk(scores, 5))
    from repro_torch.core.pruning import BlockSparseModel
    model = BlockSparseModel(
        blocks, torch.repeat_interleave(torch.arange(
            R, dtype=torch.int32, device=dev), PER_ROW), cols, ptr,
        (R * BL, C * BD), (BL, BD), (30_938, C * BD))
    key = "bsr_predict_topk wiki10 n=64, host clock"
    out[key] = digest(*bsr_ops.bsr_predict_topk(x64, model, 5,
                                                n_labels=30_938))
    ms[key] = host_ms(lambda: bsr_ops.bsr_predict_topk(
        x64, model, 5, n_labels=30_938), flush)
    print(f"   {key}: {ms[key]:.4f} ms", flush=True)
    return ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--times", action="store_true",
                    help="also time kernels 3, 7, 8 and 9 at Wiki10-31K "
                    "width")
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
    # Kernel 3 at bl = 48, bd = 16 (a stage longer than a block), row block
    # 1 with one block and 2 with all of them, n across its row tiles.
    Wm = (0.1 * rng.normal(size=(300, 520))).astype(np.float32)
    keep = rng.random((7, 33)) < 0.3
    keep[0] = keep[1] = False
    keep[1, 5] = keep[2] = True
    Wm *= np.kron(keep, np.ones((48, 16), np.float32))[:300, :520]
    edge = to_block_sparse(Wm, (48, 16), device=dev)
    for n in (1, 7, 9, 33, 63, 65, 300):
        x = t(rng.normal(size=(n, edge.shape[1])))
        out[f"bsr_predict edge n={n}"] = digest(bsr_ops.bsr_predict_cuda(
            x, edge.blocks, edge.block_cols, edge.row_ptr, 7))
    # Kernels 7 and 8 at selections of their own: each row's top 3 of R
    # random centroids, row block 2 in every row (skewed), repeated ids,
    # ids -1 and R, and the emptied row block 0.
    centroids = rng.normal(size=(R, model.shape[1]))
    for n in (1, 33, 256):
        x = rng.normal(size=(n, model.shape[1]))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        top = np.argsort(-(x @ centroids.T), axis=1, kind="stable")[:, :3]
        other = rng.integers(0, R, size=(n, 2))
        cases = {"centroid": top,
                 "skewed": np.concatenate([np.full((n, 1), 2), other], 1),
                 "repeated": np.concatenate([other, other[:, :1]], 1),
                 "outside": np.concatenate([np.full((n, 1), -1), top[:, :1],
                                            np.full((n, 1), R)], 1),
                 "emptied": np.concatenate([np.zeros((n, 1)), top[:, :1],
                                            np.zeros((n, 1))], 1)}
        x = t(x)
        for case, sel_pq in cases.items():
            sel_pq = t(sel_pq, torch.int32)
            out[f"bsr_gather_pq {case} n={n}"] = digest(
                bsr_ops.bsr_predict_gather_pq_cuda(x, *fp, sel_pq))
            out[f"bsr_gather_pq_int8 {case} n={n}"] = digest(
                bsr_ops.bsr_predict_gather_pq_int8_cuda(x, *i8, sel_pq))
    scores = t(rng.normal(size=(64, 4096)))
    out["blocked_topk"] = digest(*topk_ops.blocked_topk_cuda(scores, 5,
                                                             bL=256))
    # Kernel 9 through `topk` on unpadded scores (the parent pads them):
    # rows of ties, NEG_INF, -inf and a short last block, float4 rows
    # (L % 4 == 0) and one-float rows (L odd), k of 1, 5 and 16.
    for L, bL in ((30_976, 512), (32_001, 512), (1_000, 128), (999, 256)):
        s = rng.normal(size=(8, L)).astype(np.float32)
        s[0] = 0.0
        s[1] = -3.0e38
        s[2, ::2] = -np.inf
        s[3] = rng.integers(0, 3, L)
        s[4, -1] = 5.0
        s = t(s)
        for k in (1, 5, 16):
            out[f"topk unpadded ({L}) bL={bL} k={k}"] = digest(
                *topk_ops.topk(s, k, bL=bL))
            out[f"blocked_topk padded ({L}) bL={bL} k={k}"] = digest(
                *topk_ops.blocked_topk_cuda(torch.nn.functional.pad(
                    s, (0, (-L) % bL), value=-3.0e38), k, bL=bL))

    # Banded attention (10) at hymba-1.5b's heads, both types.
    B, T, H, KV, hd, w = 2, 2304, 25, 5, 64, 1024
    qkv = [rng.normal(size=(B, T, n, hd)) for n in (H, KV, KV)]
    for dt in (torch.float32, torch.bfloat16):
        q_, k_, v_ = (t(a).to(dt) for a in qkv)
        out[f"banded_attention {str(dt)[6:]}"] = digest(
            band_ops.banded_attention_cuda(q_, k_, v_, window=w))
    torch.cuda.synchronize()
    result = {"device": torch.cuda.get_device_name(0)}
    if args.times:
        result["ms"] = times(bsr_ops, topk_ops, out)
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    result["digests"] = out
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
