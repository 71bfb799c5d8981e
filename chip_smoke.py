#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--seed 0]      # from the root of a checkout

Drives the port's serving and training paths at the full width of
Wiki10-31K (L = 30,938 labels, D = 101,938 features, N = 14,146 training
documents; Extreme Classification Repository, DiSMEC paper Table 1).
Serving uses 128 x 128 blocks at 5% block density, weights drawn from the
seed:

  1. build   — all four CUDA kernels with nvcc for sm_90a (register and
               shared-memory lines of `-Xptxas -v` printed);
  2. setup   — the card's name and power limit; TF32 off for matmul and
               cuDNN, so every plain version runs in full fp32;
  3. kernels — each kernel against its plain PyTorch version at the
               shapes the serving path gives it (BSR predict at n = 1, 32,
               256; blocked top-k at (256, 30,976), k = 5; rows of exact
               zeros where tie order decides), timed with CUDA events over
               cold-L2 launches beside its bound, its plain version and one
               PyTorch library call computing the same function;
  4. serve   — the model packed label batch by label batch, saved with
               `save_block_sparse`, then `CheckpointHandle.open(dir)
               .engine()` on the default `bsr` backend serving ragged
               requests; both kernels' launch counts must be > 0 in that
               run, and the served ids must equal the plain path's ids on
               every row whose k-th/(k+1)-th margin is decisive.

Then training, on the port's synthetic power-law data at Wiki10-31K width
(N = 14,146, D = 101,938; 2 of Wiki10-31K's 31 batches of 1,024 labels):

  5. train data    — `make_xmc_dataset` (the JAX package's generator,
                     copied) from the seed: 2,048 labels, beta = 0.9, 512
                     held-out rows; X_train is 5.77 GB of dense fp32;
  6. train kernels — the hinge kernel (at W = 0 and at a random W) and the
                     HVP kernel (at a random V, with the hinge kernel's
                     mask) against their plain versions at (1,024, 14,146,
                     101,938), two launches bit-identical, timed like 3;
  7. TRON          — batched TRON on the kernel ops against the plain ops
                     at (256, 4,096, 16,384): per-label Newton and CG
                     counts equal on >= 99% of labels, f within 1e-4;
  8. train         — `fit(X, Y, spec, dir)` on the card with the kernel
                     ops, max_newton = 10 and max_cg = 20, label_batch
                     1,024: a complete two-batch checkpoint; the hinge and
                     HVP launch counts must be > 0 in that run;
  9. serve trained — `CheckpointHandle.open(dir).engine()` on `bsr` over
                     the 512 held-out rows: P@1 and P@5, the served ids
                     equal to the plain path's on every decisive row, and
                     both serving kernels launched.

The lines before the last are the kernels' JSON summary (all four
kernels), the training run's JSON summary and the card's name and power
limit from nvidia-smi; the last line is `{"ok": true, "device": {...}}`.
Any failure exits non-zero before it. Without a CUDA card, or outside a
checkout, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_LABELS, N_FEATURES = 30_938, 101_938          # Wiki10-31K
BLOCK = (128, 128)
BLOCK_DENSITY = 0.05                            # of column blocks per row
LABEL_BATCH = 1024
DELTA = 0.01
K = 5
REQUEST_ROWS = (1, 64, 1, 64, 300, 1, 7, 64, 1, 33)
ZERO_REQUEST = 5                                # this one is a row of zeros
BSR_N = (1, 32, 256)
HEADLINE_N = 32                                 # a typical micro-batch
# Training: Wiki10-31K's N and D, 2 of its 31 label batches.
TRAIN_N, TRAIN_LABELS, TEST_N = 14_146, 2_048, 512
TRAIN_BATCH = 1_024
TRAIN_BETA = 0.9                                # wiki31k_like
MAX_NEWTON, MAX_CG = 10, 20                     # Algorithm 1 uses 50 and 40
TRON_SHAPE = (256, 4_096, 16_384)               # (L, N, D) of phase 7
SERVE_CHUNK = 64                                # held-out rows per request
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: done in {time.perf_counter() - t0:.1f} s",
          flush=True)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    fp32 operations over the fp32 peak, whichever is larger (ms)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median time of `fn` in ms from CUDA events, each launch after the
    50 MB L2 has been overwritten (the serving path finds it cold)."""
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


def tfidf_rows(rng, n: int, perm: np.ndarray) -> np.ndarray:
    """Sparse L2-normalised tf-idf-like rows: ~300 distinct features per
    row, drawn Zipf-like over a fixed random order of the vocabulary,
    weighted log(1 + tf) * idf with idf growing with the feature's rank."""
    X = np.zeros((n, N_FEATURES), np.float32)
    for i in range(n):
        ranks = (rng.zipf(1.2, size=400) - 1) % N_FEATURES
        ranks, tf = np.unique(ranks, return_counts=True)
        w = np.log1p(tf) * (1.0 + np.log1p(ranks))
        X[i, perm[ranks]] = w / np.linalg.norm(w)
    return X


def build_model(rng):
    """A Delta-pruned model at full width, made label batch by label
    batch: each 128-label row block keeps 5% of its 797 column blocks
    (9,643 of 192,874 blocks), with weights N(0, 0.02^2) of which
    |w| < Delta are pruned to exact zeros, as Algorithm 1 step 7 does."""
    from repro_torch.core.pruning import (concat_block_sparse, prune,
                                          to_block_sparse)
    bl, bd = BLOCK
    R, C = -(-N_LABELS // bl), -(-N_FEATURES // bd)
    total = round(BLOCK_DENSITY * R * C - 0.5)               # 9,643
    per_row = np.full(R, total // R)
    per_row[rng.choice(R, total - per_row.sum(), replace=False)] += 1
    parts = []
    for lo in range(0, N_LABELS, LABEL_BATCH):
        hi = min(lo + LABEL_BATCH, N_LABELS)
        W = np.zeros((hi - lo, N_FEATURES), np.float32)
        for r in range(lo // bl, -(-hi // bl)):
            cols = np.sort(rng.choice(C, per_row[r], replace=False))
            vals = 0.02 * rng.standard_normal((cols.size, bl, bd),
                                              dtype=np.float32)
            r0, r1 = r * bl - lo, min((r + 1) * bl, hi) - lo
            for c, v in zip(cols, vals):
                c0, c1 = c * bd, min((c + 1) * bd, N_FEATURES)
                W[r0:r1, c0:c1] = v[:r1 - r0, :c1 - c0]
        W = prune(torch.from_numpy(W), DELTA)
        parts.append(to_block_sparse(W, BLOCK, row_block_offset=lo // bl,
                                     sentinel_if_empty=False, device="cpu"))
    model = concat_block_sparse(parts, (N_LABELS, N_FEATURES))
    _need(model.n_blocks == total, f"{model.n_blocks} blocks, not {total}")
    return model


def check_bsr(model, X, flush) -> dict:
    """Kernel vs plain version at n = 1, 32, 256, with times.

    Tolerance: |kernel - plain| <= 1e-5 * (|x| @ |W|^T) elementwise. Both
    sum the same fp32 products (FFMA in the kernel, fp32 GEMM with TF32
    off in the plain version) in another order; the rounding error of
    such a sum is far below 1e-5 of the sum of its terms' magnitudes."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    R = Lp // bl
    blocks, rows, cols, ptr = (model.blocks, model.block_rows,
                               model.block_cols, model.row_ptr)
    try:
        A = torch.sparse_bsr_tensor(ptr, cols, blocks, size=(Lp, Dp),
                                    check_invariants=False)
        A @ torch.zeros((Dp, 1), device="cuda")
        library = "torch.sparse_bsr_tensor @ x.T"
        lib_fn = lambda x: (A @ x.T).T                          # noqa: E731
    except (RuntimeError, NotImplementedError) as exc:
        print(f"   sparse BSR matmul unsupported on this build ({exc}); "
              "the library yardstick is dense x @ W.T")
        Wd = model.to_dense()
        library, lib_fn = "dense x @ W.T", lambda x: x @ Wd.T   # noqa: E731
    print("   tolerance: |kernel - plain| <= 1e-5 * (|x| @ |W|^T) per score,"
          " because both sum the same fp32 products in another order")
    sweep = []
    for n in BSR_N:
        x = torch.nn.functional.pad(torch.from_numpy(X[:n]).cuda(),
                                    (0, Dp - N_FEATURES)).contiguous()
        got = bsr_ops.bsr_predict_cuda(x, blocks, cols, ptr, R)
        want = bsr_ref.bsr_predict(x, blocks, rows, cols, R)
        mag = bsr_ref.bsr_predict(x.abs(), blocks.abs(), rows, cols, R)
        lib = lib_fn(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        _need(bool(((got - want).abs() <= 1e-5 * mag).all()),
              f"BSR kernel disagrees with its plain version at n={n}: "
              f"max |diff| {err:.3e}")
        lib_err = float((lib - want).abs().max())
        del got, want, mag, lib
        ms = cuda_ms(lambda: bsr_ops.bsr_predict_cuda(x, blocks, cols, ptr,
                                                      R), 20, flush)
        plain_ms = cuda_ms(lambda: bsr_ref.bsr_predict(x, blocks, rows, cols,
                                                       R), 5, flush)
        lib_ms = cuda_ms(lambda: lib_fn(x), 10, flush)
        n_bytes = (4 * model.n_blocks * bl * bd + 4 * model.n_blocks
                   + 4 * (R + 1) + 4 * n * Dp + 4 * n * Lp)
        b_ms, b_by = bound(n_bytes, bsr_ops.model_flops(model, n))
        row = dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_max_abs_err=lib_err)
        print(f"   bsr n={n:3d}: max|kernel-plain| {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  {library} "
              f"{lib_ms:.4f} ms (max|lib-plain| {lib_err:.3e})  bound "
              f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB, "
              f"{bsr_ops.model_flops(model, n) / 1e9:.2f} GFLOP)",
              flush=True)
        sweep.append(row)
    # The fully pruned sentinel (one zero block, row_ptr all zeros).
    z = torch.zeros((1, bl, bd), device="cuda")
    zi = torch.zeros((1,), dtype=torch.int32, device="cuda")
    zp = torch.zeros((R + 1,), dtype=torch.int32, device="cuda")
    out = bsr_ops.bsr_predict_cuda(x, z, zi, zp, R)
    torch.cuda.synchronize()
    _need(bool((out == 0).all()), "sentinel model does not score zeros")
    return dict(library=library, sweep=sweep)


def check_topk(scores, flush) -> dict:
    """Blocked top-k kernel vs its plain version on the serving path's
    scores at (256, 30,976), k = 5, plus rows where ties decide. Values
    and ids must be identical: the top-k only selects."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import ref as topk_ref
    n, L = scores.shape
    bL = topk_ops.DEFAULT_BL
    print("   tolerance: none; values and ids identical, because the top-k "
          "only selects")
    padded = torch.nn.functional.pad(scores, (0, (-L) % bL),
                                     value=topk_ref.NEG_INF).contiguous()
    v_k, i_k = topk_ops.blocked_topk_cuda(padded, K, bL=bL)
    v_p, i_p = topk_ref.blocked_topk(padded, K, bL=bL)
    torch.cuda.synchronize()
    _need(torch.equal(v_k, v_p) and torch.equal(i_k, i_p),
          "top-k kernel disagrees with its plain version")
    err = float((v_k - v_p).abs().max())
    _, ids = topk_ops.topk(scores, K)
    _, ids_p = topk_ref.topk(scores, K)
    _need(torch.equal(ids, ids_p), "top-k ids differ from the stable sort")
    ties = torch.zeros((2, L), device="cuda")
    ties[1, 700] = 1.0
    _, tie_ids = topk_ops.topk(ties, K)
    _need(tie_ids.tolist() == [[0, 1, 2, 3, 4], [700, 0, 1, 2, 3]]
          and torch.equal(tie_ids, topk_ref.topk(ties, K)[1]),
          f"tie order differs: {tie_ids.tolist()}")
    ms = cuda_ms(lambda: topk_ops.blocked_topk_cuda(padded, K, bL=bL), 50,
                 flush)
    plain_ms = cuda_ms(lambda: topk_ref.blocked_topk(padded, K, bL=bL), 10,
                       flush)
    lib_ms = cuda_ms(lambda: torch.topk(scores, K).values, 20, flush)
    n_out = n * (padded.shape[1] // bL) * K
    n_bytes = 4 * padded.numel() + 8 * n_out
    b_ms, b_by = bound(n_bytes, K * padded.numel())
    print(f"   topk ({n}, {L}) k={K}: max|kernel-plain| {err:.1e}, ids "
          f"identical (tie rows too)  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  torch.topk {lib_ms:.4f} ms  bound "
          f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB)", flush=True)
    return dict(n=n, L=L, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def plain_topk(model, x: np.ndarray, n_labels: int = N_LABELS):
    """The plain path: plain BSR predict, padding masked, stable sort."""
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.kernels.topk import ref as topk_ref
    Lp, Dp = model.shape
    xp = torch.nn.functional.pad(torch.from_numpy(x).cuda(),
                                 (0, Dp - x.shape[1]))
    s = bsr_ref.bsr_predict(xp, model.blocks, model.block_rows,
                            model.block_cols, Lp // model.block_shape[0])
    s[:, n_labels:] = topk_ref.NEG_INF
    v, i = topk_ref.topk(s, K + 1)
    return v.cpu().numpy(), i.cpu().numpy()


def breakdown(engine, x: np.ndarray, reps: int = 5) -> dict:
    """Where one request's time goes, stage by stage as `XMCEngine.step`
    runs it (median of `reps`, host clock, each stage synchronised)."""
    stages = {"queue_and_pad": [], "host_to_card": [], "card_topk": [],
              "card_to_host": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.queue.submit(x)
        mb = next(engine.queue.drain())
        t1 = time.perf_counter()
        xd = torch.from_numpy(mb.x).to(engine.backend.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores, labels = engine.backend.topk(xd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        scores.cpu().numpy(), labels.cpu().numpy()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    split = {k: float(np.median(v)) for k, v in stages.items()}
    print(f"   one {x.shape[0]}-row request ({x.nbytes / 1e6:.1f} MB of "
          f"dense fp32 rows), median ms: " +
          ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return split


def serve(ckpt: str, requests, margin_tol: float) -> dict:
    """The main path, with both launch counts set to 0 just before it."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.xmc_api import CheckpointHandle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bsr_ops.bsr_predict_cuda.launches = 0
    topk_ops.blocked_topk_cuda.launches = 0

    t0 = time.perf_counter()
    handle = CheckpointHandle.open(ckpt)
    spec = handle.spec.serve
    _need(spec.backend == "bsr", f"default backend is {spec.backend}")
    engine = handle.engine(spec.replace(warmup=False))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_warm = engine.warmup()
    t_warm = time.perf_counter() - t0
    results, wall = [], []
    for x in requests:
        t0 = time.perf_counter()
        results.extend(engine.serve([x]))
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {"bsr_predict": bsr_ops.bsr_predict_cuda.launches,
                "blocked_topk": topk_ops.blocked_topk_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    lat = engine.latency_summary()
    print(f"   open + load to the card {t_load:.2f} s; warm-up of {n_warm} "
          f"buckets {t_warm:.2f} s")
    print(f"   {len(requests)} requests of {list(REQUEST_ROWS)} rows: "
          f"p50 {lat['p50_ms']:.3f} ms  p99 {lat['p99_ms']:.3f} ms "
          f"(enqueue to completion); per request "
          f"{[round(w, 3) for w in wall]} ms")
    print(f"   max_memory_allocated {peak / 2**20:.1f} MiB; launches in "
          f"this run {launches}")
    _need(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")

    model = engine.backend.model
    decisive = agree = 0
    for i, (x, res) in enumerate(zip(requests, results)):
        _need(res.labels.shape == (x.shape[0], K)
              and np.isfinite(res.scores).all()
              and 0 <= res.labels.min() and res.labels.max() < N_LABELS,
              f"request {i}: malformed result")
        v, ids = plain_topk(model, x)
        if i == ZERO_REQUEST:
            _need(res.labels.tolist() == [list(range(K))]
                  and ids[:, :K].tolist() == [list(range(K))],
                  f"zero row served {res.labels.tolist()}")
        rows = (v[:, K - 1] - v[:, K]) > margin_tol
        decisive += int(rows.sum())
        agree += int((res.labels[rows] == ids[rows, :K]).all(axis=1).sum())
    print(f"   served ids == plain ids on {agree}/{decisive} rows with a "
          f"decisive margin (> {margin_tol:.1e}) of "
          f"{sum(REQUEST_ROWS)} rows")
    _need(decisive > 0 and agree == decisive,
          "served ids differ from the plain path")
    split = breakdown(engine, requests[REQUEST_ROWS.index(64)])
    return dict(launches=launches, p50_ms=lat["p50_ms"],
                p99_ms=lat["p99_ms"], load_s=t_load, warmup_s=t_warm,
                peak_mib=peak / 2**20, agree=agree, decisive=decisive,
                request_64_ms=split)


def train_magnitudes(W, X, S, act, C):
    """Per element, the sums over absolute values of the terms the hinge
    kernel adds: m = |W| |X|^T bounds a score's rounding, so f's terms are
    bounded by act (|z| + m)^2 and grad's by 2|W| + 2C (act (m + |S|)) |X|."""
    m = W.abs() @ X.abs().T
    z = 1.0 - S * (W @ X.T)
    f_mag = (W * W).sum(-1) + C * (act * (z.abs() + m) ** 2).sum(-1)
    g_mag = 2.0 * W.abs() + 2.0 * C * ((act * (m + S.abs())) @ X.abs())
    return f_mag, g_mag, z


def within(diff: torch.Tensor, mag: torch.Tensor) -> bool:
    """|diff| <= 1e-5 * mag in every element (an exact zero where the
    magnitude is zero)."""
    return bool((diff.abs() <= 1e-5 * mag).all())


def share(diff: torch.Tensor, mag: torch.Tensor) -> float:
    """The largest |diff| / mag over the elements with mag > 0."""
    return float((diff.abs() / mag.clamp_min(1e-30)).max())


def check_train_kernels(X, S, gen, flush) -> dict:
    """Hinge and HVP kernels against their plain versions at the trainer's
    shape (L, N, D) = (1,024, 14,146, 101,938), with times."""
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hinge import ref as hinge_ref
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.kernels.hvp import ref as hvp_ref
    C = 1.0
    L, (N, D) = S.shape[0], X.shape
    print("   tolerance: f, grad and Hv within 1e-5 of the same sums over "
          "absolute values, per element, because both sides sum the same "
          "fp32 products in another order (FFMA in the kernels, fp32 GEMM "
          "with TF32 off in the plain versions); act identical wherever "
          "|z| > 1e-5, where no such rounding can flip it; two launches "
          "identical bit for bit (no atomics, fixed order)")
    out = {}
    W_rand = torch.randn((L, D), device="cuda", generator=gen)
    for tag, W in (("W=0", torch.zeros((L, D), device="cuda")),
                   ("W~N(0,1)", W_rand)):
        f, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
        f_p, g_p, act_p = hinge_ref.objective_grad_act(W, X, S, C)
        f_mag, g_mag, z = train_magnitudes(W, X, S,
                                           torch.maximum(act, act_p), C)
        again = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
        torch.cuda.synchronize()
        decided = z.abs() > 1e-5
        n_flip = int((act != act_p).sum())
        _need(torch.equal(act[decided], act_p[decided]),
              f"hinge act differs where |z| > 1e-5 ({tag})")
        f_err, g_err = share(f - f_p, f_mag), share(g - g_p, g_mag)
        _need(within(f - f_p, f_mag) and within(g - g_p, g_mag),
              f"hinge kernel disagrees with its plain version ({tag}): "
              f"f {f_err:.2e}, grad {g_err:.2e} of the magnitude")
        _need(all(torch.equal(a, b) for a, b in zip((f, g, act), again)),
              f"two hinge launches differ ({tag})")
        err = max(float((f - f_p).abs().max()), float((g - g_p).abs().max()))
        print(f"   hinge {tag}: max|kernel-plain| f "
              f"{float((f - f_p).abs().max()):.3e} grad "
              f"{float((g - g_p).abs().max()):.3e} (largest share of the "
              f"magnitude: f {f_err:.2e}, grad {g_err:.2e}); act flips "
              f"{n_flip} of {act.numel()} (|z| <= 1e-5 there); active "
              f"{float(act.mean()):.4f}; two launches identical",
              flush=True)
        out[tag] = err
        del f_p, g_p, act_p, f_mag, g_mag, z, decided, again
    W = W_rand
    f, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    del f, g
    V = torch.randn((L, D), device="cuda", generator=gen)
    hv = hvp_ops.hvp_cuda(V, X, act, C)
    hv_p = hvp_ref.hessian_vp(V, X, act, C)
    mag = 2.0 * V.abs() + 2.0 * C * ((act * (V.abs() @ X.abs().T))
                                     @ X.abs())
    again = hvp_ops.hvp_cuda(V, X, act, C)
    torch.cuda.synchronize()
    hv_err = share(hv - hv_p, mag)
    _need(within(hv - hv_p, mag), "HVP kernel disagrees with its plain "
          f"version: {hv_err:.2e} of the magnitude")
    _need(torch.equal(hv, again), "two HVP launches differ")
    out["hvp"] = float((hv - hv_p).abs().max())
    print(f"   hvp: max|kernel-plain| {out['hvp']:.3e} (largest share of "
          f"the magnitude {hv_err:.2e}); two launches identical",
          flush=True)
    del hv, hv_p, mag, again

    r = act * (W @ X.T - S)
    u = act * (V @ X.T)
    n_ops = 2 * 2 * L * N * D                 # two dense contractions each
    hinge_bytes = 4 * (2 * L * D + N * D + 2 * L * N + L)
    hvp_bytes = 4 * (2 * L * D + N * D + L * N)
    times = {}
    for name, fn, plain, lib, n_bytes in (
            ("hinge", lambda: hinge_ops.hinge_obj_grad_cuda(W, X, S, C),
             lambda: hinge_ref.objective_grad_act(W, X, S, C),
             lambda: (W @ X.T, r @ X), hinge_bytes),
            ("hvp", lambda: hvp_ops.hvp_cuda(V, X, act, C),
             lambda: hvp_ref.hessian_vp(V, X, act, C),
             lambda: (V @ X.T, u @ X), hvp_bytes)):
        ms = cuda_ms(fn, 3, flush)
        plain_ms = cuda_ms(plain, 3, flush)
        lib_ms = cuda_ms(lib, 3, flush)
        b_ms, b_by = bound(n_bytes, n_ops)
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           tflops=n_ops / ms / 1e9)
        print(f"   {name} ({L}, {N}, {D}): kernel {ms:.3f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.3f} ms  "
              f"two torch.matmul {lib_ms:.3f} ms  bound {b_ms:.3f} ms "
              f"({b_by}, {n_ops / 1e12:.2f} TFLOP, {n_bytes / 1e9:.2f} GB)",
              flush=True)
    return dict(err=out, times=times, shape=(L, N, D))


def check_tron(X, Y) -> dict:
    """Batched TRON on the kernel ops ("pallas") against the plain ops
    ("jnp") on the card, at TRON_SHAPE: the same per-label counters on
    >= 99% of labels and f within 1e-4 relative."""
    from repro_torch.core.dismec import DiSMECConfig, train_label_batch
    L, N, D = TRON_SHAPE
    Xs = X[:N, :D].contiguous()
    S = (2.0 * torch.from_numpy(Y[:N, :L].T.astype(np.float32)) - 1.0).cuda()
    res, secs = {}, {}
    for kind in ("jnp", "pallas"):
        cfg = DiSMECConfig(C=1.0, eps=0.01, max_newton=MAX_NEWTON,
                           max_cg=MAX_CG, ops=kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[kind] = train_label_batch(Xs, S, cfg)
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
    a, b = res["pallas"], res["jnp"]
    same = (a.n_newton == b.n_newton) & (a.n_cg == b.n_cg)
    n_diff = int((~same).sum())
    f_rel = float(((a.f - b.f).abs() / b.f.abs()).max())
    print(f"   ({L}, {N}, {D}), max_newton {MAX_NEWTON}, max_cg {MAX_CG}: "
          f"counters differ on {n_diff} of {L} labels; max |f - f_plain| / "
          f"|f_plain| {f_rel:.2e}; converged {int(a.converged.sum())} "
          f"(kernel ops) / {int(b.converged.sum())} (plain ops); Newton "
          f"steps max {int(a.n_newton.max())}, CG steps max "
          f"{int(a.n_cg.max())}; {secs['pallas']:.2f} s on the kernel ops, "
          f"{secs['jnp']:.2f} s on the plain ops", flush=True)
    _need(n_diff <= 0.01 * L, f"TRON counters differ on {n_diff} labels")
    _need(f_rel <= 1e-4, f"TRON objectives differ by {f_rel:.2e}")
    return dict(shape=TRON_SHAPE, labels_differing=n_diff, f_rel=f_rel,
                kernel_s=secs["pallas"], plain_s=secs["jnp"])


@contextlib.contextmanager
def fit_spans():
    """Time the stages of `fit` from outside: each batch's solve on the
    card (synchronised), its BSR pack, its shard write and the finalize,
    as (stage, start, end) on the host clock. The stages are wrapped where
    train/xmc.py looks them up and restored afterwards."""
    from repro_torch.checkpoint import io
    from repro_torch.train import xmc
    spans = []

    def timed(name, fn, sync=False):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            spans.append((name, t0, time.perf_counter()))
            return out
        return wrapper

    saved = (xmc.make_batch_solver, xmc.to_block_sparse,
             io.BlockSparseWriter.write_batch,
             io.BlockSparseWriter.try_finalize)
    xmc.make_batch_solver = lambda *a, **k: timed(
        "solve", saved[0](*a, **k), sync=True)
    xmc.to_block_sparse = timed("pack", saved[1])
    io.BlockSparseWriter.write_batch = timed("write", saved[2])
    io.BlockSparseWriter.try_finalize = timed("finalize", saved[3])
    try:
        yield spans
    finally:
        (xmc.make_batch_solver, xmc.to_block_sparse,
         io.BlockSparseWriter.write_batch,
         io.BlockSparseWriter.try_finalize) = saved


def train(data, ckpt: str, kernel_ms: dict) -> dict:
    """The training path, with the launch counts of all four kernels set
    to 0 just before it: `fit` on the card with the kernel ops."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, fit
    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, eps=0.01,
                                     max_newton=MAX_NEWTON, max_cg=MAX_CG,
                                     ops="pallas"),
                   schedule=ScheduleSpec(label_batch=TRAIN_BATCH),
                   serve=ServeSpec(backend="bsr", k=K))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in (hinge_ops.hinge_obj_grad_cuda, hvp_ops.hvp_cuda,
               bsr_ops.bsr_predict_cuda, topk_ops.blocked_topk_cuda):
        fn.launches = 0
    marks = []
    with fit_spans() as spans:
        t0 = time.perf_counter()
        handle = fit(data.X_train, data.Y_train, spec, ckpt,
                     on_batch=lambda b, n: marks.append(
                         (b, time.perf_counter() - t0)))
        wall = time.perf_counter() - t0
    launches = {"hinge_obj_grad": hinge_ops.hinge_obj_grad_cuda.launches,
                "hvp": hvp_ops.hvp_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    res = handle.result
    _need(res.complete and res.solved == [0, 1],
          f"fit did not complete: {res}")
    _need(all(v > 0 for v in launches.values()),
          f"a training kernel never launched: {launches}")
    shards = res.manifest["shards"]
    n_blocks = sum(e["n_blocks"] for e in shards.values())
    nnz = sum(e["nnz"] for e in shards.values())
    share = {k: launches[k] * kernel_ms[k.split("_")[0]] / 1e3 / wall
             for k in launches}
    print(f"   fit wall {wall:.1f} s; batch written at "
          f"{[round(t, 1) for _, t in marks]} s after the start; launches "
          f"{launches}; kernel share of the wall (launches x per-launch ms "
          f"/ wall): hinge {share['hinge_obj_grad']:.3f}, hvp "
          f"{share['hvp']:.3f}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; checkpoint {n_blocks} blocks, nnz "
          f"{nnz} ({nnz / (TRAIN_LABELS * N_FEATURES):.4f} of the weights)",
          flush=True)
    stages = [dict(stage=n, start_s=a - t0, end_s=b - t0)
              for n, a, b in sorted(spans, key=lambda x: x[1])]
    first_solve = min(st["start_s"] for st in stages if st["stage"] ==
                      "solve")
    print(f"   stages (s from the start of fit): before the first solve "
          f"(data fingerprint, X to the card) 0.0-{first_solve:.2f}; " +
          "; ".join(f"{st['stage']} {st['start_s']:.2f}-{st['end_s']:.2f}"
                    for st in stages), flush=True)
    kernel_s = sum(launches[k] * kernel_ms[k.split("_")[0]] / 1e3
                   for k in launches)
    solve_s = sum(st["end_s"] - st["start_s"] for st in stages
                  if st["stage"] == "solve")
    print(f"   solves {solve_s:.2f} s, of which hinge + HVP launches "
          f"{kernel_s:.2f} s and the rest of TRON (elementwise updates, "
          f"one bool read per CG and Newton step) {solve_s - kernel_s:.2f}"
          f" s", flush=True)
    return dict(wall_s=wall, batch_done_s=[t for _, t in marks],
                launches=launches, kernel_share=share,
                peak_gib=peak / 2**30, n_blocks=n_blocks, nnz=nnz,
                stages=stages, solve_s=solve_s, kernel_s=kernel_s)


def serve_trained(ckpt: str, data, margin_tol: float) -> dict:
    """The PR 11 engine over the trained checkpoint, with the serving
    kernels' counts set to 0 just before it: P@1, P@5 and the served ids
    against the plain path on the 512 held-out rows."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.xmc_api import CheckpointHandle
    bsr_ops.bsr_predict_cuda.launches = 0
    topk_ops.blocked_topk_cuda.launches = 0
    handle = CheckpointHandle.open(ckpt)
    _need(handle.spec.serve.backend == "bsr",
          f"trained checkpoint serves on {handle.spec.serve.backend}")
    engine = handle.engine()
    X, Y = data.X_test, data.Y_test
    requests = [X[i:i + SERVE_CHUNK] for i in range(0, len(X), SERVE_CHUNK)]
    t0 = time.perf_counter()
    results = engine.serve(requests)
    t_serve = time.perf_counter() - t0
    launches = {"bsr_predict": bsr_ops.bsr_predict_cuda.launches,
                "blocked_topk": topk_ops.blocked_topk_cuda.launches}
    _need(all(v > 0 for v in launches.values()),
          f"a serving kernel never launched: {launches}")
    labels = np.concatenate([r.labels for r in results])
    _need(labels.shape == (len(X), K) and labels.min() >= 0
          and labels.max() < TRAIN_LABELS, "malformed served labels")
    hits = np.take_along_axis(Y, labels, axis=1)
    p1, p5 = float(hits[:, 0].mean()), float(hits.mean())
    model = engine.backend.model
    decisive = agree = 0
    for x, res in zip(requests, results):
        v, ids = plain_topk(model, x, TRAIN_LABELS)
        rows = (v[:, K - 1] - v[:, K]) > margin_tol
        decisive += int(rows.sum())
        agree += int((res.labels[rows] == ids[rows, :K]).all(axis=1).sum())
    print(f"   {len(X)} held-out rows in {len(requests)} requests "
          f"({t_serve:.2f} s): P@1 {p1:.4f}  P@5 {p5:.4f}; served ids == "
          f"plain ids on {agree}/{decisive} decisive rows (margin > "
          f"{margin_tol:.1e}); launches {launches}", flush=True)
    _need(decisive > 0 and agree == decisive,
          "served ids of the trained model differ from the plain path")
    return dict(p_at_1=p1, p_at_5=p5, agree=agree, decisive=decisive,
                launches=launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").exists():
        sys.exit(f"chip_smoke: {SRC / 'repro_torch'} not found; run from "
                 "a checkout of the repository")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the card")
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint.io import save_block_sparse
    from repro_torch.kernels import _build
    from repro_torch.xmc_api import XMCSpec

    with phase("build"):
        _build.build()
        for name, log in sorted(_build.BUILD_LOGS.items()):
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "entry" in line:
                    print(f"   {name}: {line.strip()}")

    with phase("setup"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"   torch {torch.__version__} (CUDA {torch.version.cuda}) on "
              f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
        print("   torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}; "
              "torch.backends.cudnn.allow_tf32 = "
              f"{torch.backends.cudnn.allow_tf32}")

    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(N_FEATURES)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        with phase("model: Wiki10-31K width, packed batch by batch"):
            t0 = time.perf_counter()
            model = build_model(rng)
            t_gen = time.perf_counter() - t0
            t0 = time.perf_counter()
            save_block_sparse(model, ckpt, meta={
                "n_labels": N_LABELS, "n_features": N_FEATURES,
                "seed": args.seed, "xmc_spec": XMCSpec().to_dict()})
            t_save = time.perf_counter() - t0
            print(f"   {model.n_blocks} blocks ({model.density:.4f} of the "
                  f"grid), {4 * model.blocks.numel() / 1e6:.1f} MB fp32; "
                  f"padded shape {model.shape}; made and packed in "
                  f"{t_gen:.1f} s, saved in {t_save:.1f} s")

        with phase("kernels vs plain versions"):
            flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB
            X = tfidf_rows(rng, max(BSR_N), perm)
            gpu_model = model.to("cuda")
            bsr = check_bsr(gpu_model, X, flush)
            from repro_torch.kernels.bsr_predict import ops as bsr_ops
            x = torch.from_numpy(X).cuda()
            scores = bsr_ops.bsr_predict(x, gpu_model)
            scores[:, N_LABELS:] = -3.0e38
            topk = check_topk(scores, flush)
            del gpu_model, scores, x, flush
            smi_run = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                 "temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            print(f"   after timing: clocks.sm, power.draw, temperature: "
                  f"{smi_run}")

        with phase("serve: CheckpointHandle.open(dir).engine(), bsr"):
            requests = [tfidf_rows(rng, n, perm) for n in REQUEST_ROWS]
            requests[ZERO_REQUEST][:] = 0.0
            err = max(r["max_abs_err"] for r in bsr["sweep"])
            served = serve(ckpt, requests, max(1e-7, 10 * err))
        del model, requests

    from repro_torch.data.xmc import make_xmc_dataset
    with phase("train data: Wiki10-31K width"):
        data = make_xmc_dataset(n_train=TRAIN_N, n_test=TEST_N,
                                n_features=N_FEATURES,
                                n_labels=TRAIN_LABELS, beta=TRAIN_BETA,
                                seed=args.seed, name="wiki10_31k_width")
        st = data.stats()
        print(f"   X_train {data.X_train.shape} "
              f"({data.X_train.nbytes / 1e9:.2f} GB fp32), feature density "
              f"{st['feat_density']:.2e}, labels per row {st['ALpP']:.2f}, "
              f"rows per label {st['APpL']:.2f}, tail labels (<= 5 rows) "
              f"{st['tail_leq5']:.3f}", flush=True)

    with phase("train kernels vs plain versions (1,024, 14,146, 101,938)"):
        flush = torch.empty(64 * 2**20, device="cuda")       # 256 MB
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        Xd = torch.from_numpy(data.X_train).cuda()
        Sd = (2.0 * torch.from_numpy(
            data.Y_train[:, :TRAIN_BATCH].T.astype(np.float32))
            - 1.0).cuda().contiguous()
        train_k = check_train_kernels(Xd, Sd, gen, flush)
        del Sd, flush
        torch.cuda.empty_cache()

    with phase("TRON: kernel ops vs plain ops on the card"):
        tron = check_tron(Xd, data.Y_train)
        del Xd
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        with phase("train: fit(X, Y, spec, dir) on the card"):
            trained = train(data, ckpt, {k: v["ms"] for k, v in
                                         train_k["times"].items()})
        with phase("serve trained: CheckpointHandle.open(dir).engine()"):
            served_t = serve_trained(ckpt, data, max(1e-7, 10 * err))

    head = next(r for r in bsr["sweep"] if r["n"] == HEADLINE_N)
    kernels = [
        dict(name="bsr_predict", route="cuda",
             source="src/repro_torch/csrc/bsr_predict.cu",
             replaces="src/repro/kernels/bsr_predict/kernel.py:31",
             launches=served["launches"]["bsr_predict"],
             max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
             bound_ms=head["bound_ms"], bound_by=head["bound_by"],
             library_ms=head["library_ms"], library=bsr["library"],
             at=f"n={HEADLINE_N}", sweep=bsr["sweep"]),
        dict(name="blocked_topk", route="cuda",
             source="src/repro_torch/csrc/topk.cu",
             replaces="src/repro/kernels/topk/kernel.py:25",
             launches=served["launches"]["blocked_topk"],
             max_abs_err=topk["max_abs_err"], ms=topk["ms"],
             plain_ms=topk["plain_ms"], bound_ms=topk["bound_ms"],
             bound_by=topk["bound_by"], library_ms=topk["library_ms"],
             library="torch.topk(scores, 5).values",
             at=f"({topk['n']}, {topk['L']}) k={K}"),
    ]
    at = "(L, N, D) = ({}, {}, {})".format(*train_k["shape"])
    for name, key, src, replaces, err_key in (
            ("hinge_obj_grad", "hinge", "hinge.cu",
             "src/repro/kernels/hinge/kernel.py:52", "W~N(0,1)"),
            ("hvp", "hvp", "hvp.cu", "src/repro/kernels/hvp/kernel.py:34",
             "hvp")):
        t = train_k["times"][key]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, launches=trained["launches"][name],
            max_abs_err=train_k["err"][err_key], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library="the two torch.matmul products, TF32 off", at=at))
    print(json.dumps({"kernels": kernels, "serve": {
        k: served[k] for k in ("p50_ms", "p99_ms", "load_s", "warmup_s",
                               "peak_mib", "agree", "decisive",
                               "request_64_ms")}}))
    print(json.dumps({"train": {**trained, "tron": tron,
                                "serve_trained": served_t}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
