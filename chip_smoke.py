#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--seed 0]      # from the root of a checkout

Drives the port's serving path at the full width of Wiki10-31K
(L = 30,938 labels, D = 101,938 features; Extreme Classification
Repository, DiSMEC paper Table 1) with 128 x 128 blocks at 5% block
density, weights drawn from the seed:

  1. build   — both CUDA kernels with nvcc for sm_90a (register and
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

The second-last lines are the kernels' JSON summary and the card's name
and power limit from nvidia-smi; the last line is
`{"ok": true, "device": {...}}`. Any failure exits non-zero before it.
Without a CUDA card, or outside a checkout, it exits non-zero at once.
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


def plain_topk(model, x: np.ndarray):
    """The plain path: plain BSR predict, padding masked, stable sort."""
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.kernels.topk import ref as topk_ref
    Lp, Dp = model.shape
    xp = torch.nn.functional.pad(torch.from_numpy(x).cuda(),
                                 (0, Dp - x.shape[1]))
    s = bsr_ref.bsr_predict(xp, model.blocks, model.block_rows,
                            model.block_cols, Lp // model.block_shape[0])
    s[:, N_LABELS:] = topk_ref.NEG_INF
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
    print(json.dumps({"kernels": kernels, "serve": {
        k: served[k] for k in ("p50_ms", "p99_ms", "load_s", "warmup_s",
                               "peak_mib", "agree", "decisive",
                               "request_64_ms")}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
