#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--seed 0]      # from the root of a checkout

Drives the port's XMC serving, training, async-server and lifecycle paths
at the full width of Wiki10-31K (L = 30,938 labels, D = 101,938 features,
N = 14,146 training documents; Extreme Classification Repository, DiSMEC
paper Table 1).
Serving uses 128 x 128 blocks at 5% block density, weights drawn from the
seed:

  1. build   — all five CUDA sources with nvcc for sm_90a, one nvcc each,
               all at once, beside the making of phase 4's model
               (register and shared-memory lines of `-Xptxas -v` printed
               once phase 3 needs the kernels);
  2. setup   — the card's name and power limit; TF32 off for matmul and
               cuDNN, so every plain version runs in full fp32;
  3. kernels — each kernel against its plain PyTorch version at the
               shapes the serving path gives it (BSR predict at n = 1, 8,
               32, 64, 256; blocked top-k on the unpadded (256, 30,976),
               k = 5, against the plain version on the scores padded to
               31,232; rows of exact zeros where tie order decides), timed
               with CUDA events over cold-L2 launches beside its bound, its
               plain version and one PyTorch library call computing the
               same function; the top-k also at (1, 30,976), the LM's
               (2, 32,001) and padded, and the whole `topk` beside
               `torch.topk`; the int8 BSR kernel's two designs
               (`gather_kernel` and `bsr_kernel`) timed apart at n = 1, 8,
               16, 32, 64, the same bits;
  4. serve   — the model packed label batch by label batch, saved with
               `save_block_sparse` on a thread while phase 3 runs (the
               compressed write takes ~70 s of one core; before phase 19
               it ran alone; phase 5's data is made beside the rest of
               it), then `CheckpointHandle.open(dir)
               .engine()` on the default `bsr` backend serving ragged
               requests; both kernels' launch counts must be > 0 in that
               run, and the served ids must equal the plain path's ids on
               every row whose k-th/(k+1)-th margin is decisive; latency
               p50 / p99 over the requests of at most 64 rows beside the
               25 ms limit (`meets_limit`), the 300-row one on its own
               (so in every serving configuration);
  4b. shortlist and int8 kernels — the int8 BSR, gathered BSR, gathered
               int8 BSR, per-query gathered BSR and per-query gathered int8
               BSR kernels against their plain versions on the same model
               (int8 from `quantize_block_sparse`), at the selection the
               checkpoint's centroid coarse stage gives at the default
               B = 31 of 242 row blocks, n = 1, 32, 256; bit for bit:
               the gathered kernels at a sorted full selection equal the
               exhaustive ones, each checked row of a per-query batch
               (every row to n = 32, 32 rows spread over n = 256) equals
               that row run alone, per query and through the shared
               kernel, the per-query kernels over full lists equal the
               exhaustive ones and, with every row at the shared
               selection, the shared ones; empty row blocks and the
               sentinel score exact zeros; the int8, gathered, gathered
               int8, per-query and per-query int8 kernels repeat bit for
               bit over 50 launches and over launches on two streams at
               once; timed like 3; the per-query kernels timed at n =
               1, 8, 32, 64, 256 beside their bounds;
  4c. serve: shortlist, shortlist per-query, shortlist int8, shortlist
               int8 per-query, int8 — the same checkpoint and requests
               through each of those `ServeSpec`s: each configuration's
               kernel launched in its
               run, the served ids equal to its plain path's (the same
               selection, plain versions, a stable sort) on every decisive
               row, recall@5 against `bsr` and int8-vs-fp32 agreement
               reported.

Then training, on the port's synthetic power-law data at Wiki10-31K width
(N = 14,146, D = 101,938; 2 of Wiki10-31K's 31 batches of 1,024 labels):

  5. train data    — `make_xmc_dataset` (the JAX package's generator,
                     copied) from the seed: 2,048 labels, beta = 0.9, 512
                     held-out rows; X_train is 5.77 GB of dense fp32
                     (made beside phase 4's save);
  6. train kernels — the hinge kernel (at W = 0 and at a random W) and the
                     HVP kernel (at a random V, with the hinge kernel's
                     mask) against their plain versions at (1,024, 14,146,
                     101,938), X in `fit`'s layout (16-byte-aligned rows),
                     two launches bit-identical, timed like 3 beside both
                     bounds (split fp32 on the tensor cores, FFMA); grad
                     and Hv of kernel and plain version against fp64
                     products over the first 128 labels; the HGMMA count
                     of each library's SASS (> 0); each kernel's passes
                     timed apart under `torch.profiler`; the hinge kernel
                     on a contiguous X (its wrapper copies it into aligned
                     rows) timed and equal bit for bit;
  7. TRON          — batched TRON on the kernel ops against the plain ops
                     at (256, 4,096, 16,384): per-label Newton and CG
                     counts equal on >= 99% of labels, f within 1e-4;
  8. train         — `fit(X, Y, spec, dir)` on the card with the kernel
                     ops, max_newton = 10 and max_cg = 20, label_batch
                     1,024, `shortlist_kind="learned"`: a complete
                     two-batch checkpoint whose coarse stage is the learned
                     one, solved on the card; the hinge and HVP launch
                     counts must be > 0 in that run;
  9. serve trained — `CheckpointHandle.open(dir).engine()` on `bsr`,
                     `shortlist` and `shortlist` per query over the 512
                     held-out rows: P@1 and P@5, recall@5 against `bsr`,
                     the served ids equal to the plain path's on every
                     decisive row, and each configuration's kernels
                     launched.
 10. server        — the async request path: a `ModelRouter` over two
                     `CheckpointHandle.server()`s of the serving
                     checkpoint (`wiki_bsr` on `bsr`; `wiki_pq_int8` on
                     `shortlist`, int8, per query, B = 31 of 242), each
                     with a 2 ms launch deadline, 256 queued requests at
                     most and two batches in flight; 300 open-loop Poisson
                     requests at 100/s of 1-8 rows, routed at random;
                     after request 150 `router.refresh` hot-swaps
                     `wiki_bsr` onto the trained checkpoint, and the
                     traffic goes on until 30 wiki_bsr requests came after
                     the refresh returned; then 300 more requests with no
                     swap, the control of what the swap costs the tail;
                     then the swap window again, refreshing `wiki_bsr`
                     back onto the serving checkpoint with each array
                     copied to the card in one piece, the control of the
                     16 MB pieces `refresh` copies the model in (the
                     copies stall the serving threads while they run).
                     Both swap windows run under `torch.profiler`
                     and print what the trace shows (copies per stream,
                     request-copy waits, kernel launch-to-start delay).
                     Every accepted future resolves, every answer equals
                     the plain path's ids under the model that served it
                     on decisive rows, and `wiki_bsr`'s answers are a
                     clean cut: old model, then new, in each swap window;
 10b. mesh train   — `fit(X, Y, spec, dir, mesh=...)` with phase 8's
                     spec (centroid coarse stage) on a (1, 2) mesh, a
                     (2, 1) mesh with `shard_data` and a (2, 2) mesh with
                     `shard_data` and `balance`, every cell cuda:0, then
                     on ScheduleSpec(mesh=(1, device_count())).make_mesh()
                     over the distinct cards: against phase 8's
                     checkpoint, the packed weights within 1e-5 of their
                     magnitude and the objectives within 1e-4 (label
                     sharding), or within SHARD_DATA_TOL (`shard_data`,
                     another summation order, and a control: phase 8's
                     fit on permuted rows), a weight pruned on one side
                     only within the bound of Delta, and whether they are
                     equal bit for bit, the TRON counters equal on >= 99%
                     of the labels, the served ids equal on every held-out
                     row decisive for both checkpoints, the hinge and HVP
                     kernels launched under label sharding and not under
                     `shard_data` (torch ops there, as the JAX package's
                     are jnp);
 10c. mesh serve   — phase 4's checkpoint and requests through
                     `ServeSpec(backend="sharded")` on a (1, 4) mesh of
                     cuda:0 and on the default mesh (one shard per card):
                     the top-k kernel launched, the served ids equal to the
                     plain path's and to `bsr`'s on every decisive row and
                     on the zero row;
 11. sweep         — `lifecycle.sweep` on the training data's first 1,024
                     labels: arms base, same and delta_0.05, two workers,
                     the 512 held-out rows; `same` must be the base's
                     fixed point, bit for bit;
 12. CLI           — `python -m repro_torch.launch.serve --xmc --server`
                     with a `bsr` and a `shortlist` int8 model at the CLI's
                     default sizes, sent SIGTERM once it offers load: it
                     must drain the router and exit 143.
 12b. baselines    — the paper's comparison methods
                     (`repro_torch.baselines`): (a) Table 2 on the JAX
                     package's four `load_paper_like` datasets (seed 0),
                     DiSMEC through `fit` (label batch min(L, 256), the
                     kernel ops, served through `bsr`), SLEEC, LEML,
                     FastXML, PD-Sparse and L1-SVM at their defaults, all
                     on the card: P@1/3/5, nDCG@3/5 and train_s, and the
                     headline (DiSMEC within 0.02 of the best P@1,
                     reported); each baseline's `predict_topk` must launch
                     the top-k kernel (count set to 0 just before it) and
                     give the plain path's ids (the stable sort on the same
                     scores) on every row; on wiki31k_like each baseline
                     trained on the card is held to the port trained on
                     the CPU (a thread at nice 10 from phase 11 on; bounds
                     at BASE_TOL), and PD-Sparse trained twice must be equal
                     bit for bit; (b) at Wiki10-31K width on phase 5's
                     data, L1-SVM (lam 0.05, 300 steps) on phase 8's first
                     label batch beside phase 8's model on those labels
                     (density, P@1, P@5, ambiguous fraction and weight
                     histogram: Fig. 2 and Fig. 4), and FastXML (5 trees,
                     depth 8) over all 2,048 labels: build and predict
                     time, P@k, the top-k kernel and the plain path's ids
                     as in (a). LEML, SLEEC and PD-Sparse stay at the
                     paper-like sizes, and the phase prints why.

Then the LM side's serving path, hymba-1.5b (arXiv:2411.13676) at full
width in bf16 with its sliding window on (29 of 32 layers local), weights
drawn from the seed:

 13. lm kernel   — the banded-attention kernel against its plain version
                   at hymba's heads (H, KV, hd, window) = (25, 5, 64,
                   1,024): (B, T) = (1, 32,768) and (2, 2,304) in bf16,
                   (2, 2,304) in fp32, (1, 768) with the window beyond T;
                   within 3e-2 (bf16) and 2e-4 (fp32), two launches bit
                   for bit, timed like 3 beside its bound (TFLOP/s and the
                   share of the bound printed) and
                   `F.scaled_dot_product_attention` with a band mask; the
                   HGMMA count of the library's SASS (> 0: bf16 runs on
                   the tensor cores);
 14. lm prefill  — `build_model(cfg).prefill` at (1, 32,768) on the
                   kernel (launched exactly 29 times), on the plain
                   version and on the plain version in fp32: tokens/s,
                   peak memory, top-5 ids on a decisive row, every layer's
                   k/v caches; then one kernel prefill under
                   `torch.profiler`: the ten device operations that take
                   the most time, with their totals;
 15. lm decode   — (a) `prefill` at (2, 2,304) against 2,304
                   teacher-forced `decode_step`s on a cache of 2,304, at
                   hymba's width cut to 4 layers (0 and 3 global): every
                   layer's k/v caches and the last position's top-5 ids
                   on decisive rows, then `torch.profiler` over 5 decode
                   steps (device against host time a step); (b) `serve_batch` of 4 ragged prompts
                   of 4-12 tokens for 16 greedy steps, the top-k kernel
                   launched once a step; (c) `python -m
                   repro_torch.launch.serve --arch hymba-1.5b --steps 16
                   --batch 4` exits 0.

Then LM training (`train/trainer.py`), which launches none of the ten
kernels (their counts set to 0 before the phase and read after):

 16. lm train    — (a) hymba-1.5b-smoke and qwen1.5-0.5b-smoke in fp32,
                   both heads: `make_train_step` with accum = 2 for 3
                   steps on the card against the port on the CPU (each
                   loss, the first gradients, `adamw_update` of the card's
                   gradients), and twice on the card, bit for bit; (b)
                   hymba-1.5b at full width in bf16, T = 4,096 (train_4k's
                   length), micro-batch 1 x accum 2, 3 steps of
                   TokenPipeline batches: first the same first batch's
                   loss and gradients in bf16 (under `torch.profiler`)
                   against an fp32 copy of the weights, then seconds a
                   step, tokens/s, peak memory and the share of the bf16
                   peak, the loss finite and falling; (c) `python -m
                   repro_torch.launch.train --arch hymba-1.5b --smoke
                   --steps 10 --seq-len 128 --batch 8 --out DIR` exits 0
                   with its loss falling, and `restore_pytree(DIR)` equals
                   the same training in this process bit for bit. This
                   CLI and phase 18 (e)'s two start together at the start
                   of the phase and run beside (a) and (b)'s untimed fp32
                   pass (one after another, each in its phase, before
                   phase 19); (b) waits for them to exit before its
                   profile and steps. Their walls are to their exit, as
                   the processes ran, sharing the host and the card.

Then the moe, ssm and prefix families (ROADMAP A-8c), weights drawn
from the seed:

 17. lm families — (a) the smoke configs of qwen2-moe-a2.7b,
                   mixtral-8x22b, xlstm-125m and internvl2-26b in fp32
                   on the card against the port on the CPU: prefill,
                   8 decode steps, a `make_train_step` with accum = 2, the
                   dropped counts, and twice on the card, bit for bit; (b)
                   qwen2-moe-a2.7b at full width (24 layers, bf16):
                   prefill (1, 4,096) with the share of assignments
                   dropped in each layer, the expert product's two routes
                   timed, prefill against 128 teacher-forced decode steps
                   at capacity factor 15 (layer 0's k/v bit for bit),
                   `serve_batch`, the serving CLI, two training steps at 2
                   layers; (c) mixtral-8x22b at full width cut to 2
                   layers: prefill (1, 8,192) on kernel 10 (launched once
                   a layer) and on its plain version, then kernel 10 alone
                   at (1, 8,192, 48, 8, 128, 4,096), timed as phase 13;
                   (d) xlstm-125m: prefill (2, 4,096), prefill against
                   256 decode steps, 3 training steps at (2, 1,024);
                   (e) internvl2-26b at full width: prefill of a 256-patch
                   prefix and 1,792 tokens, bit for bit the prefill of the
                   2,048 tokens whose embeddings the prefix holds; two
                   training steps with a prefix at 4 layers.

Then the encoder-decoder and LM training over a mesh (ROADMAP A-8e):

 18. encdec, mesh — (a) seamless-m4t-medium's smoke config (fp32) on the
                   card against the port on the CPU as 17a (its frames,
                   four caches), and the mesh step (`make_train_step`,
                   accum 2, batch axes ("data",)) of qwen1.5, qwen2-moe,
                   xlstm and seamless smoke on a (2, 2) grid of cuda:0
                   against the same on a grid of the CPU, the MoE's drops
                   by shard equal, twice bit for bit; (b) seamless whole
                   (bf16, 0.88 B parameters): prefill of 1,024 frames and
                   4,096 tokens, prefill (2, 256) against 256 decode steps
                   from an empty cache holding its memory k/v (layer 0's
                   self k/v bit for bit); (c) 3 training steps at T =
                   4,096, bf16 against an fp32 copy on the first batch;
                   (d) seamless in fp32 at (2, 1,024) on the (2, 2) grid
                   against one device, twice bit for bit, and qwen2-moe
                   (2 layers) on (2, 1): each shard's drops equal to its
                   rows run alone; (e) the training CLI for seamless and
                   for qwen1.5 with `--mesh 2x2 --device cuda:0`, each
                   checkpoint equal bit for bit to the same training here.

Then LM serving over a mesh (ROADMAP A-8f), every cell cuda:0:

 19. mesh serve  — (a) the smoke configs of qwen1.5, hymba, qwen2-moe,
                   xlstm and internvl2 (fp32) served on a (2, 2) grid of
                   cuda:0 against the port's (2, 2) grid of the CPU:
                   `prefill(mesh=)`, 8 `decode_step(mesh=)`s from its
                   cache and the MoE's drops by shard and layer, to phase
                   17a's bounds, twice on the card bit for bit; (b)
                   hymba-1.5b whole with phase 13's weights (bf16):
                   prefill (2, 4,096) with `use_swa` on the (2, 2) grid,
                   kernel 10 once in each windowed layer of each row
                   shard (2 x 29) and kernel 9 once a label shard and
                   once for the merge; each row shard's caches bit for
                   bit its row prefilled alone on one device, the top-5
                   ids against that on decisive rows; then 64 decode steps
                   from the mesh cache, each shard's caches again bit for
                   bit its row decoded alone, ms a step beside one
                   device's on the whole batch; (c) qwen2-moe-a2.7b whole, in
                   phase 17b while its weights are there: prefill (2,
                   4,096) on a (2, 1) grid, each row shard's drops per
                   layer equal to its row prefilled alone, the top-5
                   against each row's own prefill, and `generate(mesh=)`
                   of 8 tokens beside one device's. mixtral-8x22b at full
                   depth over several cards is unverified (one card).

The lines before the last are the kernels' JSON summary (all ten
kernels; `launches_mesh` for kernels 1, 2 and 9 counts phases 10b and
10c, `launches_baselines` for kernel 9 phase 12b's predictions), the
training, server, sweep, mesh, LM (phase 16 under "train"), baselines,
LM families (phase 17; kernels 9 and 10 also count its launches
under `launches_families`) and encoder-decoder and mesh (phase 18;
kernel 9's `launches_encdec_mesh`) and LM serving over a mesh (phase 19;
kernels 9 and 10's `launches_mesh_serve`) JSON summaries and the
card's name and power limit from nvidia-smi; the last line is `{"ok":
true, "device": {...}}`.
Any failure exits non-zero before it. Without a CUDA card, or outside a
checkout, it exits non-zero at once.

`python3 chip_smoke.py --planted-faults` runs only phase 8's fit and phase
10b's (2, 1) `shard_data` fit under each of PLANTED_FAULTS (TF32 products;
the last data piece left out of the sums), and prints the checks each
fails: it exits non-zero if a fault passes every check.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
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
# PERF.md section 2: p99 <= 25 ms, enqueue to completion, for requests of
# at most 64 rows; a larger request is reported on its own.
LATENCY_ROWS, LATENCY_LIMIT_MS = 64, 25.0
BSR_N = (1, 8, 32, 64, 256)
HEADLINE_N = 32                                 # a typical micro-batch
# Training: Wiki10-31K's N and D, 2 of its 31 label batches.
TRAIN_N, TRAIN_LABELS, TEST_N = 14_146, 2_048, 512
TRAIN_BATCH = 1_024
TRAIN_BETA = 0.9                                # wiki31k_like
MAX_NEWTON, MAX_CG = 10, 20                     # Algorithm 1 uses 50 and 40
TRON_SHAPE = (256, 4_096, 16_384)               # (L, N, D) of phase 7
SERVE_CHUNK = 64                                # held-out rows per request
# Phase 4c: (label, ServeSpec overrides, the kernel the configuration runs).
SERVE_CONFIGS = (
    ("shortlist", dict(backend="shortlist"), "bsr_gather"),
    ("shortlist per-query", dict(backend="shortlist",
                                 shortlist_per_query=True), "bsr_gather_pq"),
    ("shortlist int8", dict(backend="shortlist", int8=True),
     "bsr_gather_int8"),
    ("shortlist int8 per-query", dict(backend="shortlist", int8=True,
                                      shortlist_per_query=True),
     "bsr_gather_pq_int8"),
    ("int8", dict(backend="int8"), "bsr_predict_int8"),
)
# Phase 9: the trained checkpoint through these.
TRAINED_CONFIGS = (("bsr", dict(backend="bsr"), "bsr_predict"),) + \
    SERVE_CONFIGS[:2]
# Phase 10b: `fit` through these meshes on the one card (label, (data,
# model), shard_data, balance), then on the default mesh over the distinct
# cards. Against phase 8's fit, label shards: the largest weight
# difference within MESH_TOL of the weights' magnitude, every objective
# within MESH_F_TOL relative.
MESH_FITS = (("(1, 2)", (1, 2), False, False),
             ("(2, 1) shard_data", (2, 1), True, False),
             ("(2, 2) shard_data balance", (2, 2), True, True))
MESH_TOL, MESH_F_TOL = 1e-5, 1e-4
# shard_data, and the control (phase 8's fit on permuted rows): the same
# two bounds. At N = 14,146 the truncated TRON solve moves this far under
# any other summation order; on an H100 80GB HBM3 at 700 W the control
# read 0.179 (2.3% of the magnitude 7.7) and 5.10e-4, the (2, 1) and
# (2, 2) fits 0.1956 (2.5%) and 8.97e-4, the same in two runs.
SHARD_DATA_TOL = (0.04, 1.5e-3)
# `--planted-faults`: the served ids' margin (phase 3's kernel error sets
# the main run's; 1e-4 is above any it read).
FAULT_MARGIN = 1e-4
# Phase 10c: the serving checkpoint through `sharded` on this mesh and on
# the default one.
MESH_SERVE = (1, 4)
# Phase 10: the async server under open-loop Poisson traffic.
SERVER_REQUESTS, SERVER_RATE, SERVER_SWAP_AFTER = 300, 100.0, 150
SERVER_MAX_ROWS = 8
# Traffic goes on past request 300 until the refresh has returned and
# this many wiki_bsr requests were offered after it (at most 1,200 in
# all): loading the trained checkpoint takes about 3.5 s and the serving
# one about 6.5 s, longer than the 1.5 s of traffic left after request
# 150.
SERVER_TAIL, SERVER_MAX = 30, 1_200
SERVER_SPEC = dict(max_batch_delay_ms=2.0, max_queue=256)
SERVER_MODELS = (("wiki_bsr", dict(backend="bsr")),
                 ("wiki_pq_int8", dict(backend="shortlist", int8=True,
                                       shortlist_per_query=True)))
# Phase 11: the sweep's arms over one full-width label batch.
SWEEP_LABELS = 1_024
SWEEP_ARMS = {"same": {}, "delta_0.05": {"delta": 0.05}}
# Phase 12b: the paper's comparison methods (`repro_torch.baselines`) on the
# JAX package's Table 2 datasets (`load_paper_like`, seed 0) at their
# defaults, DiSMEC through `fit` with benchmarks/_common.py's label batch.
PAPER_LIKE = ("wiki31k_like", "amazon670k_like", "delicious200k_like",
              "wikilshtc325k_like")
DISMEC_LABEL_BATCH = 256
# On wiki31k_like each baseline trained on the card against the port trained
# on the CPU, to the CPU tests' bounds against the JAX package: L1-SVM's
# weights within 5e-4 of their magnitude and nnz within 0.1%, LEML's and
# SLEEC's scores within 1e-4, FastXML's splits within 1e-5 (leaves equal),
# PD-Sparse's weights within 1e-5. L1-SVM and PD-Sparse are held there
# after CARD_CPU_STEPS steps and, over their full runs, to P@1 and P@5
# within 0.01: both iterations amplify a rounding (FISTA's momentum and
# the l1 prox at this size, PD-Sparse's argmax subgradient at any size).
# SLEEC's scores are compared on the rows whose centroid choice and kNN
# cut are decisive: at a near tie of similarities a rounding swaps a
# neighbour, and with it the row's votes. A cluster whose rank cut splits
# a degenerate singular value of its 0/1 label submatrix has no unique
# embedding: its rows are left out, and counted, wherever the gap at the
# cut is within SLEEC_GAP of the largest singular value. LAPACK's and
# cuSOLVER's Z Z^T differed by about 1e-8 / gap (tools/torch_sleec_svd.py
# on an H100 80GB HBM3 at 700 W: gaps 3.18e-8, 3.28e-4, 9.65e-4 and
# 5.59e-3 gave 0.51, 2.8e-5, 4.9e-6 and 3.7e-6 of its magnitude), so
# below 2e-4 a gap may move the scores past their bound.
CARD_CPU_STEPS = 100
BASE_TOL = {"L1-SVM": 5e-4, "LEML": 1e-4, "SLEEC": 1e-4, "FastXML": 1e-5,
            "PD-Sparse": 1e-5}
BASE_NNZ_TOL, BASE_PK_TOL = 1e-3, 0.01
NEAR_PLANE = 1e-5           # |x.w| below this share of |x|.|w|: on a plane
SLEEC_GAP = 2e-4
# At Wiki10-31K width (phase 5's data): L1-SVM on phase 8's first label
# batch (Fig. 4), FastXML over all TRAIN_LABELS labels.
WIDE_L1 = dict(lam=0.05, n_steps=300)
WIDE_FASTXML = dict(n_trees=5, max_depth=8)
PD_SPARSE_STEPS = 1_500     # train_pd_sparse's default
# Phases 13-15: hymba-1.5b (arXiv:2411.13676) at full width, bf16,
# sliding-window attention on (29 of its 32 layers; 0, 15 and 31 global).
LM_ARCH = "hymba-1.5b"
LM_PREFILL = (1, 32_768)                        # prefill_32k's length
LM_DECODE = (2, 2_304)                          # above DENSE_ATTN_MAX_T
# Phase 15a's model: hymba-1.5b at full width with its depth cut to these
# layers, global attention in the first and last (two local layers
# between). Decode is launch-bound (~2.5 ms a layer a step), and the 32
# layers took 159-184 s of the script's 1,200 for 2,304 steps.
LM_DECODE_LAYERS, LM_DECODE_GLOBAL = 4, (0, 3)
LM_SERVE = dict(batch=4, steps=16)
# Kernel 10 against its plain version: (B, T, dtype) at hymba's heads
# (H, KV, hd, window) = (25, 5, 64, 1024); the last with window >= T.
LM_KERNEL_CASES = ((1, 32_768, "bfloat16"), (2, 2_304, "bfloat16"),
                   (2, 2_304, "float32"), (1, 768, "bfloat16"))
LM_KERNEL_TOL = {"float32": 2e-4, "bfloat16": 3e-2}   # the JAX kernel test's
# The top-5 ids of two paths must be the same five where the 5th-to-6th
# logit margin is above twice the largest rank-wise difference of their
# top-5 values (and above LM_MARGIN). Caches are compared by each layer's
# relative Frobenius error. On the kernel and on the plain version, layers
# 0 and 1 come before any local layer and must be equal bit for bit, layer
# 2, one local layer on, within LM_CACHE_FIRST. Decode against prefill
# (15a): no layer bit for bit (other matrix shapes), layers 0-2 within
# LM_CACHE_FIRST_DECODE. Every layer within LM_CACHE.
# 2e-2 for every layer had been predicted. Measured on the card: the
# kernel matches the plain version run in fp32 to 7e-7 at layer 1's real
# activations, and its bf16 output differs from that one's rounded output
# in 0.04% of the elements; yet every bf16 rounding after it (the mix, the
# residual, the norm, the projections) turns such a difference into whole
# ulps, and the 30 layers above carry the cache difference to ~5e-2 at
# layer 31, whether the seed is that 0.04% or the bf16 plain version's
# 30%; decode against prefill reaches 1.0e-1. The bounds below are about
# twice what was measured; the tight checks are the bit-for-bit layers,
# phase 13, and the CPU tests (prefill against decode in float32).
LM_MARGIN = 5e-2
LM_CACHE_FIRST = 1e-2
LM_CACHE_FIRST_DECODE = 5e-2
LM_CACHE = 2e-1
# Phase 16: LM training, which runs no kernel (the JAX package trains with
# full attention: `train_loss` passes no `use_swa`). (a) The smoke configs
# in fp32, `make_train_step` with accum = 2 on the card against the port on
# the CPU: (accum, micro-batch, T) and steps below; the loss at each step
# within LM_TRAIN_TOL["loss"] relative, the first step's gradients within
# LM_TRAIN_TOL["grad"] of the largest |element| (the CPU tests' bound
# against the JAX package), `adamw_update` of the card's first gradients on
# both sides within LM_TRAIN_TOL["adam"] relative; two card runs bit for
# bit. (b) hymba-1.5b at full width in bf16 at train_4k's length
# (configs/base.py), its global batch of 256 cut to micro-batch 1 x accum 2,
# 3 steps of TokenPipeline batches; the same first batch through an fp32
# copy of the weights: the bf16 loss within LM_TRAIN_TOL["bf16_loss"]
# relative, and the cosine of the bf16 and fp32 gradients of the head and
# of the last block >= LM_TRAIN_TOL["cos"]; the flattened gradients'
# cosine and each group's are reported. In bf16 the early layers'
# gradients are mostly rounding: the backward through a block's norm
# multiplies by 1 / rms(x), ~40 at the embeddings (N(0, 1/d)), on a
# difference of near-equal terms. The JAX package shows it worse than the
# port: at hymba's width, 8 layers, T = 256, on the same weights, its bf16
# gradient has cosine 0.136 with its fp32 one (embed 0.092, block 0 0.138,
# block 7 0.998, head 0.9999), the port's 0.829 (0.765, 0.814, 0.992,
# 0.9998), and the fp32 gradients agree to 0.999999
# (`tools/compare_bf16_grads.py`, on the CPU). On the card, at 32 layers,
# the flattened cosine read 0.2226 (embed and block 0 errors above 100%,
# block 31 16%, the head 1%).
# (c) The training CLI at the smoke size below, then the same training in
# this process: `restore_pytree` of the CLI's checkpoint gives its weights
# bit for bit.
LM_TRAIN_SMOKE = ("hymba-1.5b", "qwen1.5-0.5b")
LM_TRAIN_SMOKE_SHAPE = dict(accum=2, micro=2, T=64, steps=3)
LM_TRAIN_FULL = dict(accum=2, micro=1, T=4096, steps=3)   # 8 before phase 17
LM_TRAIN_LR = (3e-4, 2, 8)       # linear_warmup_cosine: lr > 0 from step 1
LM_TRAIN_CLI = dict(steps=10, seq_len=128, batch=8)  # 20 before phase 18
LM_TRAIN_TOL = dict(loss=1e-4, grad=1e-5, adam=1e-6, bf16_loss=1e-2,
                    cos=0.95)

# Phase 17: the moe, ssm and prefix families (ROADMAP A-8c). (a) Their
# smoke configs in fp32, the card against the port on the CPU: prefill
# (mixtral's at T = 2,304 so that kernel 10 runs, window 32; internvl2's
# with a prefix of 16; the others at 320, past one 256-row mLSTM chunk)
# and FAM_SMOKE["decode"] teacher-forced decode steps from its cache: the
# top-5 values within FAM_SMOKE_TOL["values"] (decode's within
# FAM_SMOKE_TOL["decode"]: one-token attention rounds its softmax weights
# and its output to the bf16 cache's type, as the CPU tests' 1e-2 allows
# for), ids on decisive rows, each
# layer's cache or state within FAM_SMOKE_TOL["cache"] (relative; bf16
# caches round near-equal fp32 values apart by an ulp), the MoE's dropped
# counts equal; `make_train_step` with accum 2 as phase 16 (a), aux within
# FAM_SMOKE_TOL["aux"]; two card runs bit for bit. (b) qwen2-moe-a2.7b at
# full width, 24 layers: prefill at train_4k's length with the share of
# assignments dropped in each layer; prefill against FAM_MOE_DECODE[1]
# teacher-forced decode steps (256 before phase 18, cut for it) at a
# capacity factor of n_experts / top_k
# (nothing can drop), held as phase 15a; serve_batch and the CLI as 15b,
# 15c; two training steps at 2 layers (its AdamW moments do not fit at 24).
# (c) mixtral-8x22b at full width cut to 2 layers: prefill at (1, 8,192)
# on kernel 10 and on its plain version, held as phase 14, then kernel 10
# alone at mixtral's heads. (d) xlstm-125m whole: prefill at (2, 4,096),
# prefill against 256 decode steps (1,024 before phase 18, cut for it; a
# multiple of the mLSTM's 256-row chunk), 3 training steps at T = 1,024
# (4 before phase 18, at 2,048 before phase 19). (e) internvl2-26b
# at full width: prefill of a 256-patch prefix and 1,792 tokens, equal bit
# for bit to the prefill of the 2,048 tokens whose embeddings the prefix
# holds; two training steps with a prefix at 4 layers.
FAM_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b", "xlstm-125m",
             "internvl2-26b")
FAM_SMOKE = dict(T=320, T_swa=2304, decode=8)
FAM_SMOKE_TOL = dict(values=1e-3, decode=1e-2, cache=1e-3, loss=1e-4,
                     grad=1e-5, aux=1e-6)
FAM_MOE = "qwen2-moe-a2.7b"
FAM_MOE_PREFILL = (1, 4096)                     # train_4k's length
FAM_MOE_DECODE = (2, 128)                  # 256 before phase 18
FAM_MOE_TRAIN = dict(layers=2, accum=2, micro=1, T=4096, steps=2)
FAM_MIXTRAL, FAM_MIXTRAL_LAYERS = "mixtral-8x22b", 2
FAM_MIXTRAL_PREFILL = (1, 8192)                 # two windows of 4,096
FAM_XLSTM = "xlstm-125m"
FAM_XLSTM_PREFILL, FAM_XLSTM_DECODE = (2, 4096), (2, 256)  # 1,024 before 18
FAM_XLSTM_TRAIN = dict(accum=2, micro=1, T=1024, steps=3, falling=True)
FAM_VLM, FAM_VLM_TOKENS = "internvl2-26b", 1792
FAM_VLM_TRAIN = dict(layers=4, accum=2, micro=1, T=768, steps=2)

# Phase 18: the encoder-decoder and LM training over a mesh (ROADMAP
# A-8e). (a) The smoke configs, the card against the port on the CPU:
# seamless in fp32 as phase 17a (prefill, FAM_SMOKE["decode"] decode steps
# from its cache, a `make_train_step` with accum 2; FAM_SMOKE_TOL, the four
# caches); and the mesh step (`make_train_step` with accum 2, batch axes
# ED_AXES, ED_MESH_SHAPE's (accum, micro, T)) of each of ED_MESH_ARCHS on
# a grid of ED_MESH cuda:0 cells against the same mesh step of the port on
# a grid of the CPU: the loss within FAM_SMOKE_TOL["loss"], the gradients
# within FAM_SMOKE_TOL["grad"] of the largest, the MoE's dropped counts by
# batch shard and layer equal; each twice on the card, bit for bit. (b)
# seamless-m4t-medium whole in bf16 (12 + 12 layers, d 1,024, vocabulary
# 256,206 padded to 256,512), weights from the seed: prefill of its
# n_prefix = 1,024 frames and ED_PREFILL decoder tokens (train_4k's
# length), tokens/s and peak memory; prefill at ED_DECODE against as many
# teacher-forced decode steps from an empty `init_cache` that holds the
# prefill's memory k/v: layer 0's self k/v bit for bit, every layer within
# LM_CACHE, ids on decisive rows; kernel 9 once a prefill and once a
# decode step. (c) seamless training at full width as phase 16 (b)
# (ED_TRAIN, 1,024 frames from `train_prefix`): bf16 against an fp32 copy
# on the first batch, the loss falling. (d) The mesh at full
# width: seamless in fp32 at ED_MESH_FULL on the ED_MESH grid of cuda:0
# against one device on the same batch, the loss within ED_MESH_TOL["loss"]
# relative and the gradients within ED_MESH_TOL["grad"] of the largest,
# twice bit for bit; qwen2-moe-a2.7b at full width cut to
# ED_MOE_MESH["layers"] layers on ED_MOE_MESH["mesh"]: each batch shard's
# dropped count in each layer equals that of the shard's rows run alone
# (`moe_ffn_local` on that shard's tokens), the loss finite. mixtral-8x22b
# at full depth waits for several cards (ROADMAP A-8f). (e) The training
# CLI for seamless (as phase 16 (c), at ED_CLI's size) and for
# qwen1.5-0.5b with `--mesh 2x2 --device cuda:0`, each checkpoint equal bit
# for bit to the same training in this process. Kernels 1-8 and 10 launch nowhere in the phase.
ED_ARCH = "seamless-m4t-medium"
ED_MESH_ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "xlstm-125m", ED_ARCH)
ED_MESH, ED_AXES = (2, 2), ("data",)
ED_MESH_SHAPE = dict(accum=2, micro=2, T=64)
ED_PREFILL = (1, 4096)                          # train_4k's length
ED_DECODE = (2, 256)
ED_TRAIN = dict(accum=2, micro=1, T=4096, steps=3)
ED_MESH_FULL = dict(B=2, T=1024)
ED_MESH_TOL = dict(loss=1e-5, grad=1e-5)
ED_MOE_MESH = dict(arch="qwen2-moe-a2.7b", layers=2, mesh=(2, 1), B=2,
                   T=4096)
ED_CLI = dict(steps=10, seq_len=64, batch=4)
# Phase 19: LM serving over a mesh (ROADMAP A-8f), every cell cuda:0, batch
# axes ("data",) as the JAX LM launcher's. (a) The smoke configs (fp32) at
# MS_SMOKE on the MS_GRID grid of cuda:0 against the port's grid of the
# CPU: `prefill(mesh=)`, MS_SMOKE["decode"] `decode_step(mesh=)`s from its
# MeshCache (the cache exactly T long, so decode wraps to slot 0 as on one
# device), the MoE's drops by shard and layer; to FAM_SMOKE_TOL's values,
# decode and cache bounds and ids on decisive rows; twice on the card bit
# for bit. (b) hymba-1.5b whole with phase 13's weights (bf16): prefill
# MS_HYMBA with use_swa on the MS_GRID grid, kernel 10 once in each
# windowed layer of each row shard and kernel 9 once a label shard and
# once for the merge; each row shard's caches bit for bit its row
# prefilled alone on one device, the top-5 ids against that on decisive
# rows; then MS_DECODE decode steps from the mesh cache (each shard's k/v
# padded by MS_DECODE slots) against its row decoded alone on one device
# from its own cache: the caches bit for bit, ids on decisive rows; ms a
# step beside one device's on the whole batch. (c) In phase
# 17b, with qwen2-moe-a2.7b's 24 layers: prefill MS_MOE on its grid, each
# row shard's dropped count in each layer equal to its row prefilled
# alone, the top-5 ids against each row's own prefill on decisive rows,
# then `generate(mesh=)` of MS_MOE["generate"] tokens from a prompt of
# MS_MOE["prompt"] beside one device's.
MS_GRID, MS_AXES = (2, 2), ("data",)
MS_SMOKE_ARCHS = ("qwen1.5-0.5b", "hymba-1.5b", "qwen2-moe-a2.7b",
                  "xlstm-125m", "internvl2-26b")
MS_SMOKE = dict(B=4, T=64, decode=8)
MS_HYMBA, MS_DECODE = (2, 4096), 64
MS_MOE = dict(mesh=(2, 1), B=2, T=4096, prompt=8, generate=8)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12                       # dense, tensor cores
TF32_FLOPS_PER_S = 495e12                       # dense, tensor cores
TF32_PRODUCTS = 3         # split fp32: small.big + big.small + big.big


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


def in_background(fn, name: str) -> concurrent.futures.Future:
    """fn() on a thread of its own; the future's `result()` waits for it
    and raises what it raised."""
    pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=name)
    try:
        return pool.submit(fn)
    finally:
        pool.shutdown(wait=False)


def bound(n_bytes: float, n_ops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type (fp32 unless given), whichever
    is larger (ms)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops_per_s * 1e3
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


def queued_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """As `cuda_ms`, but each launch waits behind a ~1 ms spin on the card,
    so the host has queued all of `fn` before the card reaches it: the
    device time alone, without the gaps in which the card waits for the
    host to issue the next operation."""
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
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
    """Kernel vs plain version at n = 1, 8, 32, 64, 256, with times; at
    each n 50 launches and 10 pairs on two streams equal bit for bit.

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
        repeat_check("bsr_predict", lambda: bsr_ops.bsr_predict_cuda(
            x, blocks, cols, ptr, R), n)
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


DESIGN_N = (1, 8, 16, 32, 64)                   # phase 3's design sweep
PQ_SWEEP_N = (1, 8, 32, 64, 256)                # phase 4b's, kernels 7, 8


def check_int8_designs(model, X, flush) -> dict:
    """Kernel 4's two designs timed apart at n = 1, 8, 16, 32, 64 on the
    serving model quantized to int8: `gather_kernel` (each row block its
    own slot) and `bsr_kernel`, forced through the wrapper's switch
    `INT8_GATHER_MAX_N`, beside the design the switch picks; both must
    give the same bits."""
    from unittest import mock

    from repro_torch.core.pruning import quantize_block_sparse
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    q = quantize_block_sparse(model)
    R = model.shape[0] // model.block_shape[0]
    args = (q.blocks, q.scales, q.block_cols, q.row_ptr, R)
    Dp = model.shape[1]
    rows = []
    for n in DESIGN_N:
        x = torch.nn.functional.pad(torch.from_numpy(X[:n]).cuda(),
                                    (0, Dp - N_FEATURES)).contiguous()
        times, outs = {}, {}
        for design, switch in (("gather_kernel", 64), ("bsr_kernel", 0)):
            with mock.patch.object(bsr_ops, "INT8_GATHER_MAX_N", switch):
                outs[design] = bsr_ops.bsr_predict_int8_cuda(x, *args)
                times[design] = cuda_ms(
                    lambda: bsr_ops.bsr_predict_int8_cuda(x, *args), 20,
                    flush)
        torch.cuda.synchronize()
        _need(torch.equal(outs["gather_kernel"], outs["bsr_kernel"]),
              f"kernel 4's two designs give other bits at n={n}")
        picked = ("gather_kernel" if n <= bsr_ops.INT8_GATHER_MAX_N
                  else "bsr_kernel")
        rows.append(dict(n=n, gather_ms=times["gather_kernel"],
                         bsr_kernel_ms=times["bsr_kernel"], picked=picked))
        print(f"   bsr_predict_int8 n={n:2d}: gather_kernel "
              f"{times['gather_kernel']:.4f} ms, bsr_kernel "
              f"{times['bsr_kernel']:.4f} ms, the same bits; dispatched: "
              f"{picked}", flush=True)
    del q
    return dict(switch=bsr_ops.INT8_GATHER_MAX_N, rows=rows)


def check_topk(scores, flush) -> dict:
    """Blocked top-k kernel vs its plain version on the serving path's
    scores at (256, 30,976), k = 5, plus rows where ties decide. Values
    and ids must be identical: the top-k only selects. The kernel reads
    the unpadded scores (as the main path launches it) and gives the
    strip of the scores padded with NEG_INF to 31,232, where the plain
    version runs; timed unpadded at n = 256 and 1 and at the LM's
    (2, 32,001), padded at n = 256, and the whole `topk` beside
    `torch.topk`."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import ref as topk_ref
    n, L = scores.shape
    bL = topk_ops.DEFAULT_BL
    print("   tolerance: none; values and ids identical, because the top-k "
          "only selects")
    padded = torch.nn.functional.pad(scores, (0, (-L) % bL),
                                     value=topk_ref.NEG_INF).contiguous()
    v_k, i_k = topk_ops.blocked_topk_cuda(scores, K, bL=bL)
    v_kp, i_kp = topk_ops.blocked_topk_cuda(padded, K, bL=bL)
    v_p, i_p = topk_ref.blocked_topk(padded, K, bL=bL)
    torch.cuda.synchronize()
    _need(all(torch.equal(a, b) for a, b in ((v_k, v_p), (i_k, i_p),
                                             (v_kp, v_p), (i_kp, i_p))),
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
    cases = {}
    lm = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32_001)).astype(np.float32)).cuda()
    for key, s in (("(256, 30976)", scores), ("(1, 30976)", scores[:1]),
                   ("(2, 32001) LM", lm), ("(256, 31232) padded", padded)):
        s = s.contiguous()
        want = topk_ref.blocked_topk(torch.nn.functional.pad(
            s, (0, (-s.shape[1]) % bL), value=topk_ref.NEG_INF), K, bL=bL)
        got = topk_ops.blocked_topk_cuda(s, K, bL=bL)
        torch.cuda.synchronize()
        _need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"top-k kernel disagrees with its plain version at {key}")
        n_out = s.shape[0] * -(-s.shape[1] // bL) * K
        n_bytes = 4 * s.numel() + 8 * n_out
        b_ms, b_by = bound(n_bytes, K * s.numel())
        # The whole topk is several launches (the kernel, the sort, the
        # gather): five repeats of 50 as launched give its spread, and the
        # queued time says how much of it is the card waiting on the host.
        whole = [cuda_ms(lambda: topk_ops.topk(s, K), 50, flush)
                 for _ in range(5)]
        cases[key] = dict(ms=cuda_ms(lambda: topk_ops.blocked_topk_cuda(
            s, K, bL=bL), 50, flush), ms_queued=queued_ms(
            lambda: topk_ops.blocked_topk_cuda(s, K, bL=bL), 50, flush),
            bound_ms=b_ms, bound_by=b_by,
            topk_ms=float(np.median(whole)),
            topk_ms_range=[min(whole), max(whole)],
            topk_queued_ms=queued_ms(lambda: topk_ops.topk(s, K), 50, flush),
            library_ms=cuda_ms(lambda: torch.topk(s, K).values, 50, flush))
        print(f"   topk {key} k={K}: kernel {cases[key]['ms']:.4f} ms "
              f"(queued {cases[key]['ms_queued']:.4f}), "
              f"bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB); whole "
              f"topk {cases[key]['topk_ms']:.4f} ms (5 x 50 launches: "
              f"{min(whole):.4f}-{max(whole):.4f}; queued "
              f"{cases[key]['topk_queued_ms']:.4f}), torch.topk "
              f"{cases[key]['library_ms']:.4f} ms", flush=True)
    main = cases["(256, 30976)"]
    plain_ms = cuda_ms(lambda: topk_ref.blocked_topk(padded, K, bL=bL), 10,
                       flush)
    print(f"   topk ({n}, {L}) k={K}: max|kernel-plain| {err:.1e}, ids "
          f"identical (tie rows too)  kernel {main['ms']:.4f} ms (padded "
          f"{cases['(256, 31232) padded']['ms']:.4f} ms)  plain "
          f"{plain_ms:.4f} ms  torch.topk {main['library_ms']:.4f} ms  "
          f"bound {main['bound_ms']:.4f} ms", flush=True)
    return dict(n=n, L=L, max_abs_err=err, ms=main["ms"], plain_ms=plain_ms,
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], cases=cases)


def sparse_bsr(blocks, cols, crow, shape):
    """`torch.sparse_bsr_tensor` over packed blocks, as the function x ->
    (A @ x.T).T: the library yardstick of the BSR kernels (built outside
    the timed region; the port never calls it)."""
    A = torch.sparse_bsr_tensor(crow, cols, blocks, size=shape,
                                check_invariants=False)
    return lambda x: (A @ x.T).T


def repeat_check(name: str, kernel, n: int, launches: int = 50,
                 pairs: int = 10) -> None:
    """`launches` launches of `kernel` on one input, then `pairs` pairs on
    two streams at once: each output equal to the first bit for bit (the
    kernels use no atomics and sum in a fixed order, so a race would
    show)."""
    first = kernel()
    outs = [kernel() for _ in range(launches)]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for _ in range(pairs):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(kernel())
    torch.cuda.synchronize()
    same = sum(torch.equal(o, first) for o in outs)
    _need(same == len(outs), f"{name} at n={n}: {len(outs) - same} of "
          f"{len(outs)} repeated launches differ from the first")
    print(f"   {name} n={n:3d}: {launches} launches and {pairs} pairs on "
          "two streams equal to the first bit for bit", flush=True)


def pq_contracts(x, sel, sel_pq, full, fp, i8, R: int) -> int:
    """Contracts (c) to (e) of kernels 7 and 8 and the skewed case, bit for
    bit (torch.equal): (c), (d) each checked row's per-query scores in the
    batch equal the row run alone, per query and through the shared
    kernel 5 or 6; every row at n <= 32, 32 rows spread over a larger n;
    (e) per query over full lists equals kernel 3 or 4 at n; skewed, every
    row given the shared selection, equals kernel 5 or 6 at n. Returns
    the rows checked."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    n = x.shape[0]
    rows = (range(n) if n <= 32 else
            np.linspace(0, n - 1, 32).round().astype(int).tolist())
    for tag, pq, shared, exhaustive, args in (
            ("(c) per-query", bsr_ops.bsr_predict_gather_pq_cuda,
             bsr_ops.bsr_predict_gather_cuda, bsr_ops.bsr_predict_cuda, fp),
            ("(d) per-query int8", bsr_ops.bsr_predict_gather_pq_int8_cuda,
             bsr_ops.bsr_predict_gather_int8_cuda,
             bsr_ops.bsr_predict_int8_cuda, i8)):
        batch = pq(x, *args, sel_pq)
        for i in rows:
            xi = x[i:i + 1].contiguous()
            alone = pq(xi, *args, sel_pq[i:i + 1])
            _need(torch.equal(batch[i:i + 1], alone)
                  and torch.equal(alone, shared(xi, *args,
                                                sel_pq[i].contiguous())),
                  f"{tag}: row {i} of {n} differs from the row run alone")
        _need(torch.equal(pq(x, *args, full.repeat(n, 1).contiguous()),
                          exhaustive(x, *args, R)),
              f"(e) {tag[4:]} over full lists != exhaustive at n={n}")
        _need(torch.equal(pq(x, *args, sel.repeat(n, 1).contiguous()),
                          shared(x, *args, sel)),
              f"{tag[4:]}: every row at the shared selection != shared at "
              f"n={n}")
    return len(rows)


def check_pq_sweep(model, q, centroids, X, flush) -> list:
    """Kernels 7 and 8 at n = 1, 8, 32, 64, 256 on the serving model at the
    centroid selection, timed like phase 3 beside the bound."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.serve import xmc
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    R = Lp // bl
    B = -(-R // 8)
    ptr = model.row_ptr
    rows = []
    for n in PQ_SWEEP_N:
        x = torch.nn.functional.pad(torch.from_numpy(X[:n]).cuda(),
                                    (0, Dp - N_FEATURES)).contiguous()
        sel_pq = xmc._shortlist_select_pq(x, centroids, B).contiguous()
        nu = int(torch.unique(bsr_ref.selected_blocks(
            ptr, sel_pq.reshape(-1))[0]).numel())
        common = 4 * n * Dp + 4 * (R + 1) + 4 * n * B + 4 * n * B * bl
        for name, kernel, n_bytes in (
                ("bsr_gather_pq", lambda: bsr_ops.bsr_predict_gather_pq_cuda(
                    x, model.blocks, model.block_cols, ptr, sel_pq),
                 4 * nu * bl * bd + 4 * nu + common),
                ("bsr_gather_pq_int8",
                 lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(
                     x, q.blocks, q.scales, q.block_cols, ptr, sel_pq),
                 nu * bl * bd + 8 * nu + common)):
            ms = cuda_ms(kernel, 20, flush)
            b_ms, b_by = bound(n_bytes, bsr_ops.gather_pq_flops(model,
                                                                sel_pq))
            rows.append(dict(name=name, n=n, ms=ms, bound_ms=b_ms,
                             bound_by=b_by))
            print(f"   {name} n={n:3d}: {ms:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
    return rows


def check_shortlist_int8(model, q, centroids, X, flush) -> dict:
    """Kernels 4-8 against their plain versions on the serving model, at
    the selection the checkpoint's centroid coarse stage gives at the
    default B, at n = 1, 32, 256; the contracts bit for bit; exact zeros
    for an empty selected row block and for the sentinel; times beside
    the bound, the plain version and a library call.

    Tolerance: |kernel - plain| <= 1e-5 * (|x| @ |W|^T) per score, with
    |W| = |q| * scale for int8 blocks, as in `check_bsr`: both sides sum
    the same fp32 products (int8 widened exactly, each block's partial
    multiplied by its scale) in another order."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.serve import xmc
    bl, bd = model.block_shape
    Lp, Dp = model.shape
    R = Lp // bl
    B = -(-R // 8)                                 # the artifact's default
    nb = model.n_blocks
    blocks, rows, cols, ptr = (model.blocks, model.block_rows,
                               model.block_cols, model.row_ptr)
    qb, qs = q.blocks, q.scales
    qabs = qb.abs()
    deq = qb.float() * qs[:, None, None]
    lib_int8 = sparse_bsr(deq, cols, ptr, (Lp, Dp))
    full = torch.arange(R, dtype=torch.int32, device="cuda")
    print(f"   B = {B} of {R} row blocks; tolerance: |kernel - plain| <= "
          "1e-5 * (|x| @ |W|^T) per score, |W| = |q| * scale for int8, "
          "because both sum the same fp32 products in another order; the "
          "contracts bit for bit (torch.equal)")
    sweeps = {k: [] for k in ("bsr_predict_int8", "bsr_gather",
                              "bsr_gather_int8", "bsr_gather_pq",
                              "bsr_gather_pq_int8")}
    for n in BSR_N:
        x = torch.nn.functional.pad(torch.from_numpy(X[:n]).cuda(),
                                    (0, Dp - N_FEATURES)).contiguous()
        sel = xmc._shortlist_select(x, centroids, B)
        sel_pq = xmc._shortlist_select_pq(x, centroids, B).contiguous()
        ids, _ = bsr_ref.selected_blocks(ptr, sel)
        counts = (ptr[sel.long() + 1] - ptr[sel.long()]).long()
        crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
        union = torch.unique(bsr_ref.selected_blocks(ptr,
                                                     sel_pq.reshape(-1))[0])
        ns, nu = int(ids.numel()), int(union.numel())
        common = 4 * n * Dp + 4 * (R + 1)          # x, row_ptr
        cases = {
            "bsr_predict_int8": (
                lambda: bsr_ops.bsr_predict_int8_cuda(x, qb, qs, cols, ptr, R),
                lambda: bsr_ref.bsr_predict_int8(x, qb, qs, rows, cols, R),
                lambda: bsr_ref.bsr_predict_int8(x.abs(), qabs, qs, rows,
                                                 cols, R),
                lib_int8,
                nb * bl * bd + 8 * nb + common + 4 * n * Lp,
                bsr_ops.model_flops(model, n)),
            "bsr_gather": (
                lambda: bsr_ops.bsr_predict_gather_cuda(x, blocks, cols, ptr,
                                                        sel),
                lambda: bsr_ref.bsr_predict_gather(x, blocks, cols, ptr, sel),
                lambda: bsr_ref.bsr_predict_gather(x.abs(), blocks.abs(),
                                                   cols, ptr, sel),
                sparse_bsr(blocks[ids], cols[ids], crow, (B * bl, Dp)),
                4 * ns * bl * bd + 4 * ns + 4 * B + common + 4 * n * B * bl,
                bsr_ops.gather_flops(model, n, sel)),
            "bsr_gather_int8": (
                lambda: bsr_ops.bsr_predict_gather_int8_cuda(x, qb, qs, cols,
                                                             ptr, sel),
                lambda: bsr_ref.bsr_predict_gather_int8(x, qb, qs, cols, ptr,
                                                        sel),
                lambda: bsr_ref.bsr_predict_gather_int8(x.abs(), qabs, qs,
                                                        cols, ptr, sel),
                sparse_bsr(deq[ids], cols[ids], crow, (B * bl, Dp)),
                ns * bl * bd + 8 * ns + 4 * B + common + 4 * n * B * bl,
                bsr_ops.gather_flops(model, n, sel)),
            "bsr_gather_pq": (
                lambda: bsr_ops.bsr_predict_gather_pq_cuda(x, blocks, cols,
                                                           ptr, sel_pq),
                lambda: bsr_ref.bsr_predict_gather_pq(x, blocks, cols, ptr,
                                                      sel_pq),
                lambda: bsr_ref.bsr_predict_gather_pq(x.abs(), blocks.abs(),
                                                      cols, ptr, sel_pq),
                None,
                4 * nu * bl * bd + 4 * nu + 4 * n * B + common
                + 4 * n * B * bl,
                bsr_ops.gather_pq_flops(model, sel_pq)),
            "bsr_gather_pq_int8": (
                lambda: bsr_ops.bsr_predict_gather_pq_int8_cuda(
                    x, qb, qs, cols, ptr, sel_pq),
                lambda: bsr_ref.bsr_predict_gather_pq_int8(x, qb, qs, cols,
                                                           ptr, sel_pq),
                lambda: bsr_ref.bsr_predict_gather_pq_int8(
                    x.abs(), qabs, qs, cols, ptr, sel_pq),
                None,
                nu * bl * bd + 8 * nu + 4 * n * B + common + 4 * n * B * bl,
                bsr_ops.gather_pq_flops(model, sel_pq)),
        }
        for name, (kernel, plain, magnitude, lib, n_bytes, n_ops) in \
                cases.items():
            got, want, mag = kernel(), plain(), magnitude()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            _need(bool(torch.isfinite(got).all())
                  and bool(((got - want).abs() <= 1e-5 * mag).all()),
                  f"{name} kernel disagrees with its plain version at n={n}:"
                  f" max |diff| {err:.3e}")
            del got, want, mag
            ms = cuda_ms(kernel, 20, flush)
            plain_ms = cuda_ms(plain, 3 if "pq" in name else 5, flush)
            lib_ms = None if lib is None else cuda_ms(lambda: lib(x), 10,
                                                      flush)
            b_ms, b_by = bound(n_bytes, n_ops)
            sweeps[name].append(dict(
                n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                blocks_read=nu if "pq" in name else
                ns if "gather" in name else nb))
            lib_txt = ("no library call" if lib_ms is None else
                       f"sparse BSR {lib_ms:.4f} ms")
            print(f"   {name} n={n:3d}: max|kernel-plain| {err:.3e}  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  {lib_txt}  bound "
                  f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB, "
                  f"{n_ops / 1e9:.2f} GFLOP)", flush=True)
        # Contracts (a) to (e), bit for bit.
        _need(torch.equal(bsr_ops.bsr_predict_gather_cuda(x, blocks, cols,
                                                          ptr, full),
                          bsr_ops.bsr_predict_cuda(x, blocks, cols, ptr, R)),
              f"(a) gathered at arange(R) != exhaustive at n={n}")
        _need(torch.equal(bsr_ops.bsr_predict_gather_int8_cuda(
            x, qb, qs, cols, ptr, full),
            bsr_ops.bsr_predict_int8_cuda(x, qb, qs, cols, ptr, R)),
            f"(b) gathered int8 at arange(R) != int8 at n={n}")
        checked = pq_contracts(x, sel, sel_pq, full, (blocks, cols, ptr),
                               (qb, qs, cols, ptr), R)
        print(f"   n={n:3d}: contracts (a), (b), (c) and (d) on {checked} "
              "rows, (e) in fp32 and int8, and every row at the shared "
              f"selection hold bit for bit; shared selection {ns} blocks, "
              f"per-query union {nu} blocks", flush=True)
        for name in ("bsr_predict_int8", "bsr_gather", "bsr_gather_int8",
                     "bsr_gather_pq", "bsr_gather_pq_int8"):
            repeat_check(name, cases[name][0], n)
    # Row block 0 emptied (its packed blocks dropped) and the sentinel.
    p1 = int(ptr[1])
    e_ptr = (ptr - p1).clamp_min(0).int()
    e_sel = torch.tensor([0, 5], dtype=torch.int32, device="cuda")
    outs = [bsr_ops.bsr_predict_gather_cuda(x, blocks[p1:], cols[p1:], e_ptr,
                                            e_sel),
            bsr_ops.bsr_predict_gather_int8_cuda(x, qb[p1:], qs[p1:],
                                                 cols[p1:], e_ptr, e_sel),
            bsr_ops.bsr_predict_gather_pq_cuda(
                x, blocks[p1:], cols[p1:], e_ptr,
                e_sel.repeat(x.shape[0], 1).contiguous()),
            bsr_ops.bsr_predict_gather_pq_int8_cuda(
                x, qb[p1:], qs[p1:], cols[p1:], e_ptr,
                e_sel.repeat(x.shape[0], 1).contiguous())]
    ref5 = bsr_ops.bsr_predict_gather_cuda(x, blocks, cols, ptr, e_sel[1:])
    torch.cuda.synchronize()
    _need(all(bool((o[:, :bl] == 0).all()) for o in outs)
          and torch.equal(outs[0][:, bl:], ref5),
          "an empty selected row block does not score exact zeros")
    zf = torch.zeros((1, bl, bd), device="cuda")
    zq = torch.zeros((1, bl, bd), dtype=torch.int8, device="cuda")
    zs = torch.zeros((1,), device="cuda")
    zi = torch.zeros((1,), dtype=torch.int32, device="cuda")
    zp = torch.zeros((R + 1,), dtype=torch.int32, device="cuda")
    outs = [bsr_ops.bsr_predict_int8_cuda(x, zq, zs, zi, zp, R),
            bsr_ops.bsr_predict_gather_cuda(x, zf, zi, zp, sel),
            bsr_ops.bsr_predict_gather_int8_cuda(x, zq, zs, zi, zp, sel),
            bsr_ops.bsr_predict_gather_pq_cuda(x, zf, zi, zp, sel_pq),
            bsr_ops.bsr_predict_gather_pq_int8_cuda(x, zq, zs, zi, zp,
                                                    sel_pq)]
    torch.cuda.synchronize()
    _need(all(bool((o == 0).all()) for o in outs),
          "the sentinel model does not score exact zeros")
    print("   an empty selected row block and the sentinel model score "
          "exact zeros in all five kernels")
    return dict(B=B, R=R, sweeps=sweeps)


def serving_kernels() -> dict:
    """Every serving kernel's launcher, whose `.launches` counts its
    launches, by the name the kernels' JSON line gives it."""
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    from repro_torch.kernels.topk import ops as topk_ops
    return {"bsr_predict": bsr_ops.bsr_predict_cuda,
            "bsr_predict_int8": bsr_ops.bsr_predict_int8_cuda,
            "bsr_gather": bsr_ops.bsr_predict_gather_cuda,
            "bsr_gather_int8": bsr_ops.bsr_predict_gather_int8_cuda,
            "bsr_gather_pq": bsr_ops.bsr_predict_gather_pq_cuda,
            "bsr_gather_pq_int8": bsr_ops.bsr_predict_gather_pq_int8_cuda,
            "blocked_topk": topk_ops.blocked_topk_cuda}


def plain_backend_topk(be, x: torch.Tensor):
    """The plain path of one padded micro-batch through backend `be`: its
    own selection (shortlist), the plain versions of its kernels, padding
    labels masked and a stable sort; (values, ids) with K + 1 columns. For
    `sharded`: the product with each shard's rows, side by side."""
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.kernels.topk import ref as topk_ref
    if be.name == "sharded":
        s = torch.cat([(x.to(w.device) @ w.T).to(x.device)
                       for w in be._shards], dim=1)
        ids = torch.arange(s.shape[1], device=x.device)
        v, i = topk_ref.topk(torch.where(ids < be.n_labels, s,
                                         topk_ref.NEG_INF), K + 1)
        return v.cpu().numpy(), i.long().cpu().numpy()
    m = be.model
    bl = m.block_shape[0]
    Lp, Dp = m.shape
    xp = torch.nn.functional.pad(x, (0, Dp - x.shape[1]))
    if be.name == "shortlist":
        sel = be._select(x)
        q = be.int8_model
        if be.per_query and be.int8:
            s = bsr_ref.bsr_predict_gather_pq_int8(xp, q.blocks, q.scales,
                                                   q.block_cols, q.row_ptr,
                                                   sel)
        elif be.per_query:
            s = bsr_ref.bsr_predict_gather_pq(xp, m.blocks, m.block_cols,
                                              m.row_ptr, sel)
        elif be.int8:
            s = bsr_ref.bsr_predict_gather_int8(xp, q.blocks, q.scales,
                                                q.block_cols, q.row_ptr, sel)
        else:
            s = bsr_ref.bsr_predict_gather(xp, m.blocks, m.block_cols,
                                           m.row_ptr, sel)
        label_ids = (sel.long()[..., None] * bl
                     + torch.arange(bl, device=x.device)).flatten(-2)
    else:
        if be.name == "int8":
            s = bsr_ref.bsr_predict_int8(xp, m.blocks, m.scales, m.block_rows,
                                         m.block_cols, Lp // bl)
        else:
            s = bsr_ref.bsr_predict(xp, m.blocks, m.block_rows, m.block_cols,
                                    Lp // bl)
        label_ids = torch.arange(Lp, device=x.device)
    s = torch.where(label_ids < be.n_labels, s, topk_ref.NEG_INF)
    v, i = topk_ref.topk(s, K + 1)
    i = i.long()
    ids = (label_ids[i] if label_ids.dim() == 1
           else torch.gather(label_ids, 1, i))
    return v.cpu().numpy(), ids.cpu().numpy()


def plain_engine_topk(engine, x: np.ndarray):
    """The plain path of one request: the micro-batches the engine's queue
    makes of it, each through `plain_backend_topk`, un-padded."""
    from repro_torch.serve.batching import MicroBatchQueue
    queue = MicroBatchQueue(engine.queue.buckets)
    queue.submit(x)
    vs, ids = [], []
    for mb in queue.drain():
        v, i = plain_backend_topk(engine.backend,
                                  torch.from_numpy(mb.x).cuda())
        vs.append(v[:sum(mb.row_counts)])
        ids.append(i[:sum(mb.row_counts)])
    return np.concatenate(vs), np.concatenate(ids)


def breakdown(engine, x: np.ndarray, reps: int = 21) -> dict:
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


def drive(ckpt: str, requests, overrides: dict, kernel: str,
          margin_tol: float, n_labels: int, mesh=None):
    """One serving configuration on the main path: every serving launch
    count set to 0 just before `CheckpointHandle.open(ckpt).engine(spec,
    mesh=mesh)` with `overrides` on the checkpoint's ServeSpec, the engine
    warmed and the requests served one at a time, the counts read just
    after. Its kernel and the top-k must have launched, and the served ids
    must equal the plain path's on every row whose k-th/(k+1)-th margin is
    decisive. Latency p50 / p99 over the requests of at most LATENCY_ROWS
    rows, beside LATENCY_LIMIT_MS; larger requests on their own. Returns
    (engine, served labels (rows, K), stats, decisive rows (bool, rows))."""
    from repro_torch.xmc_api import CheckpointHandle
    kernels = serving_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    handle = CheckpointHandle.open(ckpt)
    engine = handle.engine(handle.spec.serve.replace(warmup=False,
                                                     **overrides), mesh=mesh)
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
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    spans = engine.stats.samples()               # one a request, in order
    small = [ms for x, ms in zip(requests, spans)
             if x.shape[0] <= LATENCY_ROWS]
    lat = {"p50_ms": float(np.percentile(small, 50)),
           "p99_ms": float(np.percentile(small, 99))}
    large = [dict(rows=x.shape[0], ms=ms) for x, ms in zip(requests, spans)
             if x.shape[0] > LATENCY_ROWS]
    _need(launches.get(kernel, 0) > 0 and launches.get("blocked_topk", 0) > 0,
          f"{overrides}: a kernel of the path never launched: {launches}")
    decisive = agree = 0
    mask = []
    for i, (x, res) in enumerate(zip(requests, results)):
        _need(res.labels.shape == (x.shape[0], K)
              and np.isfinite(res.scores).all()
              and 0 <= res.labels.min() and res.labels.max() < n_labels,
              f"{overrides}, request {i}: malformed result")
        v, ids = plain_engine_topk(engine, x)
        if not x.any():                           # a row of zeros
            _need(res.labels.tolist() == [list(range(K))]
                  and ids[:, :K].tolist() == [list(range(K))],
                  f"{overrides}: zero row served {res.labels.tolist()}")
        rows = (v[:, K - 1] - v[:, K]) > margin_tol
        mask.append(rows)
        decisive += int(rows.sum())
        agree += int((res.labels[rows] == ids[rows, :K]).all(axis=1).sum())
    n_rows = sum(x.shape[0] for x in requests)
    _need(decisive > 0 and agree == decisive,
          f"{overrides}: served ids differ from the plain path on "
          f"{decisive - agree} of {decisive} decisive rows")
    frac = float(getattr(engine.backend, "candidate_fraction", 1.0))
    print(f"   {engine.backend.name} {overrides}: open + load {t_load:.2f} s, "
          f"warm-up of {n_warm} buckets {t_warm:.2f} s; {len(requests)} "
          f"requests; the {len(small)} of <= {LATENCY_ROWS} rows: p50 "
          f"{lat['p50_ms']:.3f} ms  p99 {lat['p99_ms']:.3f} ms (enqueue to "
          f"completion; limit {LATENCY_LIMIT_MS} ms: meets_limit "
          f"{lat['p99_ms'] <= LATENCY_LIMIT_MS}); per request "
          f"{[round(w, 3) for w in wall]} ms; candidate fraction "
          f"{frac:.4f}; max_memory_allocated {peak / 2**20:.1f} MiB; "
          f"launches {launches}; served ids == plain ids on "
          f"{agree}/{decisive} rows with a decisive margin (> "
          f"{margin_tol:.1e}) of {n_rows} rows", flush=True)
    for r in large:
        print(f"   the {r['rows']}-row request: {r['ms']:.3f} ms (enqueue "
              "to completion; not under the limit)", flush=True)
    labels = np.concatenate([r.labels for r in results])
    return engine, labels, dict(
        launches=launches, p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
        p99_limit_ms=LATENCY_LIMIT_MS,
        meets_limit=lat["p99_ms"] <= LATENCY_LIMIT_MS, large_requests=large,
        load_s=t_load, warmup_s=t_warm, peak_mib=peak / 2**20, agree=agree,
        decisive=decisive, candidate_fraction=frac), np.concatenate(mask)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Mean share of each row's K ids of `b` found among those of `a`
    (recall@K of a against b)."""
    return float(np.mean([len(set(r) & set(s)) / K for r, s in zip(a, b)]))


def serve(ckpt: str, requests, margin_tol: float) -> dict:
    """The main path on the default `bsr` backend (phase 4)."""
    from repro_torch.xmc_api import CheckpointHandle
    _need(CheckpointHandle.open(ckpt).spec.serve.backend == "bsr",
          "the checkpoint's default backend is not bsr")
    engine, labels, stats, _ = drive(ckpt, requests, {}, "bsr_predict",
                                     margin_tol, N_LABELS)
    stats["request_64_ms"] = breakdown(engine, requests[REQUEST_ROWS.index(64)])
    return dict(stats, labels=labels)


def serve_configs(ckpt: str, requests, margin_tol: float,
                  bsr_labels: np.ndarray) -> dict:
    """Phase 4c: each of SERVE_CONFIGS on the main path, its request split,
    recall@5 against `bsr` and the int8 configurations' agreement with
    their fp32 counterparts (share of rows with the same K ids in order)."""
    out, labels = {}, {"bsr": bsr_labels}
    for name, overrides, kernel in SERVE_CONFIGS:
        engine, labels[name], stats, _ = drive(ckpt, requests, overrides,
                                               kernel, margin_tol, N_LABELS)
        stats["request_64_ms"] = breakdown(
            engine, requests[REQUEST_ROWS.index(64)])
        stats["recall_at_5_vs_bsr"] = overlap(labels[name], bsr_labels)
        if "int8" in name:
            fp32 = labels[name.replace(" int8", "").replace("int8", "bsr")]
            stats["same_ids_as_fp32"] = float(
                (labels[name] == fp32).all(axis=1).mean())
        print(f"   {name}: recall@5 vs bsr "
              f"{stats['recall_at_5_vs_bsr']:.4f}" +
              (f"; same ids as fp32 on {stats['same_ids_as_fp32']:.4f} of "
               "rows" if "int8" in name else ""), flush=True)
        out[name] = stats
        del engine
    return out


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


def hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in kernel library `name`'s SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sass.count("HGMMA")


def fp64_shares(W, X, S, V, act, C, g, g_p, hv, hv_p, rows: int = 128):
    """The largest |error| / magnitude of the kernels' and the plain
    versions' grad and Hv against fp64 products of the same fp32 inputs,
    over the first `rows` labels."""
    Wd, Vd, Sd, ad = (t[:rows].double() for t in (W, V, S, act))
    Xd = X.double()
    out = {}
    for key, A, kern, plain, shift in (("grad", Wd, g, g_p, Sd),
                                       ("hvp", Vd, hv, hv_p, None)):
        scores = A @ Xd.T
        inner = ad * (scores - shift if shift is not None else scores)
        exact = 2.0 * A + 2.0 * C * (inner @ Xd)
        m = A.abs() @ Xd.abs().T
        if shift is not None:
            m = m + shift.abs()
        mag = (2.0 * A.abs() + 2.0 * C * ((ad * m) @ Xd.abs())).clamp_min(
            1e-300)
        out[key] = {
            "kernel": float(((kern[:rows].double() - exact).abs()
                             / mag).max()),
            "plain": float(((plain[:rows].double() - exact).abs()
                            / mag).max())}
        del scores, inner, exact, m, mag
    del Xd
    torch.cuda.empty_cache()
    return out


def pass_ms(fn, launches: int = 3) -> dict:
    """Median device ms of each CUDA kernel that `fn` launches (a training
    kernel's split and passes), over `launches` calls under
    `torch.profiler`, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times: dict = {}
    for _ in range(launches):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            if us > 0:
                key = re.sub(r"^void |\(anonymous namespace\)::|"
                             r"split_tf32::|\(.*$", "", e.key)
                times.setdefault(key, []).append(us / 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    return dict(sorted(med.items(), key=lambda kv: -kv[1]))


def check_train_kernels(X, S, gen, flush) -> dict:
    """Hinge and HVP kernels against their plain versions at the trainer's
    shape (L, N, D) = (1,024, 14,146, 101,938), with times. X comes in the
    layout `fit` gives it (16-byte-aligned rows, read by TMA); the same
    launches on a contiguous copy (which the wrapper copies into aligned
    rows) must give the same bits."""
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hinge import ref as hinge_ref
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.kernels.hvp import ref as hvp_ref
    C = 1.0
    L, (N, D) = S.shape[0], X.shape
    print("   tolerance: f, grad and Hv within 1e-5 of the same sums over "
          "absolute values, per element, because both sides sum the same "
          "fp32 products in another order (split fp32, three TF32 products "
          "a k-step, in the kernels; fp32 GEMM with TF32 off in the plain "
          "versions); act identical wherever |z| > 1e-5, where no such "
          "rounding can flip it; two launches identical bit for bit (no "
          "atomics, fixed order)")
    hgmma = {k: hgmma_count(k) for k in ("hinge", "hvp")}
    print(f"   HGMMA instructions in the SASS (cuobjdump -sass): {hgmma}")
    _need(all(v > 0 for v in hgmma.values()),
          f"a training kernel library has no HGMMA instruction: {hgmma}")
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
        del f_p, act_p, f_mag, g_mag, z, decided, again
    W = W_rand
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
    del mag, again
    f64 = fp64_shares(W, X, S, V, act, C, g, g_p, hv, hv_p)
    print("   against fp64 products over the first 128 labels, largest "
          "share of the magnitude: grad kernel {:.2e}, plain {:.2e}; Hv "
          "kernel {:.2e}, plain {:.2e}".format(
              f64["grad"]["kernel"], f64["grad"]["plain"],
              f64["hvp"]["kernel"], f64["hvp"]["plain"]), flush=True)
    del g_p, hv_p

    r = act * (W @ X.T - S)
    u = act * (V @ X.T)
    n_ops = 2 * 2 * L * N * D                 # two dense contractions each
    hinge_bytes = 4 * (2 * L * D + N * D + 2 * L * N + L)
    hvp_bytes = 4 * (2 * L * D + N * D + L * N)
    ffma_ms = n_ops / FP32_FLOPS_PER_S * 1e3
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
        b_ms, b_by = bound(n_bytes, TF32_PRODUCTS * n_ops, TF32_FLOPS_PER_S)
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           bound_ffma_ms=ffma_ms,
                           tflops=n_ops / ms / 1e9,
                           tf32_tflops=TF32_PRODUCTS * n_ops / ms / 1e9,
                           fp64_share=f64["grad" if name == "hinge"
                                          else "hvp"])
        print(f"   {name} ({L}, {N}, {D}): kernel {ms:.3f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s of fp32 work; "
              f"{TF32_PRODUCTS * n_ops / ms / 1e9:.1f} TFLOP/s of TF32 "
              f"products)  plain {plain_ms:.3f} ms  two torch.matmul "
              f"{lib_ms:.3f} ms  bounds: split fp32 at 495 TFLOP/s "
              f"{b_ms:.3f} ms ({b_by}, {TF32_PRODUCTS * n_ops / 1e12:.2f} "
              f"TFLOP; kernel at {b_ms / ms:.1%} of it), FFMA at 67 "
              f"TFLOP/s {ffma_ms:.3f} ms ({n_ops / 1e12:.2f} TFLOP); "
              f"{n_bytes / 1e9:.2f} GB", flush=True)
        times[name]["pass_ms"] = passes = pass_ms(fn)
        print(f"   {name} passes (torch.profiler, median of 3): " + (
            ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items())
            or "no device time in the trace"), flush=True)
    del r, u
    torch.cuda.empty_cache()
    Xc = X.contiguous()                       # rows 8-byte aligned only
    ms_c = cuda_ms(lambda: hinge_ops.hinge_obj_grad_cuda(W, Xc, S, C), 3,
                   flush)
    same = all(torch.equal(a, b) for a, b in zip(
        hinge_ops.hinge_obj_grad_cuda(W, Xc, S, C),
        hinge_ops.hinge_obj_grad_cuda(W, X, S, C)))
    _need(same, "the hinge kernel gives other bits on a contiguous X")
    times["hinge"]["contiguous_x_ms"] = ms_c
    print(f"   hinge on a contiguous X (row stride {D}, copied by the "
          f"wrapper into aligned rows): {ms_c:.3f} ms, the same bits as on "
          "the 16-byte-aligned rows", flush=True)
    del Xc
    torch.cuda.empty_cache()
    return dict(err=out, times=times, shape=(L, N, D), hgmma=hgmma,
                fp64=f64)


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
    card (synchronised), its BSR pack, its shard write, the finalize and
    the learned coarse stage's solve (synchronised), as (stage, start,
    end) on the host clock. The stages are wrapped where train/xmc.py and
    xmc_api.py look them up and restored afterwards."""
    from repro_torch.checkpoint import io
    from repro_torch.serve import shortlist
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
             io.BlockSparseWriter.try_finalize,
             shortlist.build_learned_shortlist)
    xmc.make_batch_solver = lambda *a, **k: timed(
        "solve", saved[0](*a, **k), sync=True)
    xmc.to_block_sparse = timed("pack", saved[1])
    io.BlockSparseWriter.write_batch = timed("write", saved[2])
    io.BlockSparseWriter.try_finalize = timed("finalize", saved[3])
    shortlist.build_learned_shortlist = timed("learned coarse stage",
                                              saved[4], sync=True)
    try:
        yield spans
    finally:
        (xmc.make_batch_solver, xmc.to_block_sparse,
         io.BlockSparseWriter.write_batch,
         io.BlockSparseWriter.try_finalize,
         shortlist.build_learned_shortlist) = saved


def train(data, ckpt: str, kernel_ms: dict | None) -> dict:
    """The training path, with the launch counts of every kernel set to 0
    just before it: `fit` on the card with the kernel ops, building the
    learned coarse stage (on the card, with the plain ops, as the JAX
    package's builder uses its default ops). `kernel_ms`: phase 6's
    per-launch ms of the hinge and HVP kernels, for their share of the
    wall."""
    from repro_torch.checkpoint.io import load_shortlist
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, fit
    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, eps=0.01,
                                     max_newton=MAX_NEWTON, max_cg=MAX_CG,
                                     ops="pallas"),
                   schedule=ScheduleSpec(label_batch=TRAIN_BATCH),
                   serve=ServeSpec(backend="bsr", k=K,
                                   shortlist_kind="learned"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in (hinge_ops.hinge_obj_grad_cuda, hvp_ops.hvp_cuda,
               *serving_kernels().values()):
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
    art = load_shortlist(ckpt)
    _need(art is not None and art.kind == "learned"
          and np.isfinite(art.centroids).all(),
          "fit did not write a learned coarse stage")
    _need(all(v > 0 for v in launches.values()),
          f"a training kernel never launched: {launches}")
    shards = res.manifest["shards"]
    n_blocks = sum(e["n_blocks"] for e in shards.values())
    nnz = sum(e["nnz"] for e in shards.values())
    # Without phase 6's per-launch times the kernels' shares are NaN.
    kernel_ms = kernel_ms or {"hinge": math.nan, "hvp": math.nan}
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
    """The trained checkpoint through each of TRAINED_CONFIGS on the main
    path (`drive`) over the 512 held-out rows: P@1, P@5, recall@5 against
    `bsr`, and the served ids against the plain path."""
    X, Y = data.X_test, data.Y_test
    requests = [X[i:i + SERVE_CHUNK] for i in range(0, len(X), SERVE_CHUNK)]
    out, bsr_labels = {}, None
    for name, overrides, kernel in TRAINED_CONFIGS:
        engine, labels, stats, _ = drive(ckpt, requests, overrides, kernel,
                                         margin_tol, TRAIN_LABELS)
        del engine
        bsr_labels = labels if bsr_labels is None else bsr_labels
        hits = np.take_along_axis(Y, labels, axis=1)
        stats.update(p_at_1=float(hits[:, 0].mean()),
                     p_at_5=float(hits.mean()),
                     recall_at_5_vs_bsr=overlap(labels, bsr_labels))
        print(f"   {name}: P@1 {stats['p_at_1']:.4f}  P@5 "
              f"{stats['p_at_5']:.4f}  recall@5 vs bsr "
              f"{stats['recall_at_5_vs_bsr']:.4f}", flush=True)
        out[name] = stats
    return out


@contextlib.contextmanager
def tron_counters():
    """Record every batched TRON solve of `core/dismec.py` while the block
    runs: (label shard, n_newton, n_cg, f) in the order the solves end. A
    mesh submits each label shard's solve to its thread pool as
    `solve_shard(j, ...)`; the pool is swapped for one that records j on
    the thread running it (None for a solve run outside a pool). A batch's
    shards all end before the next batch starts."""
    from repro_torch.core import dismec
    calls, lock = [], threading.Lock()
    saved_solve, saved_pool = dismec.tron_solve, dismec.ThreadPoolExecutor
    tag = threading.local()

    class ShardPool(saved_pool):
        def submit(self, fn, j, *args):
            def tagged():
                tag.shard = j
                try:
                    return fn(j, *args)
                finally:
                    del tag.shard
            return super().submit(tagged)

    def recorded(*a, **k):
        res = saved_solve(*a, **k)
        with lock:
            calls.append((getattr(tag, "shard", None), res.n_newton.cpu(),
                          res.n_cg.cpu(), res.f.cpu()))
        return res
    dismec.tron_solve, dismec.ThreadPoolExecutor = recorded, ShardPool
    try:
        yield calls
    finally:
        dismec.tron_solve, dismec.ThreadPoolExecutor = saved_solve, saved_pool


def label_counters(calls, n_shards: int, Y, balance: bool) -> np.ndarray:
    """(3, TRAIN_LABELS): the Newton and CG counts and the final objective
    of each label, from the recorded solves of the training batches: a
    batch's shards in shard order, the balanced dealing undone."""
    from repro_torch.core.dismec import balance_permutation
    out = []
    for b in range(TRAIN_LABELS // TRAIN_BATCH):
        group = calls[b * n_shards:(b + 1) * n_shards]
        shards = [c[0] for c in group]
        want = [None] if n_shards == 1 else list(range(n_shards))
        _need(sorted(shards, key=lambda j: -1 if j is None else j) == want,
              f"batch {b}: recorded solves of label shards {shards}, not "
              f"{want}")
        group = sorted(group, key=lambda c: c[0] or 0)
        c = np.stack([torch.cat([g[i] for g in group]).double().numpy()
                      for i in (1, 2, 3)])
        if balance:
            c = c[:, np.argsort(balance_permutation(
                Y[:, b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH], n_shards))]
        out.append(c)
    return np.concatenate(out, axis=1)


def packed_weights(ckpt: str) -> torch.Tensor:
    """A training checkpoint's weights, dense (TRAIN_LABELS, N_FEATURES),
    on the card."""
    from repro_torch.checkpoint.io import load_block_sparse
    model, _ = load_block_sparse(ckpt, device="cuda")
    return model.to_dense()[:TRAIN_LABELS, :N_FEATURES].contiguous()


def served_held_out(ckpt: str, X: np.ndarray) -> np.ndarray:
    """The held-out rows through `CheckpointHandle.open(ckpt).engine()` on
    `bsr`, SERVE_CHUNK rows a request."""
    from repro_torch.specs import ServeSpec
    from repro_torch.xmc_api import CheckpointHandle
    engine = CheckpointHandle.open(ckpt).engine(ServeSpec(backend="bsr", k=K,
                                                          warmup=False))
    res = engine.serve([X[i:i + SERVE_CHUNK]
                        for i in range(0, len(X), SERVE_CHUNK)])
    return np.concatenate([r.labels for r in res])


def weights_against(W, ref_W, count, ref_count, tol: float) -> dict:
    """A trained model (dense weights, per-label counters and objective)
    against the reference's: the largest weight difference, the weights
    pruned on one side only, those outside `tol` (a weight pruned on one
    side only must lie within `tol` of Delta, where the prune moved),
    bit-for-bit equality, the labels with equal TRON counters and the
    largest relative objective difference."""
    diff = (W - ref_W).abs()
    flips = (W == 0) != (ref_W == 0)
    bad = ~((diff <= tol) | (flips & (torch.maximum(W.abs(), ref_W.abs())
                                      < DELTA + tol)))
    same = (count[:2] == ref_count[:2]).all(axis=0)
    return dict(max_abs_diff=float(diff.max()), flips=int(flips.sum()),
                outside=int(bad.sum()),
                labels_outside=int(bad.any(dim=1).sum()),
                bit_for_bit=bool(torch.equal(W, ref_W)), tol=tol,
                counters_equal=int(same.sum()),
                f_rel=float((np.abs(count[2] - ref_count[2])
                             / np.abs(ref_count[2])).max()))


@contextlib.contextmanager
def tf32_products():
    """A planted fault: every fp32 product on the card in TF32, as the
    `shard_data` closures' would be with TF32 left on."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def last_piece_dropped():
    """A planted fault: the `shard_data` closures sum over every instance
    piece but the last."""
    from repro_torch.core import dismec
    saved = dismec._data_sharded_ops
    dismec._data_sharded_ops = lambda pieces, *a: saved(pieces[:-1], *a)
    try:
        yield
    finally:
        dismec._data_sharded_ops = saved


# `chip_smoke.py --planted-faults`: the (2, 1) shard_data fit under each
# of these (what, the fault); phase 10b's checks must catch every one.
PLANTED_FAULTS = (("TF32 products", tf32_products),
                  ("last data piece dropped", last_piece_dropped))


def train_meshes(data, ref_ckpt: str, ref_calls, margin_tol: float,
                 out_root: str, seed: int, *, faults: bool = False) -> dict:
    """Phase 10b: `fit` on each of MESH_FITS (every cell cuda:0) and on the
    default mesh of ScheduleSpec(mesh=(1, device_count())) over the
    distinct cards, each against phase 8's single-device checkpoint.

    Label sharding runs the same kernels on the same rows of each label,
    so the packed weights must lie within MESH_TOL of their magnitude (a
    weight pruned on one side only within it of Delta), and every label's
    objective within MESH_F_TOL. With `shard_data` the closures are torch
    ops summed over instance pieces, another summation order, and the
    bounds are SHARD_DATA_TOL; a control shows what any other order does:
    phase 8's fit with the training rows permuted (the same problem, the
    same kernels), held to the same bounds. Every run: TRON counters equal
    on >= 99% of the labels, the served ids on every held-out row decisive
    for both, and the training kernels' launches (> 0 under label
    sharding; none with shard_data, whose closures are torch ops, as the
    JAX package's are jnp).

    With `faults`, the (2, 1) `shard_data` fit runs once under each of
    PLANTED_FAULTS instead, and the checks it fails are reported; a fault
    that fails none is an error."""
    import dataclasses
    import shutil
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, fit
    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=DELTA, eps=0.01,
                                     max_newton=MAX_NEWTON, max_cg=MAX_CG,
                                     ops="pallas"),
                   schedule=ScheduleSpec(label_batch=TRAIN_BATCH),
                   serve=ServeSpec(backend="bsr", k=K))
    ref_W = packed_weights(ref_ckpt)
    mag = max(1.0, float(ref_W.abs().max()))
    ref_count = label_counters(ref_calls[:TRAIN_LABELS // TRAIN_BATCH], 1,
                               data.Y_train, False)
    ref_ids = served_held_out(ref_ckpt, data.X_test)
    Xt = torch.from_numpy(data.X_test).cuda()
    ref_s = Xt @ ref_W.T
    fns = (hinge_ops.hinge_obj_grad_cuda, hvp_ops.hvp_cuda)
    tols = {False: (MESH_TOL * mag, MESH_F_TOL),
            True: (SHARD_DATA_TOL[0] * mag, SHARD_DATA_TOL[1])}

    def run(name, X, Y, sch, mesh, ckpt):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in fns:
            fn.launches = 0
        with tron_counters() as calls:
            t0 = time.perf_counter()
            handle = fit(X, Y, dataclasses.replace(spec, schedule=sch),
                         ckpt, mesh=mesh)
            wall = time.perf_counter() - t0
        _need(handle.result.complete and handle.result.solved == [0, 1],
              f"{name}: fit did not complete: {handle.result}")
        return handle, calls, wall, {
            "hinge_obj_grad": fns[0].launches, "hvp": fns[1].launches}

    def held(name, ckpt, calls, n_shards, balance, shard_data, launches):
        """The run's readings against phase 8's and the checks it fails."""
        W = packed_weights(ckpt)
        tol, f_tol = tols[shard_data]
        cmp = weights_against(W, ref_W, label_counters(
            calls, n_shards, data.Y_train, balance), ref_count, tol)
        # Decisive for both checkpoints: every gap among a row's K + 1
        # best plain scores wider than twice the row's largest score
        # difference between them (and than margin_tol).
        s = Xt @ W.T
        delta_s = (s - ref_s).abs().amax(dim=1)
        top = torch.sort(ref_s, dim=1, descending=True)[0][:, :K + 1]
        gap = (top[:, :-1] - top[:, 1:]).amin(dim=1)
        rows = (gap > 2 * delta_s + margin_tol).cpu().numpy()
        ids = served_held_out(ckpt, data.X_test)
        agree = int((ids[rows] == ref_ids[rows]).all(axis=1).sum())
        del W, s
        failed = [msg for ok, msg in (
            (cmp["counters_equal"] >= 0.99 * TRAIN_LABELS,
             f"TRON counters differ on "
             f"{TRAIN_LABELS - cmp['counters_equal']} labels"),
            (cmp["f_rel"] <= f_tol,
             f"objectives differ by {cmp['f_rel']:.2e}"),
            (cmp["outside"] == 0,
             f"{cmp['outside']} weights differ from phase 8's"),
            (rows.sum() > 0 and agree == rows.sum(),
             f"served ids differ on {int(rows.sum()) - agree} of "
             f"{int(rows.sum())} decisive rows"),
            (launches is None or (sum(launches.values()) == 0 if shard_data
                                  else all(v > 0 for v in
                                           launches.values())),
             f"training kernel launches {launches}")) if not ok]
        print(f"   {name}: TRON counters equal on {cmp['counters_equal']} "
              f"of {TRAIN_LABELS} labels, max |f - f_8| / |f_8| "
              f"{cmp['f_rel']:.2e} (limit {f_tol:.1e}); packed weights vs "
              f"phase 8: bit for bit {cmp['bit_for_bit']}, max |diff| "
              f"{cmp['max_abs_diff']:.3e} (tol {tol:.1e}), {cmp['flips']} "
              f"pruned on one side only, {cmp['outside']} weights of "
              f"{cmp['labels_outside']} labels outside the tolerance; "
              f"served ids == phase 8's on {agree}/{int(rows.sum())} "
              f"decisive held-out rows; failed {failed}", flush=True)
        return dict(weights=cmp, f_tol=f_tol, decisive=int(rows.sum()),
                    agree=agree, failed=failed)

    n_cards = torch.cuda.device_count()
    mesh_of = {shape: make_host_mesh(*shape, devices=["cuda:0"] * (
        shape[0] * shape[1])) for _, shape, _, _ in MESH_FITS}
    if faults:
        runs = [(f"(2, 1) shard_data, {what}", mesh_of[(2, 1)], True,
                 False, plant) for what, plant in PLANTED_FAULTS]
        out = {}
    else:
        # The control: phase 8's fit on the training rows in another
        # order.
        perm = np.random.default_rng([seed, 21]).permutation(TRAIN_N)
        ckpt = os.path.join(out_root, "control")
        _, calls, wall, _ = run("control", data.X_train[perm],
                                data.Y_train[perm], spec.schedule, None,
                                ckpt)
        print(f"   control, phase 8's fit on permuted rows: fit wall "
              f"{wall:.1f} s", flush=True)
        control = held("control", ckpt, calls, 1, False, True, None)
        shutil.rmtree(ckpt)
        _need(not control["failed"], f"control: {control['failed']}")
        out = {"control": dict(control, wall_s=wall)}
        runs = [(name, mesh_of[shape], sd, bal, contextlib.nullcontext)
                for name, shape, sd, bal in MESH_FITS]
        runs.append((f"default (1, {n_cards})", None, False, False,
                     contextlib.nullcontext))
    for i, (name, mesh, shard_data, balance, plant) in enumerate(runs):
        sch = dataclasses.replace(
            spec.schedule, shard_data=shard_data, balance=balance,
            mesh=None if mesh is not None else (1, n_cards))
        ckpt = os.path.join(out_root, f"mesh{i}")
        with plant():
            handle, calls, wall, launches = run(
                name, data.X_train, data.Y_train, sch, mesh, ckpt)
        peak = torch.cuda.max_memory_allocated()
        shape = handle.spec.schedule.mesh
        want = ((1, n_cards) if mesh is None
                else (mesh.shape["data"], mesh.shape["model"]))
        _need(shape == want, f"{name}: fit ran on {shape}, not {want}")
        print(f"   {name}: fit wall {wall:.1f} s; launches {launches}; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
        got = held(name, ckpt, calls, shape[1], balance, shard_data,
                   launches)
        if faults:
            _need(got["failed"],
                  f"{name}: the planted fault passed every check")
        else:
            _need(not got["failed"], f"{name}: {got['failed']}")
        out[name] = dict(got, wall_s=wall, launches=launches,
                         peak_gib=peak / 2**30)
        shutil.rmtree(ckpt)
    return out


def serve_sharded(ckpt: str, requests, margin_tol: float,
                  bsr_labels: np.ndarray) -> dict:
    """Phase 10c: the serving checkpoint and phase 4's requests through
    `sharded` on a MESH_SERVE mesh of cuda:0 and on the default mesh (one
    shard per card) on the main path (`drive`): the top-k kernel launched,
    the served ids equal to the plain path's and to `bsr`'s (phase 4) on
    every decisive row, and the zero row's."""
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    zero = sum(REQUEST_ROWS[:ZERO_REQUEST])
    meshes = (("(1, 4) on cuda:0", make_host_mesh(
        *MESH_SERVE, devices=["cuda:0"] * (MESH_SERVE[0] * MESH_SERVE[1]))),
              (f"default (1, {torch.cuda.device_count()})", None))
    for name, mesh in meshes:
        engine, labels, stats, rows = drive(
            ckpt, requests, {"backend": "sharded"}, "blocked_topk",
            margin_tol, N_LABELS, mesh=mesh)
        n_shards = len(engine.backend._shards)
        del engine
        torch.cuda.empty_cache()
        agree = int((labels[rows] == bsr_labels[rows]).all(axis=1).sum())
        print(f"   sharded {name}: {n_shards} label shards; served ids == "
              f"bsr's on {agree}/{int(rows.sum())} decisive rows; zero row "
              f"{labels[zero].tolist()}", flush=True)
        _need(agree == rows.sum() and labels[zero].tolist()
              == bsr_labels[zero].tolist() == list(range(K)),
              f"sharded {name}: ids differ from bsr's")
        out[name] = dict(stats, shards=n_shards, agree_bsr=agree)
    return out


def decisive_rows(engine, x: np.ndarray, margin_tol: float):
    """The plain path of request x under `engine` (its ids, K + 1 wide)
    and the rows whose answer cannot move with the micro-batch it shares:
    the k-th/(k+1)-th margin above `margin_tol` and, for a per-query
    shortlist, the B-th/(B+1)-th coarse scores more than 1e-5 of the
    row's largest coarse score apart (the server's coarse product runs on
    another batch shape than the plain path's)."""
    v, ids = plain_engine_topk(engine, x)
    rows = (v[:, K - 1] - v[:, K]) > margin_tol
    be = engine.backend
    if be.name == "shortlist" and be.per_query:
        from repro_torch.serve.xmc import _coarse_input
        xd = torch.from_numpy(x).cuda()
        coarse = _coarse_input(xd, be._centroids.shape[1]) @ be._centroids.T
        c = torch.sort(coarse, dim=1, descending=True)[0].cpu().numpy()
        scale = np.abs(c).max(axis=1)
        rows &= (c[:, be.B - 1] - c[:, be.B]) > 1e-5 * scale
    return ids, rows


def explain_row(engine, x: np.ndarray, r: int, res) -> None:
    """Print what a served per-query int8 answer that differs from the
    plain path on a decisive row is made of: the plain ids and values,
    the request's own coarse margin at B, whether the served labels lie in
    the plain selection, and the exhaustive plain scores of the served
    labels next to the served scores."""
    from repro_torch.kernels.bsr_predict import ref as bsr_ref
    from repro_torch.serve.xmc import _coarse_input
    be = engine.backend
    q, bl = be.int8_model, be.model.block_shape[0]
    v, ids = plain_engine_topk(engine, x)
    xd = torch.from_numpy(x).cuda()
    coarse = _coarse_input(xd, be._centroids.shape[1]) @ be._centroids.T
    c = torch.sort(coarse, dim=1, descending=True)[0].cpu().numpy()[r]
    sel = be._select(xd).cpu().numpy()[r]
    xp = torch.nn.functional.pad(xd[r:r + 1], (0, be.model.shape[1]
                                               - xd.shape[1]))
    full = bsr_ref.bsr_predict_int8(xp, q.blocks, q.scales, q.block_rows,
                                    q.block_cols, be.model.shape[0] // bl)
    true = full[0, torch.from_numpy(res.labels[r]).long().cuda()]
    print(f"   MISMATCH request {res.request_id} row {r}: served "
          f"{res.labels[r].tolist()} {res.scores[r].tolist()}; plain "
          f"{ids[r].tolist()} {v[r].tolist()}; coarse B-gap / max "
          f"{(c[be.B - 1] - c[be.B]) / np.abs(c).max():.3e}; served "
          f"blocks in the plain selection "
          f"{np.isin(res.labels[r] // bl, sel).tolist()}; exhaustive "
          f"plain scores of the served labels {true.tolist()}",
          flush=True)


def offer(router, requests, names, gaps, on_submit=None) -> list:
    """Submit requests open-loop on the Poisson schedule `gaps`, each to
    its model; `on_submit(i, name)` after each, returning True to stop."""
    futures = []
    t_next = time.monotonic()
    for i, (x, name, gap) in enumerate(zip(requests, names, gaps)):
        t_next += gap
        now = time.monotonic()
        if t_next > now:
            time.sleep(t_next - now)
        futures.append(router.submit(name, x))
        if on_submit is not None and on_submit(i, name):
            break
    return futures


def check_answers(router, requests, names, results, bsr_engines,
                  margin_tol: float):
    """Every answer against the plain path of the model that served it,
    on decisive rows: `wiki_pq_int8`'s one engine; for `wiki_bsr`, the
    one of `bsr_engines` ({tag: engine}) whose plain ids it has, which
    must be exactly one. Returns (wiki_bsr's tags in submission order,
    decisive rows, rows that agree)."""
    kinds, decisive, agree = [], 0, 0
    for x, name, res in zip(requests, names, results):
        _need(res.labels.shape == (x.shape[0], K)
              and np.isfinite(res.scores).all(),
              f"{name}: malformed answer to request {res.request_id}")
        if name == "wiki_pq_int8":
            ids, rows = decisive_rows(router[name].engine, x, margin_tol)
            decisive += int(rows.sum())
            same = (res.labels == ids[:, :K]).all(1)
            agree += int(same[rows].sum())
            for r in np.flatnonzero(rows & ~same):
                explain_row(router[name].engine, x, int(r), res)
            continue
        match = []          # a model whose plain ids the answer has
        for tag, eng in bsr_engines.items():
            ids, rows = decisive_rows(eng, x, margin_tol)
            same = res.labels == ids[:, :K]
            if same[rows].all() and (rows.any() or same.all()):
                match.append((tag, int(rows.sum())))
        _need(len(match) == 1, f"wiki_bsr request {res.request_id}: the "
              f"answer matches the plain path of {match or 'no'} model")
        kinds.append(match[0][0])
        decisive += match[0][1]
        agree += match[0][1]
    _need(decisive > 0 and agree == decisive,
          f"served ids differ from the plain path on {decisive - agree} of "
          f"{decisive} decisive rows")
    return kinds, decisive, agree


def window_stats(router, names, wall: float, before: dict) -> dict:
    """Per model, what the servers recorded since `before` (their counters
    then; latency and queue wait are reset at the start of a window)."""
    stats = {}
    for name, _ in SERVER_MODELS:
        st = router[name].stats()
        lat, qw = st["latency"], st["queue_wait"]
        done = st["completed"] - before[name]["completed"]
        swap = router[name].last_swap or {}
        stats[name] = dict(
            completed=done, rejected=st["rejected"] - before[name]["rejected"],
            batches=st["batches"] - before[name]["batches"],
            swaps=st["swaps"] - before[name]["swaps"],
            p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
            queue_wait_p50_ms=qw["p50_ms"], queue_wait_p99_ms=qw["p99_ms"],
            goodput_rps=done / wall,
            warm_ms=swap.get("warm_ms"), flip_ms=swap.get("flip_ms"))
        _need(done == names.count(name) and lat["count"] == done,
              f"{name}: {done} of {names.count(name)} resolved")
        print(f"   {name}: completed {done}, rejected "
              f"{stats[name]['rejected']}, batches "
              f"{stats[name]['batches']}, swaps {stats[name]['swaps']}; "
              f"latency p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f}"
              f" ms; queue wait p50 {qw['p50_ms']:.3f} ms, p99 "
              f"{qw['p99_ms']:.3f} ms; goodput {done / wall:.2f} req/s" +
              (f"; last swap warm {swap['warm_ms']:.3f} ms, flip "
               f"{swap['flip_ms']:.4f} ms" if stats[name]["swaps"] else ""),
              flush=True)
    return stats


def trace_summary(path: str) -> dict:
    """What a `torch.profiler` chrome trace of a swap window shows, per
    stream: the host-to-card copies (count, MB, device ms) and the
    kernels' launch-to-start delay; the longest a host thread waited in a
    copy call of under 32 MB (the dispatchers' request copies, pageable
    and so synchronous); and the runtime calls with the longest single
    call. Returns {} when the trace holds no device activity."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    copies, delays, waits = {}, {}, []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy"):
            continue
        a = e.get("args", {})
        stream = str(a.get("stream"))
        call = runtime.get(a.get("correlation"))
        if e["cat"] == "kernel":
            if call is not None:
                delays.setdefault(stream, []).append(
                    (e["ts"] - call["ts"]) / 1e3)
        elif "HtoD" in e.get("name", ""):
            c = copies.setdefault(stream, dict(count=0, mb=0.0, ms=0.0))
            c["count"] += 1
            c["mb"] += a.get("bytes", 0) / 1e6
            c["ms"] += e.get("dur", 0) / 1e3
            if call is not None and a.get("bytes", 0) < 32e6:
                waits.append(call.get("dur", 0) / 1e3)
    if not copies and not delays:
        return {}

    def spread(v):
        return dict(count=len(v), p50=float(np.percentile(v, 50)),
                    p99=float(np.percentile(v, 99)), max=max(v)) \
            if v else None

    longest = {}
    for e in runtime.values():
        longest[e["name"]] = max(longest.get(e["name"], 0.0),
                                 e.get("dur", 0) / 1e3)
    return dict(
        htod_by_stream=copies, small_copy_wait_ms=spread(waits),
        kernel_delay_ms_by_stream={k: spread(v) for k, v in delays.items()},
        longest_call_ms=dict(sorted(longest.items(),
                                    key=lambda kv: -kv[1])[:5]))


class InterpreterProbe:
    """A thread that sleeps 1 ms at a time and records how late it wakes:
    waking means taking the interpreter lock back, so the lateness is how
    long another thread kept the lock from a thread that wanted it (the
    dispatchers want it between every two calls into torch)."""

    def __init__(self):
        self.late_ms: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t = time.perf_counter()
            time.sleep(1e-3)
            self.late_ms.append((time.perf_counter() - t) * 1e3 - 1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        v = np.asarray(self.late_ms)
        return dict(wakes=int(v.size), p50=float(np.percentile(v, 50)),
                    p99=float(np.percentile(v, 99)), max=float(v.max()),
                    over_10ms=int((v > 10).sum()))


def serve_async(serve_ckpt: str, trained_ckpt: str, rng, perm,
                margin_tol: float) -> dict:
    """Phase 10: the async request path on the main path. Two servers
    behind a `ModelRouter` under open-loop Poisson traffic, in three
    windows: "swap", a hot swap of `wiki_bsr` onto the trained checkpoint
    by `router.refresh` after request 150 (the model goes to the card in
    `COPY_CHUNK_BYTES` pieces); "steady", the same traffic with no swap,
    the control of what a swap costs the tail; and "swap_whole_copies",
    a refresh of `wiki_bsr` back onto the serving checkpoint with each
    array copied in one piece, the control of the pieces. Both swap
    windows run under `torch.profiler` (`trace_summary`), and every
    window under an `InterpreterProbe`. The launch counts are set to 0 just before the
    router is built and read after it drained."""
    import repro_torch.device as device_mod
    from repro_torch.serve.batching import LatencyStats
    from repro_torch.serve.server import ModelRouter, Rejected
    from repro_torch.specs import ServeSpec
    from repro_torch.xmc_api import CheckpointHandle
    from torch.profiler import ProfilerActivity, profile
    n_all = 2 * SERVER_MAX + SERVER_REQUESTS
    sizes = rng.integers(1, SERVER_MAX_ROWS + 1, size=n_all)
    requests = [tfidf_rows(rng, int(n), perm) for n in sizes]
    names = [SERVER_MODELS[int(i)][0]
             for i in rng.integers(len(SERVER_MODELS), size=n_all)]
    gaps = rng.exponential(1.0 / SERVER_RATE, size=n_all)
    kernels = serving_kernels()
    torch.cuda.empty_cache()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    router = ModelRouter()
    handle = CheckpointHandle.open(serve_ckpt)
    for name, overrides in SERVER_MODELS:
        router.add(name, handle.server(handle.spec.serve.replace(
            **SERVER_SPEC, **overrides), name=name))
    t_load = time.perf_counter() - t0
    _need(router["wiki_pq_int8"].engine.backend.per_query
          and router["wiki_pq_int8"].engine.backend.int8,
          "wiki_pq_int8 does not serve int8 per query")
    bsr = ServeSpec(backend="bsr")

    def refresh_in_pieces():
        return router.refresh("wiki_bsr", trained_ckpt, serve_override=bsr)

    def refresh_whole():            # the control: one copy per array
        chunk = device_mod.COPY_CHUNK_BYTES
        device_mod.COPY_CHUNK_BYTES = 1 << 62
        try:
            return router.refresh("wiki_bsr", serve_ckpt,
                                  serve_override=bsr)
        finally:
            device_mod.COPY_CHUNK_BYTES = chunk

    # (window, swap or None, traced, its requests)
    windows = (
        ("swap", refresh_in_pieces, True, slice(0, SERVER_MAX)),
        ("steady", None, False,
         slice(SERVER_MAX, SERVER_MAX + SERVER_REQUESTS)),
        ("swap_whole_copies", refresh_whole, True,
         slice(SERVER_MAX + SERVER_REQUESTS, n_all)))
    out = {}
    with router, tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        for window, swap, traced, part in windows:
            reqs, nms, gps = requests[part], names[part], gaps[part]
            before = {n: router[n].stats() for n, _ in SERVER_MODELS}
            for n, _ in SERVER_MODELS:
                router[n].latency = LatencyStats()
                router[n].queue_wait = LatencyStats()
            old = router["wiki_bsr"].engine
            swap_out = {"after": 0}

            def run_swap():
                t = time.perf_counter()
                try:
                    swap_out["prev"] = swap()
                except Exception as e:              # reported below
                    swap_out["error"] = e
                swap_out["s"] = time.perf_counter() - t

            swapper = threading.Thread(target=run_swap)

            def on_submit(i, name):
                if "s" in swap_out and name == "wiki_bsr":
                    swap_out["after"] += 1
                if i + 1 == SERVER_SWAP_AFTER:
                    swapper.start()
                return (i + 1 >= SERVER_REQUESTS
                        and swap_out["after"] >= SERVER_TAIL)

            with (profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof, \
                    InterpreterProbe() as probe:
                t_start = time.monotonic()
                futures = offer(router, reqs, nms, gps,
                                on_submit if swap else None)
                if swap:
                    swapper.join()
                results = [f.result(120) for f in futures]
                wall = time.monotonic() - t_start
            reqs, nms = reqs[:len(futures)], nms[:len(futures)]
            _need(not any(isinstance(r, Rejected) for r in results),
                  "a request was rejected below the admission bound")
            new = router["wiki_bsr"].engine
            if swap:
                _need(swap_out.get("prev") is old and new is not old
                      and router["wiki_bsr"].counters["swaps"]
                      == before["wiki_bsr"]["swaps"] + 1,
                      f"the hot swap of window '{window}' did not happen: "
                      f"{swap_out.get('error')!r}")
            kinds, decisive, agree = check_answers(
                router, reqs, nms, results,
                {"old": old, "new": new} if swap else
                {"old": router["wiki_bsr"].previous_engine, "new": new},
                margin_tol)
            first_new = kinds.index("new") if "new" in kinds else len(kinds)
            cut = "".join(k[0] for k in kinds)
            _need(all(k == "new" for k in kinds[first_new:])
                  and (0 < first_new < len(kinds) if swap
                       else first_new == 0),
                  f"wiki_bsr's answers are not a clean cut (o: old, n: "
                  f"new): {cut}")
            print(f"   window '{window}': {len(futures)} requests at "
                  f"{SERVER_RATE:.0f}/s offered and answered in {wall:.2f} "
                  f"s; wiki_bsr answered {kinds.count('old')} on the old "
                  f"model, then {kinds.count('new')} on the new; served "
                  f"ids == plain ids on {agree}/{decisive} decisive rows" +
                  (f"; the swap took {swap_out['s']:.2f} s" if swap else ""),
                  flush=True)
            out[window] = dict(
                models=window_stats(router, nms, wall, before),
                requests=len(futures), wall_s=wall,
                old_answers=kinds.count("old"),
                new_answers=kinds.count("new"), agree=agree,
                decisive=decisive, refresh_s=swap_out.get("s"),
                interpreter_late_ms=probe.summary())
            print(f"   window '{window}': a 1 ms sleep woke late by "
                  f"{json.dumps(out[window]['interpreter_late_ms'])} ms",
                  flush=True)
            if traced:
                path = os.path.join(tdir, f"{window}.json")
                prof.export_chrome_trace(path)
                tr = out[window]["trace"] = trace_summary(path)
                print(f"   window '{window}' trace: " + (json.dumps(tr) if tr
                      else "no device activity (not measured)"), flush=True)
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    _need(all(launches.get(k, 0) > 0 for k in
              ("bsr_predict", "bsr_gather_pq_int8", "blocked_topk")),
          f"a kernel of the server path never launched: {launches}")
    print(f"   set-up (two servers over the serving checkpoint) "
          f"{t_load:.1f} s; launches {launches}", flush=True)
    return dict(out, setup_s=t_load, launches=launches)


def run_sweep(data, out_root: str) -> dict:
    """Phase 11: `lifecycle.sweep` on the card over the training data's
    first SWEEP_LABELS labels (one full-width batch per arm)."""
    from repro_torch.lifecycle import sweep
    from repro_torch.specs import (ScheduleSpec, ServeSpec, SolverSpec,
                                   SweepPolicy)
    from repro_torch.xmc_api import XMCSpec
    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, eps=0.01,
                                     max_newton=MAX_NEWTON, max_cg=MAX_CG,
                                     ops="pallas"),
                   schedule=ScheduleSpec(label_batch=TRAIN_BATCH),
                   serve=ServeSpec(backend="bsr", k=K))
    Y = np.ascontiguousarray(data.Y_train[:, :SWEEP_LABELS])
    Yh = np.ascontiguousarray(data.Y_test[:, :SWEEP_LABELS])
    t0 = time.perf_counter()
    report = sweep(data.X_train, Y, spec, SWEEP_ARMS, out_root, workers=2,
                   holdout=(data.X_test, Yh), eval_ks=(1, 5),
                   policy=SweepPolicy(kind="max_precision", metric="P@1"))
    wall = time.perf_counter() - t0
    rows = []
    for a in report.arms:
        rows.append(dict(name=a.name, delta=a.delta, nnz=a.nnz,
                         model_mb=a.model_mb, int8_mb=a.int8_mb,
                         p_at_1=a.metrics["P@1"], p_at_5=a.metrics["P@5"],
                         train_s=a.train_s, fixed_point=a.fixed_point))
        print(f"   {a.name}: delta {a.delta}, nnz {a.nnz}, model "
              f"{a.model_mb:.3f} MB, int8 {a.int8_mb:.3f} MB, P@1 "
              f"{a.metrics['P@1']:.4f}, P@5 {a.metrics['P@5']:.4f}, train "
              f"{a.train_s:.1f} s, fixed point {a.fixed_point}", flush=True)
    print(f"   winner {report.winner} (max P@1); sweep wall {wall:.1f} s",
          flush=True)
    _need(report.arm("same").fixed_point is True,
          "the unchanged arm is not the base's fixed point")
    return dict(arms=rows, winner=report.winner, wall_s=wall)


def run_cli(ckpt_root: str) -> dict:
    """Phase 12: the serving CLI's server mode on the card, sent SIGTERM
    once it offers load; it must drain the router and exit 143."""
    import signal
    ckpt = str(Path(ckpt_root) / "cli_ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--xmc",
           "--server", "--model", f"a={ckpt},backend=bsr", "--model",
           f"b={ckpt},backend=shortlist,int8=1", "--requests", "2000",
           "--rate", "20"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "offering" in line:
                break
        t_up = time.perf_counter() - t0
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    for line in out.splitlines():
        if line.startswith("[server]"):
            print(f"   {line}")
    _need(proc.returncode == 128 + signal.SIGTERM and "router drained" in out,
          f"the CLI exited {proc.returncode} without draining:\n{out}")
    print(f"   exit {proc.returncode} after SIGTERM; up and offering load "
          f"{t_up:.1f} s after the start", flush=True)
    return dict(returncode=proc.returncode, up_s=t_up)


def baseline_trainers() -> dict:
    from repro_torch import baselines as b
    return {"SLEEC": b.train_sleec, "LEML": b.train_leml,
            "FastXML": b.train_fastxml, "PD-Sparse": b.train_pd_sparse,
            "L1-SVM": b.train_l1_svm}


@contextlib.contextmanager
def plain_topk():
    """The plain path of the baselines: while the block runs, each of their
    modules calls the stable sort (`kernels/topk/ref.topk`) for its top-k
    and SLEEC's kNN sets instead of `kernels/topk/ops.topk`."""
    from repro_torch.baselines import fastxml, l1_svm, leml, sleec
    from repro_torch.kernels.topk import ref
    mods = (fastxml, l1_svm, leml, sleec)
    saved = [m.topk for m in mods]
    for m in mods:
        m.topk = ref.topk
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.topk = fn


def predict_baseline(name: str, model, X: torch.Tensor,
                     margin_tol: float):
    """`model.predict_topk(X, K)` on the card with kernel 9's count set to
    0 just before it and read just after: it must have launched. Then the
    plain path on the same model: its ids must equal the served ones on
    every row whose K-th/(K+1)-th margin is decisive, and since both paths
    rank the same scores, on every other row too (ties to the lowest id;
    the sparse models' zero scores tie often). Returns (ids, stats)."""
    from repro_torch.kernels.topk import ops as topk_ops
    fn = topk_ops.blocked_topk_cuda
    fn.launches = 0
    t0 = time.perf_counter()
    _, ids = model.predict_topk(X, K)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = fn.launches
    _need(launches > 0, f"{name}: predict_topk never launched kernel 9")
    with plain_topk():
        vals_p, ids_p = model.predict_topk(X, K + 1)
    _need(fn.launches == launches, f"{name}: the plain path launched kernel 9")
    rows = (vals_p[:, K - 1] - vals_p[:, K]) > margin_tol
    same = (ids == ids_p[:, :K]).all(dim=1)
    decisive, agree = int(rows.sum()), int(same[rows].sum())
    _need(agree == decisive and bool(same.all()),
          f"{name}: served ids differ from the plain path on "
          f"{decisive - agree} of {decisive} decisive rows and "
          f"{int((~same).sum())} of {int(X.shape[0])} rows")
    return ids, dict(launches=launches, predict_s=predict_s,
                     decisive=decisive, agree=agree,
                     agree_all=int(same.sum()), rows=int(X.shape[0]))


def fit_dismec(d, root: Path) -> tuple[np.ndarray, dict]:
    """DiSMEC's row of Table 2: `fit` on the card with the kernel ops at
    the benchmarks' label batch, served through `bsr` (the training and the
    serving kernels must launch). Returns (held-out top-K ids, stats)."""
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, fit
    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, eps=0.01,
                                     ops="pallas"),
                   schedule=ScheduleSpec(label_batch=min(
                       d.n_labels, DISMEC_LABEL_BATCH)),
                   serve=ServeSpec(backend="bsr", k=K, warmup=False))
    kernels = serving_kernels()
    for fn in (hinge_ops.hinge_obj_grad_cuda, hvp_ops.hvp_cuda,
               *kernels.values()):
        fn.launches = 0
    with tempfile.TemporaryDirectory(dir=root) as ckpt:
        t0 = time.perf_counter()
        handle = fit(d.X_train, d.Y_train, spec, ckpt)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        _need(handle.result.complete, f"{d.name}: DiSMEC's fit incomplete")
        res = handle.engine().serve([d.X_test])[0]
    launches = {"hinge_obj_grad": hinge_ops.hinge_obj_grad_cuda.launches,
                "hvp": hvp_ops.hvp_cuda.launches,
                **{k: fn.launches for k, fn in kernels.items()
                   if fn.launches}}
    _need(all(launches.get(k, 0) > 0 for k in
              ("hinge_obj_grad", "hvp", "bsr_predict", "blocked_topk")),
          f"{d.name}: a kernel of DiSMEC's path never launched: {launches}")
    return res.labels, dict(train_s=train_s, launches=launches)


def decisive_cuts(s: np.ndarray, tol: float) -> np.ndarray:
    """(rows, K) bool: cut j (after the j-th best score) is decisive where
    the j-th and (j+1)-th scores lie more than 2 * tol apart, relative to
    the row's largest |score|."""
    top = -np.sort(-s, axis=1)[:, :K + 1]
    return (top[:, :-1] - top[:, 1:]) > \
        2 * tol * np.abs(s).max(axis=1, keepdims=True)


def ids_at_cuts(a: np.ndarray, b: np.ndarray, cuts: np.ndarray
                ) -> tuple[int, int]:
    """Top-K ids `a` against `b` at every decisive cut j: the sets of their
    first j ids must be equal (the order inside a near tie may differ).
    Returns (cuts checked, cuts that differ)."""
    checked = bad = 0
    for j in range(1, K + 1):
        rows = cuts[:, j - 1]
        checked += int(rows.sum())
        bad += int((np.sort(a[rows, :j], axis=1) !=
                    np.sort(b[rows, :j], axis=1)).any(axis=1).sum())
    return checked, bad


def rel_err(a, b, rows=None) -> float:
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b) if rows is None else np.abs(a - b)[rows]
    return float(d.max() / np.abs(b).max())


def cpu_baselines() -> tuple[threading.Thread, dict]:
    """Phase 12b's reference: the port's baselines trained on the CPU on
    wiki31k_like, with L1-SVM and PD-Sparse also cut at CARD_CPU_STEPS
    steps. It takes longer than phase 12b's card work (PD-Sparse's 1,500
    steps the most), so it starts on a thread of its own at phase 11, at
    nice 10 with 6 intra-op threads: the sweep's and the CLI's host work
    go first. Returns (the thread, its results: `data`, a model by name,
    or `error`)."""
    out = {}

    def work():
        try:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
            except OSError as e:
                print(f"   (CPU reference at normal priority: {e})",
                      flush=True)
            torch.set_num_threads(6)
            from repro_torch.data.xmc import load_paper_like
            d = out["data"] = load_paper_like(PAPER_LIKE[0], seed=0)
            for n, fn in baseline_trainers().items():
                out[n] = fn(d.X_train, d.Y_train, device="cpu")
            for n in ("L1-SVM", "PD-Sparse"):
                out[f"{n}@{CARD_CPU_STEPS}"] = baseline_trainers()[n](
                    d.X_train, d.Y_train, n_steps=CARD_CPU_STEPS,
                    device="cpu")
        except BaseException as e:              # re-raised after the join
            out["error"] = e
    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    return worker, out


def sleec_cut_gaps(model) -> list[float]:
    """Each cluster's gap at its rank cut: the r-th less the (r+1)-th
    singular value of its label submatrix, over the largest (inf where r
    keeps them all)."""
    gaps = []
    for Z, Yc in zip(model.embeddings, model.labels):
        s = torch.linalg.svdvals(Yc)
        r = Z.shape[1]
        gaps.append(float((s[r - 1] - s[r]) / s[0]) if r < s.numel()
                    else math.inf)
    return gaps


def sleec_split_cuts(model) -> list[int]:
    """The clusters of `model` whose rank cut splits a (near-)degenerate
    singular value of their label submatrix (a gap within SLEEC_GAP).
    Their embedding is then any basis of part of that singular subspace,
    and two SVD implementations pick different ones."""
    return [c for c, g in enumerate(sleec_cut_gaps(model))
            if g <= SLEEC_GAP]


def sleec_decisive(model, X: torch.Tensor, tol: float) -> np.ndarray:
    """Rows whose centroid choice and kNN cut are decisive under `model`
    (on the CPU): the best centroid more than 2 * tol of the row's largest
    |similarity| ahead of the next and not a cluster whose rank cut splits
    a degenerate singular value (`sleec_split_cuts`), and every training
    row within 2 * tol of the knn-th similarity carrying the same labels
    (equal label rows have equal embeddings, so such exact ties are
    harmless)."""
    cs = X @ model.centroids.T
    top2 = cs.sort(dim=1, descending=True).values[:, :2]
    ok = ((top2[:, 0] - top2[:, 1]) > 2 * tol * cs.abs().amax(1)).numpy()
    split = sleec_split_cuts(model)
    for i, c in enumerate(cs.argmax(1).tolist()):
        if c in split:
            ok[i] = False
            continue
        sim = (X[i] @ model.regressors[c]) @ model.embeddings[c].T
        if sim.numel() > model.knn:
            cut = sim.sort(descending=True).values[model.knn - 1]
            near = (sim - cut).abs() <= 2 * tol * sim.abs().max()
            lab = model.labels[c][near]
            ok[i] &= bool((lab == lab[0]).all())
    return ok


def plane_margins(tree, X: torch.Tensor) -> torch.Tensor:
    """For each row of X, the smallest |x.w| / (|x|.|w|) over the planes on
    its path down `tree` (inf for a one-leaf tree)."""
    code = torch.full((X.shape[0],), tree.root, dtype=torch.int64,
                      device=X.device)
    low = torch.full((X.shape[0],), math.inf, device=X.device)
    if tree.depth:
        proj = X @ tree.splits.T
        mag = X.abs() @ tree.splits.abs().T
        for _ in range(tree.depth):
            node = code.clamp_min(0)
            p = proj.gather(1, node[:, None])[:, 0]
            m = mag.gather(1, node[:, None])[:, 0]
            inner = code >= 0
            low = torch.where(inner, torch.minimum(low, p.abs() / m), low)
            code = torch.where(inner, tree.children[node, (p > 0).long()],
                               code)
    return low


def card_against_cpu(d, card: dict, cpu: dict) -> dict:
    """Phase 12b on wiki31k_like: each baseline trained on the card against
    the port trained on the CPU (module comment at CARD_CPU_STEPS)."""
    from repro_torch.core.prediction import evaluate
    trainers = baseline_trainers()
    Xh = torch.from_numpy(d.X_test)
    Xc = Xh.cuda()
    Yh = torch.from_numpy(d.Y_test)
    out = {}

    def ids_on(model_c, model_h, cuts) -> tuple[int, int]:
        return ids_at_cuts(model_c.predict_topk(Xc, K)[1].cpu().numpy(),
                           model_h.predict_topk(Xh, K)[1].numpy(), cuts)

    for name in ("L1-SVM", "PD-Sparse"):
        tol = BASE_TOL[name]
        h = cpu[f"{name}@{CARD_CPU_STEPS}"]
        c = trainers[name](d.X_train, d.Y_train, n_steps=CARD_CPU_STEPS)
        err = rel_err(c.W.cpu(), h.W)
        checked, bad = ids_on(c, h, decisive_cuts(h.scores(Xh).numpy(), tol))
        nnz = (c.nnz, h.nnz)
        pk_c = evaluate(Yh, card[name].predict_topk(Xc, K)[1].cpu())
        pk_h = evaluate(Yh, cpu[name].predict_topk(Xh, K)[1])
        full_err = rel_err(card[name].W.cpu(), cpu[name].W)
        gaps = {k: abs(pk_c[k] - pk_h[k]) for k in ("P@1", "P@5")}
        out[name] = dict(steps=CARD_CPU_STEPS, weights=err, tol=tol,
                         nnz=nnz, cuts=checked, cuts_differ=bad,
                         full_weights=full_err, full_p_gap=gaps)
        print(f"   {name} card vs CPU at {CARD_CPU_STEPS} steps: weights "
              f"{err:.3e} of their magnitude (bound {tol:g}), nnz {nnz[0]}"
              f" / {nnz[1]}, top-j id sets differ at {bad} of {checked} "
              f"decisive cuts; full run: weights {full_err:.3e}, P@1 "
              f"{pk_c['P@1']:.4f} / {pk_h['P@1']:.4f}, P@5 "
              f"{pk_c['P@5']:.4f} / {pk_h['P@5']:.4f}", flush=True)
        _need(err <= tol and bad == 0 and checked > 0 and
              abs(nnz[0] - nnz[1]) <= BASE_NNZ_TOL * nnz[1] and
              max(gaps.values()) <= BASE_PK_TOL,
              f"{name}: the card's model is outside the CPU's bounds")
    for name in ("LEML", "SLEEC"):
        tol = BASE_TOL[name]
        h, c = cpu[name], card[name]
        s_h = h.scores(Xh).numpy()
        s_c = c.scores(Xc).cpu().numpy()
        if name == "SLEEC":
            _need([len(e) for e in c.embeddings] ==
                  [len(e) for e in h.embeddings],
                  "SLEEC: the card's clusters are not the CPU's")
            keep = sleec_decisive(h, Xh, tol)
            split = sleec_split_cuts(h)
            print(f"   SLEEC's gaps at the rank cut (over the largest "
                  f"singular value), by cluster: "
                  f"{[f'{g:.2e}' for g in sleec_cut_gaps(h)]}", flush=True)
        else:
            keep, split = np.ones(len(s_h), bool), []
        err = rel_err(s_c, s_h, keep)
        checked, bad = ids_on(c, h, keep[:, None] & decisive_cuts(s_h, tol))
        out[name] = dict(scores=err, tol=tol, compared=int(keep.sum()),
                         cuts=checked, cuts_differ=bad, split_clusters=split)
        print(f"   {name} card vs CPU: scores {err:.3e} of their magnitude "
              f"(bound {tol:g}) on {int(keep.sum())} of {len(keep)} rows"
              + (f" (centroid and kNN cut decisive; clusters {split} left "
                 "out: their rank cut splits a degenerate singular value)"
                 if name == "SLEEC" else "") +
              f", top-j id sets differ at {bad} of {checked} decisive cuts",
              flush=True)
        _need(err <= tol and bad == 0 and checked > 0,
              f"{name}: the card's model is outside the CPU's bounds")
    h, c = cpu["FastXML"], card["FastXML"]
    worst, low_train = 0.0, math.inf
    for th, tc in zip(h.trees, c.trees):
        _need((th.root, th.depth) == (tc.root, tc.depth) and
              torch.equal(th.children, tc.children.cpu()) and
              torch.equal(th.leaves, tc.leaves.cpu()),
              "FastXML: the card's tree is not the CPU's")
        worst = max(worst, rel_err(tc.splits.cpu(), th.splits))
        low_train = min(low_train, float(plane_margins(
            th, torch.from_numpy(d.X_train)).min()))
    near = torch.zeros(len(Xh), dtype=torch.bool)
    for th in h.trees:
        near |= plane_margins(th, Xh) < NEAR_PLANE
    rows = ~near.numpy()
    a = c.predict_topk(Xc, K)[1].cpu().numpy()[rows]
    bad = int((a != h.predict_topk(Xh, K)[1].numpy()[rows]).any(1).sum())
    out["FastXML"] = dict(splits=worst, tol=BASE_TOL["FastXML"],
                          skipped_near_plane=int(near.sum()), ids_differ=bad,
                          train_margin=low_train)
    print(f"   FastXML card vs CPU: the same {len(h.trees)} trees, splits "
          f"{worst:.3e} of their magnitude (bound {BASE_TOL['FastXML']:g}),"
          f" leaves equal; the smallest margin of a training row at a "
          f"final plane {low_train:.3e}; ids differ on {bad} of "
          f"{int(rows.sum())} rows ({int(near.sum())} skipped: a path "
          f"within {NEAR_PLANE:g} of a plane)", flush=True)
    _need(worst <= BASE_TOL["FastXML"] and bad == 0,
          "FastXML: the card's model is outside the CPU's bounds")
    again = trainers["PD-Sparse"](d.X_train, d.Y_train)
    same = bool(torch.equal(again.W, card["PD-Sparse"].W))
    out["PD-Sparse"]["bit_for_bit_twice"] = same
    print(f"   PD-Sparse trained twice on the card ({PD_SPARSE_STEPS} steps):"
          f" equal bit for bit {same}", flush=True)
    _need(same, "PD-Sparse: two card runs differ")
    return out


def table2(root: Path, margin_tol: float) -> tuple[list, dict, dict]:
    """Phase 12b (a): Table 2 on the four paper-like datasets, every method
    trained on the card. Returns (rows, headline, the baselines trained on
    wiki31k_like)."""
    from repro_torch.core.prediction import evaluate
    from repro_torch.data.xmc import load_paper_like
    trainers = baseline_trainers()
    rows, card31 = [], {}
    for ds in PAPER_LIKE:
        d = load_paper_like(ds, seed=0)
        Xte = torch.from_numpy(d.X_test).cuda()
        Yte = torch.from_numpy(d.Y_test).cuda()
        labels, st = fit_dismec(d, root)
        rows.append(dict(dataset=ds, method="DiSMEC", **evaluate(
            Yte, torch.from_numpy(labels).cuda()), **st))
        for name, fn in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = fn(d.X_train, d.Y_train)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            ids, st = predict_baseline(f"{ds} {name}", model, Xte,
                                       margin_tol)
            rows.append(dict(dataset=ds, method=name,
                             **evaluate(Yte, ids), train_s=train_s, **st))
            if ds == PAPER_LIKE[0]:
                card31[name] = model
        shown = [r for r in rows if r["dataset"] == ds]
        print(f"   {ds} (N {d.X_train.shape[0]}, D {d.X_train.shape[1]}, L"
              f" {d.n_labels}, {d.X_test.shape[0]} held out):", flush=True)
        for r in shown:
            extra = (f"kernel 9 launches {r['launches']}, ids == plain on "
                     f"{r['agree']}/{r['decisive']} decisive rows"
                     if "decisive" in r else
                     f"launches {r['launches']}")
            print(f"     {r['method']:>9s}: P@1 {r['P@1']:.4f} P@3 "
                  f"{r['P@3']:.4f} P@5 {r['P@5']:.4f} nDCG@3 "
                  f"{r['nDCG@3']:.4f} nDCG@5 {r['nDCG@5']:.4f} train_s "
                  f"{r['train_s']:.2f}; {extra}", flush=True)
    headline = {}
    print("   headline (paper §4.1: DiSMEC within 0.02 of the best P@1; "
          "reported, not enforced):", flush=True)
    for ds in PAPER_LIKE:
        rs = [r for r in rows if r["dataset"] == ds]
        best = max(rs, key=lambda r: r["P@1"])
        dis = next(r for r in rs if r["method"] == "DiSMEC")
        ok = dis["P@1"] >= best["P@1"] - 0.02
        headline[ds] = dict(best=best["method"], best_p1=best["P@1"],
                            dismec_p1=dis["P@1"], ok=ok)
        print(f"     [{'OK ' if ok else 'MISS'}] {ds}: best "
              f"{best['method']} ({best['P@1']:.4f}), DiSMEC "
              f"{dis['P@1']:.4f}", flush=True)
    return rows, headline, card31


def wide_baselines(data, dismec_W: torch.Tensor, margin_tol: float) -> dict:
    """Phase 12b (b) on phase 5's data: L1-SVM on phase 8's first label
    batch beside phase 8's model on the same labels (density, P@k, Fig. 2's
    statistics), and FastXML over every label."""
    from repro_torch.baselines.l1_svm import LinearModel
    from repro_torch.core.prediction import evaluate
    from repro_torch.core.pruning import (ambiguous_fraction, nnz,
                                          weight_histogram)
    trainers = baseline_trainers()
    X = torch.from_numpy(data.X_train).cuda()
    Xte = torch.from_numpy(data.X_test).cuda()
    Y1 = torch.from_numpy(np.ascontiguousarray(
        data.Y_train[:, :TRAIN_BATCH])).cuda()
    Yte1 = torch.from_numpy(np.ascontiguousarray(
        data.Y_test[:, :TRAIN_BATCH])).cuda()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l1 = trainers["L1-SVM"](X, Y1, **WIDE_L1)
    torch.cuda.synchronize()
    l1_s = time.perf_counter() - t0
    l1_peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"shape": [TRAIN_BATCH, TRAIN_N, N_FEATURES], "l1_svm": {},
           "dismec": {}}
    for key, name, model in (("l1_svm", "L1-SVM", l1),
                             ("dismec", "DiSMEC (phase 8)",
                              LinearModel(W=dismec_W.cuda()))):
        ids, st = predict_baseline(f"wide {name}", model, Xte, margin_tol)
        m = evaluate(Yte1, ids, ks=(1, 5))
        counts, _ = weight_histogram(model.W)
        out[key] = dict(density=float(nnz(model.W)) / model.W.numel(),
                        ambiguous=float(ambiguous_fraction(model.W, DELTA)),
                        histogram=counts.tolist(), p_at_1=m["P@1"],
                        p_at_5=m["P@5"], **st)
        print(f"   {name} on labels 0-{TRAIN_BATCH - 1}: density "
              f"{out[key]['density']:.5f}, P@1 {m['P@1']:.4f}, P@5 "
              f"{m['P@5']:.4f}, ambiguous fraction (|w| < {DELTA}) "
              f"{out[key]['ambiguous']:.5f}; kernel 9 launches "
              f"{st['launches']}, ids == plain on {st['agree']}/"
              f"{st['decisive']} decisive rows", flush=True)
        print(f"     weight histogram, 81 bins of [-0.2, 0.2] (Fig. 2): "
              f"{' '.join(map(str, counts.tolist()))}", flush=True)
    out["l1_svm"].update(train_s=l1_s, step_ms=l1_s / WIDE_L1["n_steps"]
                         * 1e3, peak_gib=l1_peak, **WIDE_L1)
    print(f"   L1-SVM: {WIDE_L1['n_steps']} FISTA steps at lam "
          f"{WIDE_L1['lam']} in {l1_s:.1f} s ({out['l1_svm']['step_ms']:.1f}"
          f" ms a step), max_memory_allocated {l1_peak:.2f} GiB", flush=True)
    del l1, Y1, Yte1
    torch.cuda.empty_cache()
    Y = torch.from_numpy(data.Y_train).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fx = trainers["FastXML"](X, Y, **WIDE_FASTXML)
    torch.cuda.synchronize()
    fx_s = time.perf_counter() - t0
    ids, st = predict_baseline("wide FastXML", fx, Xte, margin_tol)
    m = evaluate(torch.from_numpy(data.Y_test).cuda(), ids)
    out["fastxml"] = dict(build_s=fx_s, **st, **m, **WIDE_FASTXML,
                          leaves=[int(t.leaves.shape[0]) for t in fx.trees])
    print(f"   FastXML over {TRAIN_LABELS} labels: {WIDE_FASTXML['n_trees']}"
          f" trees of depth <= {WIDE_FASTXML['max_depth']} "
          f"({out['fastxml']['leaves']} leaves) built in {fx_s:.1f} s, "
          f"predicted {len(data.X_test)} rows in {st['predict_s']:.3f} s; "
          f"P@1 {m['P@1']:.4f} P@3 {m['P@3']:.4f} P@5 {m['P@5']:.4f}; "
          f"kernel 9 launches {st['launches']}, ids == plain on "
          f"{st['agree']}/{st['decisive']} decisive rows", flush=True)
    del X, Y, fx
    torch.cuda.empty_cache()
    # What stays at the paper-like sizes, and why.
    gram_gb = N_FEATURES ** 2 * 4 / 1e9
    need_gb = 2 * gram_gb + data.X_train.nbytes / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    pd_pflop = PD_SPARSE_STEPS * 2 * 2 * TRAIN_BATCH * TRAIN_N * \
        N_FEATURES / 1e15
    pd_s = PD_SPARSE_STEPS * out["l1_svm"]["step_ms"] / 1e3
    out["kept_small"] = dict(gram_gb=gram_gb, solve_gb=need_gb,
                             card_gb=card_gb, pd_sparse_pflop=pd_pflop,
                             pd_sparse_s=pd_s)
    print(f"   LEML and SLEEC stay at the paper-like sizes: their D x D "
          f"Gram at D = {N_FEATURES:,} is {gram_gb:.1f} GB of fp32; its "
          f"LU factor is a second, and with X they need {need_gb:.1f} GB, "
          f"beyond the card's {card_gb:.1f} GB. PD-Sparse too: "
          f"{PD_SPARSE_STEPS:,} "
          f"steps of two ({TRAIN_BATCH:,} x {TRAIN_N:,} x {N_FEATURES:,}) "
          f"products are {pd_pflop:.2f} PFLOP, ~{pd_s:.0f} s at the rate of"
          f" L1-SVM's steps above.", flush=True)
    return out


def run_baselines(data, dismec_W: torch.Tensor, root: Path,
                  margin_tol: float, cpu_ref) -> dict:
    """Phase 12b: the paper's comparison methods on the card; at the end
    the card's baselines on wiki31k_like are held to the port's on the CPU
    (`cpu_ref`, from `cpu_baselines`)."""
    worker, cpu = cpu_ref
    rows, headline, card31 = table2(root, margin_tol)
    wide = wide_baselines(data, dismec_W, margin_tol)
    t0 = time.perf_counter()
    worker.join()
    print(f"   the port's baselines on {PAPER_LIKE[0]} on the CPU: waited "
          f"{time.perf_counter() - t0:.1f} s for them after the card's work",
          flush=True)
    if "error" in cpu:
        raise cpu["error"]
    vs_cpu = card_against_cpu(cpu["data"], card31, cpu)
    launches = {f"{r['dataset']} {r['method']}": r["launches"]
                for r in rows if r["method"] != "DiSMEC"}
    launches.update({f"wide {k}": wide[k]["launches"]
                     for k in ("l1_svm", "dismec", "fastxml")})
    return dict(table2=rows, headline=headline, card_vs_cpu=vs_cpu,
                wide=wide, topk_launches=launches)


def band_pairs(T: int, window: int) -> int:
    """(query, key) pairs of causal sliding-window attention over T
    positions: query i sees min(i + 1, window) keys."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def check_banded(cfg, gen, flush, cases=LM_KERNEL_CASES) -> dict:
    """Phase 13: kernel 10 against its plain version at `cfg`'s heads
    (hymba's; mixtral's in phase 17c) in each of `cases` ((B, T, dtype)),
    two launches bit for bit, timed like phase 3 beside its bound and
    `F.scaled_dot_product_attention` with a boolean band mask (k and v
    repeated to the query heads outside the timing)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    H, KV, hd, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    rows = []
    for B, T, dt_name in cases:
        dt = getattr(torch, dt_name)
        q = torch.randn((B, T, H, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
        got = band_ops.banded_attention(q, k, v, window=w)
        again = band_ops.banded_attention(q, k, v, window=w)
        want = band_ref.banded_attention(q, k, v, window=w)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = LM_KERNEL_TOL[dt_name]
        _need(torch.equal(got, again), f"banded kernel: two launches differ "
              f"at {(B, T, dt_name)}")
        _need(bool(((got.float() - want.float()).abs()
                    <= tol + tol * want.float().abs()).all()),
              f"banded kernel vs plain at {(B, T, dt_name)}: max |err| "
              f"{err:.3e} beyond {tol}")
        del got, again, want
        es = q.element_size()
        n_bytes = (2 * B * T * H * hd + 2 * B * T * KV * hd) * es
        n_ops = 4.0 * B * H * hd * band_pairs(T, w)
        b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS_PER_S
                           if dt == torch.bfloat16 else FP32_FLOPS_PER_S)
        iters = 5 if T > 4096 else 20
        ms = cuda_ms(lambda: band_ops.banded_attention(q, k, v, window=w),
                     iters, flush)
        plain_ms = cuda_ms(lambda: band_ref.banded_attention(q, k, v,
                                                             window=w),
                           iters, flush)
        qh = q.transpose(1, 2)
        kh = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        vh = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        i = torch.arange(T, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
        try:
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask), iters, flush)
        except RuntimeError as e:
            lib_ms = None
            print(f"   sdpa with a band mask at {(B, T, dt_name)}: {e}")
        del qh, kh, vh, mask, q, k, v
        torch.cuda.empty_cache()
        rows.append(dict(B=B, T=T, dtype=dt_name, window=w,
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         tflops=n_ops / ms / 1e9, bound_share=b_ms / ms))
        print(f"   ({B}, {T:,}) {dt_name}: kernel {ms:.4f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f}% of "
              f"the bound), plain {plain_ms:.4f}, "
              f"sdpa {lib_ms if lib_ms is None else f'{lib_ms:.4f}'}, "
              f"bound {b_ms:.4f} ms ({b_by}); max |err| {err:.3e} "
              f"(tol {tol})", flush=True)
    hgmma = hgmma_count("banded_attn")
    _need(hgmma > 0, "the banded_attn library has no HGMMA: the bf16 "
          "kernel is not on the tensor cores")
    print(f"   banded_attn library: {hgmma} HGMMA instructions in its SASS",
          flush=True)
    return dict(rows=rows, shape=(H, KV, hd, w), hgmma=hgmma)


def decisive_ids(vals_a, ids_a, vals_b, ids_b) -> dict:
    """Top-5 ids of two paths from their top-6: the same five on every row
    whose 5th-to-6th margin (in both paths) is above twice the largest
    rank-wise difference of their top-5 values and above LM_MARGIN;
    whether they also come in the same order is reported."""
    va, vb = vals_a.float().cpu(), vals_b.float().cpu()
    ia, ib = ids_a.cpu(), ids_b.cpu()
    noise = float((va[:, :5] - vb[:, :5]).abs().max())
    margin = torch.minimum(va[:, 4] - va[:, 5], vb[:, 4] - vb[:, 5])
    rows = margin > max(LM_MARGIN, 2 * noise)
    same = (ia[:, :5].sort(dim=1).values ==
            ib[:, :5].sort(dim=1).values).all(dim=1)
    _need(bool(same[rows].all()), f"top-5 ids differ on a decisive row: "
          f"{ia.tolist()} vs {ib.tolist()}, margins {margin.tolist()}")
    return dict(decisive=int(rows.sum()), rows=int(rows.numel()),
                agree=int(same.sum()),
                same_order=int((ia[:, :5] == ib[:, :5]).all(dim=1).sum()),
                margins=margin.tolist(), max_val_diff=noise)


def cache_errors(a: dict, b: dict, t: int, exact_layers: int,
                 first_tol: float) -> dict:
    """Relative Frobenius error of every layer's k and v cache (the first
    t positions): the first `exact_layers` layers bit for bit equal, layers
    0-2 within `first_tol`, all within LM_CACHE."""
    out = {}
    for key in ("k", "v"):
        x, y = a[key][:, :, :t], b[key][:, :, :t]
        _need(all(torch.equal(x[l], y[l]) for l in range(exact_layers)),
              f"{key} caches of layers 0-{exact_layers - 1} differ")
        x, y = x.float(), y.float()
        rel = [float((x[l] - y[l]).norm() / y[l].norm().clamp_min(1e-30))
               for l in range(x.shape[0])]
        out[key] = max(rel)
        out[f"{key}_worst_layer"] = int(np.argmax(rel))
        out[f"{key}_first_layers"] = rel[:3]
    if "ssm" in a and "ssm" in b:
        for n, (x, y) in enumerate(zip(a["ssm"], b["ssm"])):
            out[f"ssm_{n}"] = float((x.float() - y.float()).norm()
                                    / y.float().norm().clamp_min(1e-30))
    _need(out["k"] <= LM_CACHE and out["v"] <= LM_CACHE and
          max(out["k_first_layers"] + out["v_first_layers"]) <= first_tol,
          f"k/v caches differ beyond {LM_CACHE} (or layers 0-2 beyond "
          f"{first_tol}): {out}")
    return out


def lm_prefill(model, params, rng) -> dict:
    """Phase 14: `prefill` at (1, 32,768) on the kernel, then on the plain
    version, then on the plain version run in fp32 (the kernel's own
    rounding: fp32 throughout, the output rounded to bf16 once): kernel 10
    launched once per local layer and nowhere else, the top-5 ids equal
    on a decisive row, every layer's caches close."""
    from unittest import mock

    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.models import transformer
    cfg = model.cfg
    B, T = LM_PREFILL
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    wins = transformer.layer_windows_static(cfg, use_swa=True)
    n_local = sum(1 for w in wins if w)
    first_local = next(n for n, w in enumerate(wins) if w)
    batch = {"tokens": toks}
    model.prefill(params, {"tokens": toks[:, :64]}, use_swa=True)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    band_ops.banded_attention_cuda.launches = 0
    topk_ops.blocked_topk_cuda.launches = 0
    t0 = time.perf_counter()
    v, i, cache = model.prefill(params, batch, use_swa=True, top_k=6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(banded_attention=band_ops.banded_attention_cuda.launches,
                    blocked_topk=topk_ops.blocked_topk_cuda.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _need(launches["banded_attention"] == n_local,
          f"prefill launched the banded kernel {launches} times, expected "
          f"{n_local} (one per local layer)")
    _need(launches["blocked_topk"] > 0, "prefill ran no blocked top-k")

    def plain(q, k, v, *, window, softcap=None, q_chunk=512):
        return band_ref.banded_attention(q, k, v, window=window,
                                         q_chunk=q_chunk, softcap=softcap)

    def plain_f32(q, k, v, *, window, softcap=None, q_chunk=512):
        return plain(q.float(), k.float(), v.float(), window=window,
                     softcap=softcap, q_chunk=q_chunk).to(q.dtype)
    runs = {}
    for name, fn in (("plain", plain), ("plain, fp32", plain_f32)):
        with mock.patch.object(band_ops, "banded_attention", fn):
            before = band_ops.banded_attention_cuda.launches
            t0 = time.perf_counter()
            pv, pi, pcache = model.prefill(params, batch, use_swa=True,
                                           top_k=6)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
            _need(band_ops.banded_attention_cuda.launches == before,
                  f"the {name} prefill launched the kernel")
        runs[name] = dict(wall_s=wall_p, top5=decisive_ids(v, i, pv, pi),
                          cache_rel_err=cache_errors(cache, pcache, T,
                                                     first_local + 1,
                                                     LM_CACHE_FIRST),
                          ids=pi[0, :5].tolist())
        del pcache
        torch.cuda.empty_cache()
    del cache
    profile = profile_prefill(model, params, batch)
    out = dict(B=B, T=T, wall_s=wall, tokens_per_s=B * T / wall,
               peak_gib=peak, launches=launches, n_local_layers=n_local,
               ids=i[0, :5].tolist(), vs=runs, profile=profile)
    print(f"   prefill ({B}, {T:,}): {wall:.3f} s on the kernel "
          f"({B * T / wall:,.0f} tokens/s); peak {peak:.2f} GiB; launches "
          f"{launches}; top-5 ids {i[0, :5].tolist()}", flush=True)
    for name, r in runs.items():
        e = r["cache_rel_err"]
        print(f"   vs {name}: {r['wall_s']:.3f} s; top-5 ids {r['ids']} "
              f"(5th-6th margin {r['top5']['margins'][0]:.4f}, decisive rows "
              f"{r['top5']['decisive']}, max |value diff| "
              f"{r['top5']['max_val_diff']:.3e}); k/v rel err "
              f"{e['k']:.2e} / {e['v']:.2e} (layers 0-2 {e['k_first_layers']}"
              f"), ssm {e.get('ssm_0', 0):.2e} / {e.get('ssm_1', 0):.2e}",
              flush=True)
    return out


def profile_prefill(model, params, batch, top: int = 10) -> dict:
    """One more kernel prefill under `torch.profiler` (`profiled`)."""
    return profiled("prefill", lambda: model.prefill(
        params, batch, use_swa=True, top_k=6), top)[1]


def profiled(what: str, fn, top: int = 10):
    """fn() under `torch.profiler` (device activity only) -> (its result,
    the device time of the `top` device operations that take the most,
    their launch counts, and the device total and wall)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    total = sum(map(device_us, events)) / 1e3
    ops = [dict(op=re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                          e.key)[:100], ms=device_us(e) / 1e3, count=e.count)
           for e in sorted(events, key=lambda e: -device_us(e))[:top]]
    print(f"   profiled {what}: {total:.1f} ms of device time against "
          f"{1e3 * wall:.1f} ms of wall (traced), "
          f"{sum(e.count for e in events)} device operations; the {top} "
          "that take the most:", flush=True)
    for o in ops:
        print(f"     {o['ms']:9.2f} ms  {o['count']:6d} x  {o['op']}",
              flush=True)
    return out, dict(device_ms=total, traced_wall_ms=1e3 * wall,
                     device_ops=sum(e.count for e in events), top=ops)


def lm_decode(model, params, rng) -> dict:
    """Phase 15a: `prefill` at (2, 2,304) against 2,304 teacher-forced
    `decode_step`s on a cache of length 2,304 (the model of
    LM_DECODE_LAYERS layers): every layer's k and v caches close, and the
    last position's top-5 ids equal on decisive rows."""
    cfg = model.cfg
    B, T = LM_DECODE
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    v, i, cache_p = model.prefill(params, {"tokens": toks}, use_swa=True,
                                  top_k=6)
    cache_d = model.init_cache(B, T, use_swa=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T):
        dv, di, cache_d = model.decode_step(params, cache_d,
                                            toks[:, t:t + 1], t,
                                            use_swa=True, top_k=6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = decisive_ids(v, i, dv, di)
    errs = cache_errors(cache_p, cache_d, T, 0, LM_CACHE_FIRST_DECODE)
    del cache_p, cache_d
    trace = trace_decode(model, params, toks)
    print(f"   {T:,} decode steps at B = {B}, {cfg.n_layers} layers: "
          f"{wall:.1f} s "
          f"({1e3 * wall / T:.2f} ms a step); last-position top-5 "
          f"{i[:, :5].tolist()} vs {di[:, :5].tolist()}, decisive rows "
          f"{ids['decisive']} of {ids['rows']}, max |value diff| "
          f"{ids['max_val_diff']:.3e}; k/v rel err {errs['k']:.2e} / "
          f"{errs['v']:.2e} (worst layers {errs['k_worst_layer']}, "
          f"{errs['v_worst_layer']}); ssm {errs.get('ssm_0', 0):.2e} / "
          f"{errs.get('ssm_1', 0):.2e}", flush=True)
    return dict(B=B, T=T, n_layers=cfg.n_layers, decode_wall_s=wall,
                ms_per_step=1e3 * wall / T,
                top5=ids, cache_rel_err=errs, trace=trace)


def trace_decode(model, params, toks, n: int = 5) -> dict:
    """`torch.profiler` over n decode steps (after 3 untraced): the device
    time a step against the host's, the kernel launches a step, and the
    host operations that cost most."""
    from torch.profiler import ProfilerActivity, profile
    B = toks.shape[0]
    cache = model.init_cache(B, toks.shape[1], use_swa=True)
    for t in range(3):
        model.decode_step(params, cache, toks[:, t:t + 1], t, use_swa=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(3, 3 + n):
            model.decode_step(params, cache, toks[:, t:t + 1], t,
                              use_swa=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)[:5]
    out = dict(steps=n, device_ms_per_step=sum(map(device_us, events))
               / 1e3 / n, traced_wall_ms_per_step=1e3 * wall / n,
               launches_per_step=launches / n,
               host_ops=[dict(op=e.key, calls_per_step=e.count / n,
                              us_per_call=e.self_cpu_time_total / e.count)
                         for e in host])
    dev, traced = out["device_ms_per_step"], out["traced_wall_ms_per_step"]
    print(f"   trace of {n} decode steps: {dev:.2f} ms of device time a "
          f"step against {traced:.2f} ms of wall (traced); "
          f"{out['launches_per_step']:.0f} kernel launches a step; "
          f"costliest host ops: " + ", ".join(
              f"{h['op']} {h['calls_per_step']:.0f} x {h['us_per_call']:.0f}"
              f" us" for h in out["host_ops"]), flush=True)
    return out


def lm_serve(model, params, rng) -> dict:
    """Phase 15b (17b): `serve_batch` with ragged prompts of 4-12 tokens,
    greedy decode, `use_swa` as the architecture has it; the blocked top-k
    kernel launched once a decode step for the head and once a layer for
    a MoE router, and nowhere else."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.serve import serve_batch
    cfg = model.cfg
    use_swa = cfg.swa_always
    reqs = [rng.integers(2, cfg.vocab, size=rng.integers(4, 13))
            for _ in range(LM_SERVE["batch"])]
    serve_batch(model, params, reqs[:1], steps=2, use_swa=use_swa)  # warm
    topk_ops.blocked_topk_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve_batch(model, params, reqs, steps=LM_SERVE["steps"],
                       use_swa=use_swa)
    wall = time.perf_counter() - t0
    launches = topk_ops.blocked_topk_cuda.launches
    T0 = max(len(r) for r in reqs)
    n_steps = T0 + LM_SERVE["steps"] - 1
    per_step = 1 + (cfg.n_layers if cfg.family == "moe" else 0)
    _need(launches == n_steps * per_step,
          f"serve_batch launched the top-k kernel {launches} times, "
          f"expected {per_step} per decode step ({n_steps * per_step})")
    _need(all(o.shape == (LM_SERVE["steps"],) and
              0 <= o.min() and o.max() < cfg.padded_vocab() for o in outs),
          f"serve_batch returned {[o.tolist() for o in outs]}")
    n_tok = LM_SERVE["batch"] * LM_SERVE["steps"]
    print(f"   {len(reqs)} prompts of {[len(r) for r in reqs]} tokens, "
          f"{LM_SERVE['steps']} steps: {wall:.3f} s, "
          f"{1e3 * wall / n_tok:.2f} ms a generated token, "
          f"{1e3 * wall / n_steps:.2f} ms a decode step; top-k launches "
          f"{launches}; req[0] -> {outs[0].tolist()}", flush=True)
    return dict(prompt_lens=[len(r) for r in reqs], wall_s=wall,
                ms_per_token=1e3 * wall / n_tok, topk_launches=launches)


def lm_cli(arch: str = LM_ARCH) -> dict:
    """Phase 15c (17b): the serving CLI's LM mode at full width on the
    card."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           arch, "--steps", str(LM_SERVE["steps"]), "--batch",
           str(LM_SERVE["batch"])]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    _need(out.returncode == 0 and out.stdout.count("req[") ==
          LM_SERVE["batch"], f"the LM CLI exited {out.returncode}:\n"
          f"{out.stdout}\n{out.stderr}")
    last = out.stdout.strip().splitlines()[-1]
    print(f"   exit 0 in {wall:.1f} s: {last}", flush=True)
    return dict(returncode=0, wall_s=wall, summary=last)


def kernel_counters() -> dict:
    """All ten kernels' launchers, whose `.launches` counts their launches,
    by the names of the kernels' JSON line."""
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    return {**serving_kernels(),
            "hinge_obj_grad": hinge_ops.hinge_obj_grad_cuda,
            "hvp": hvp_ops.hvp_cuda,
            "banded_attention": band_ops.banded_attention_cuda}


def train_prefix(cfg, lead: tuple, seed) -> np.ndarray:
    """The prefix of a training batch (lead + (n_prefix, d_model)): a
    VLM's the JAX launcher's stand-in patch embeddings, 0.01 everywhere;
    an encoder-decoder's frames N(0, 0.05^2) from the seed. Frames of one
    constant make every encoder layernorm's input a constant row, whose
    variance is 0 up to rounding: the encoder's output is then rounding
    noise times rsqrt(eps), no two summation orders agree, and neither
    card against CPU nor bf16 against fp32 can be compared."""
    shape = (*lead, cfg.n_prefix, cfg.d_model)
    if not cfg.is_encoder_decoder:
        return np.full(shape, 0.01, np.float32)
    return (0.05 * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def lm_batches(cfg, seed: int, *, accum: int, micro: int, T: int,
               steps: int) -> list:
    """`steps` TokenPipeline batches of accum x micro sequences of T
    tokens, each leaf shaped (accum, micro, T) for `make_train_step`."""
    from repro_torch.data.lm import make_lm_batch_iterator
    it = make_lm_batch_iterator(cfg.vocab, T, accum * micro, seed=seed)
    return [{k: v.reshape(accum, micro, T) for k, v in next(it).items()}
            for _ in range(steps)]


def grad_error(got: dict, want: dict) -> float:
    """The largest |got - want| over every element of every parameter's
    gradient, over the largest |want| element."""
    mag = max(float(w.abs().max()) for w in want.values())
    return max(float((got[n].cpu().double() - w.cpu().double()).abs().max())
               for n, w in want.items()) / mag


def lm_train_smoke(seed: int) -> list:
    """Phase 16 (a): the smoke configs on the card against the port on the
    CPU, both heads (see LM_TRAIN_SMOKE)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)
    sh = LM_TRAIN_SMOKE_SHAPE
    lr_fn = linear_warmup_cosine(*LM_TRAIN_LR)
    tol = LM_TRAIN_TOL
    rows = []
    for arch in LM_TRAIN_SMOKE:
        for head in ("dismec", "softmax"):
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      head_type=head)
            models = {"cpu": build_lm(cfg, device="cpu"),
                      "cuda": build_lm(cfg)}
            p0 = models["cpu"].init(torch.Generator().manual_seed(seed))
            batches = lm_batches(cfg, seed, accum=sh["accum"],
                                 micro=sh["micro"], T=sh["T"],
                                 steps=sh["steps"])
            grads = {dev: loss_and_grads(m, copy.deepcopy(p0).to(dev),
                                         batches[0], sh["accum"])[2]
                     for dev, m in models.items()}
            g_err = grad_error(grads["cuda"], grads["cpu"])
            updated = {}
            for dev in models:
                p = copy.deepcopy(p0).to(dev)
                adamw_update(p, {n: g.to(dev) for n, g in
                                 grads["cuda"].items()}, adamw_init(p),
                             lr_fn(1))
                updated[dev] = [t.detach().cpu() for t in p.parameters()]
            adam_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-3))
                                 .max()) for a, b in zip(*updated.values()))

            def run(dev):
                p = copy.deepcopy(p0).to(dev)
                step = make_train_step(models[dev], lr_fn=lr_fn,
                                       accum=sh["accum"])
                st = init_train_state(p)
                opt, s, losses = st.opt, st.step, []
                for b in batches:
                    p, opt, met = step(p, opt, s, b)
                    s = s + 1
                    losses.append(float(met["loss"]))
                return [t.detach() for t in p.parameters()], losses
            _, host_losses = run("cpu")
            (pa, la), (pb, lb) = run("cuda"), run("cuda")
            bits = la == lb and all(torch.equal(a, b)
                                    for a, b in zip(pa, pb))
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(la, host_losses))
            row = dict(arch=cfg.name, head=head, losses=la,
                       cpu_losses=host_losses, loss_rel_err=loss_err,
                       grad_err=g_err, adam_rel_err=adam_err,
                       bit_for_bit=bits)
            rows.append(row)
            print(f"   {cfg.name} {head}: losses {[f'{x:.4f}' for x in la]}"
                  f" (CPU {[f'{x:.4f}' for x in host_losses]}), rel err "
                  f"{loss_err:.2e}; first gradients {g_err:.2e} of their "
                  f"magnitude; adamw card vs CPU {adam_err:.2e}; two card "
                  f"runs bit for bit: {bits}", flush=True)
            _need(loss_err <= tol["loss"] and g_err <= tol["grad"] and
                  adam_err <= tol["adam"] and bits,
                  f"lm train {cfg.name} {head}: card vs CPU beyond "
                  f"{tol}: {row}")
    return rows


def flops_per_step(cfg, n_params: int, *, sequences: int, T: int) -> float:
    """6 N tokens plus causal attention's products, forward and backward
    (12 H hd per query-key pair a layer; no recompute counted)."""
    pairs = T * (T + 1) // 2
    return (6.0 * n_params * sequences * T + 12.0 * cfg.n_layers *
            cfg.n_heads * cfg.head_dim * pairs * sequences)


def lm_train_full(seed: int, settle=None) -> dict:
    """Phase 16 (b): hymba-1.5b at full width in bf16 (LM_TRAIN_FULL);
    `settle`: as `bf16_training`'s."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    return bf16_training(cfg, seed, LM_TRAIN_FULL, groups={
        "embed": "embed", "head": "head",
        **{f"block {b}": f"blocks.{b}" for b in (0, L // 2 - 1, L - 1)}},
        last=f"block {L - 1}", profile=True, settle=settle)


def bf16_training(cfg, seed: int, sh: dict, *, groups: dict, last: str,
                  profile: bool = False, settle=None) -> dict:
    """cfg at full width in bf16, `sh`'s (accum, micro, T) and steps of
    TokenPipeline batches (with `train_prefix` for a config that has a
    prefix): the first batch's gradients against an fp32
    copy's (the loss, and the cosine of the `groups` of parameters, the
    head's and `last`'s held), then the steps; `profile`: that bf16
    fwd+bwd under `torch.profiler`, and the share of the bf16 peak.
    `settle()`, where given, returns once other work on the host and the
    card has ended: it is called after the fp32 pass, before anything
    that is timed."""
    import copy

    from repro_torch.models.model import build_model as build_lm
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    batches = lm_batches(cfg, seed, accum=sh["accum"], micro=sh["micro"],
                         T=sh["T"], steps=sh["steps"])
    if cfg.n_prefix:
        for k, b in enumerate(batches):
            b["prefix"] = train_prefix(cfg, (sh["accum"], sh["micro"]),
                                       [seed, k])
    # The first batch through an fp32 copy of the same weights.
    p32 = copy.deepcopy(params).float()
    l32, _, g32 = loss_and_grads(model, p32, batches[0], sh["accum"])
    del p32
    if settle is not None:
        settle()

    def first():
        return loss_and_grads(model, params, batches[0], sh["accum"])
    if profile:
        (l16, _, g16), prof = profiled(
            "bf16 loss and gradients of the first batch (no optimizer "
            "step)", first)
    else:
        (l16, _, g16), prof = first(), None
    dot = sum(float((g16[n].double() * g32[n].double()).sum()) for n in g32)
    sq16 = sum(float(g16[n].double().square().sum()) for n in g32)
    sq32 = sum(float(g32[n].double().square().sum()) for n in g32)
    cos = dot / math.sqrt(sq16 * sq32)
    loss_err = abs(float(l16) - float(l32)) / abs(float(l32))
    group_err, group_cos = {}, {}
    for name, key in groups.items():
        keys = [n for n in g32 if n == key or n.startswith(key + ".")]
        a = [g16[n].double() for n in keys]
        b = [g32[n].double() for n in keys]
        d = sum(float((x - y).square().sum()) for x, y in zip(a, b))
        w = sum(float(y.square().sum()) for y in b)
        group_err[name] = math.sqrt(d / w)
        group_cos[name] = sum(float((x * y).sum()) for x, y in zip(a, b)) \
            / math.sqrt(sum(float(x.square().sum()) for x in a) * w)
    del g32, g16
    torch.cuda.empty_cache()
    print(f"   bf16 against fp32 on the first batch: loss {float(l16):.4f} "
          f"vs {float(l32):.4f} (rel {loss_err:.2e}), flattened gradient "
          f"cosine {cos:.6f}; by group, relative error and cosine: " +
          ", ".join(f"{k} {group_err[k]:.3e} / {group_cos[k]:.6f}"
                    for k in groups), flush=True)
    _need(loss_err <= LM_TRAIN_TOL["bf16_loss"] and
          min(group_cos["head"], group_cos[last]) >= LM_TRAIN_TOL["cos"],
          f"bf16 vs fp32: loss rel err {loss_err:.3e}, cosine of the head "
          f"{group_cos['head']:.4f}, of {last} {group_cos[last]:.4f}")

    step = make_train_step(model, lr_fn=linear_warmup_cosine(*LM_TRAIN_LR),
                           accum=sh["accum"])
    st = init_train_state(params)
    opt, s = st.opt, st.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, s, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        s = s + 1
        hist.append({k: float(v) for k, v in met.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    _need(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"a non-finite loss or grad_norm: {hist}")
    half = len(losses) // 2
    late = float(np.mean(losses[half:]))
    _need(late < losses[0], f"the loss did not fall: steps {half}-"
          f"{len(losses) - 1} mean {late:.4f} against step 0's "
          f"{losses[0]:.4f}")
    tokens = sh["accum"] * sh["micro"] * sh["T"]
    s_step = float(np.median(secs[1:]))
    # The decoder-only count; an encoder-decoder's is not this formula.
    flops = None if cfg.is_encoder_decoder else flops_per_step(
        cfg, n_params, sequences=sh["accum"] * sh["micro"], T=sh["T"])
    share = None if flops is None else flops / s_step / BF16_FLOPS_PER_S
    norms = " ".join(f"{h['grad_norm']:.3g}" for h in hist)
    rate = "" if flops is None else (
        f"; {flops / 1e12:.1f} TFLOP a step, {100 * share:.1f}% of the bf16 "
        "dense peak")
    plus = f" + {cfg.n_prefix:,} frames" if cfg.is_encoder_decoder else ""
    print(f"   {cfg.name} ({n_params / 1e9:.3f} B parameters): "
          f"{len(hist)} steps of {tokens:,} tokens{plus} ((accum, micro, "
          f"T) = ({sh['accum']}, {sh['micro']}, {sh['T']:,})): loss "
          f"{' '.join(f'{x:.2f}' for x in losses)}; grad_norm {norms}; "
          f"{s_step:.3f} s a step (median of steps 1-{len(secs) - 1}; "
          f"step 0 {secs[0]:.3f} s), {tokens / s_step:,.0f} tokens/s, "
          f"peak {peak:.2f} GiB{rate}", flush=True)
    del model, params, opt
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n_params, **sh, lr=LM_TRAIN_LR,
                history=hist, seconds=secs, s_per_step=s_step,
                tokens_per_s=tokens / s_step, peak_gib=peak,
                tflop_per_step=None if flops is None else flops / 1e12,
                bf16_peak_share=share, profile=prof,
                bf16_vs_fp32=dict(loss16=float(l16), loss32=float(l32),
                                  loss_rel_err=loss_err, grad_cosine=cos,
                                  group_rel_err=group_err,
                                  group_cosine=group_cos))


def jax_layout_keys(params) -> dict:
    """The JAX package's pytree key of each parameter and its shape there:
    `blocks.<i>.a.b` is `blocks/a/b`, stacked over the layers (an
    encoder-decoder's `enc_blocks` and `dec_blocks` each over its own)."""
    from repro_torch.convert import lm_jax_tree

    def flat(node, prefix=""):
        if isinstance(node, dict):
            return {k: v for key, sub in node.items()
                    for k, v in flat(sub, f"{prefix}{key}/").items()}
        if isinstance(node, list):
            return {k: v for i, sub in enumerate(node)
                    for k, v in flat(sub, f"{prefix}{i}/").items()}
        return {prefix[:-1]: list(node.shape)}
    return flat(lm_jax_tree(params, lambda t: torch.empty(t.shape,
                                                          device="meta")))


def start_train_cli(build_dir: Path, arch: str = LM_ARCH,
                    mesh: tuple | None = None,
                    c: dict = LM_TRAIN_CLI) -> dict:
    """Starts the training CLI of phase 16 (c) (18e) on the card in a
    process of its own, at `c`'s steps, seq_len and batch (`--mesh DxM
    --device cuda:0`: the grid on the one card), writing into a new
    directory under `build_dir`; `lm_train_cli` waits for it and checks
    it."""
    out = tempfile.mkdtemp(dir=build_dir)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--smoke", "--steps", str(c["steps"]), "--seq-len",
           str(c["seq_len"]), "--batch", str(c["batch"])]
    if mesh:
        cmd += ["--mesh", f"{mesh[0]}x{mesh[1]}", "--device", "cuda:0"]
    cmd += ["--out", out]
    h = dict(arch=arch, mesh=mesh, c=c, cmd=cmd, out=out)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ,
                                                    PYTHONPATH=str(SRC)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def wait():
        try:
            h["stdout"], h["stderr"] = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            h["rc"] = proc.returncode
            h["wall"] = time.perf_counter() - t0
    h["thread"] = threading.Thread(target=wait, name=f"cli {arch}")
    h["thread"].start()
    return h


def lm_train_cli(h: dict) -> dict:
    """Phase 16 (c) (18e): the training CLI started by `start_train_cli`
    exits 0 with its loss falling; then the same training in this process
    (the CLI's seed 0 and defaults, its prefix batches, its mesh and batch
    axes): `restore_pytree` of its checkpoint gives those weights bit for
    bit, and its index has every key of the JAX layout."""
    import shutil
    h["thread"].join()
    try:
        return _check_train_cli(h)
    finally:
        shutil.rmtree(h["out"], ignore_errors=True)


def _check_train_cli(h: dict) -> dict:
    from repro_torch.checkpoint.io import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.data.lm import make_lm_batch_iterator
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.train.trainer import train_loop
    arch, mesh, c, cmd, out = (h[k] for k in ("arch", "mesh", "c", "cmd",
                                                "out"))
    _need(h["rc"] == 0, f"the training CLI exited {h['rc']}:\n"
          f"{h.get('stdout')}\n{h.get('stderr')}")
    summary = next(line for line in h["stdout"].splitlines()
                   if line.startswith("# trained"))
    first, last = (float(x) for x in re.search(
        r"loss (\S+) -> (\S+)$", summary).groups())
    _need(last < first, f"the CLI's loss did not fall: {summary}")
    cfg = get_config(arch, smoke=True)
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prefix = np.ones((c["batch"], cfg.n_prefix, cfg.d_model),
                     np.float32) * 0.01
    batches = ({**b, "prefix": prefix} if cfg.n_prefix else b
               for b in make_lm_batch_iterator(cfg.vocab, c["seq_len"],
                                               c["batch"]))
    params, _ = train_loop(model, params, batches, steps=c["steps"],
                           mesh=grid(mesh) if mesh else None,
                           batch_axes=ED_AXES if mesh else ())
    restored = restore_pytree(params, out)
    same = all(torch.equal(a, b) for a, b in
               zip(restored.parameters(), params.parameters()))
    with open(os.path.join(out, "index.json")) as f:
        entries = json.load(f)["entries"]
    want = jax_layout_keys(params)
    missing = sorted(k for k, shape in want.items()
                     if entries.get(k, {}).get("shape") != shape)
    print(f"   `{' '.join(cmd[2:-2])}`: exit 0 in {h['wall']:.1f} s (its "
          f"process, beside other work); {summary}; restored == trained in "
          f"this process bit for bit: {same}; {len(want)} JAX-layout keys, "
          f"missing or misshapen: {missing}", flush=True)
    _need(same, "the CLI's checkpoint is not the weights this process "
          "trained with the same seed and batches")
    _need(not missing, f"index.json lacks JAX-layout keys: {missing}")
    return dict(cmd=cmd[2:-2], wall_s=h["wall"], summary=summary,
                loss_first=first, loss_last=last, bit_for_bit=same,
                keys=len(want))


def start_train_clis(build_dir: Path) -> dict:
    """Phase 16 (c)'s and 18 (e)'s training CLIs, started together."""
    return {"lm": start_train_cli(build_dir),
            "seamless": start_train_cli(build_dir, ED_ARCH, c=ED_CLI),
            "mesh": start_train_cli(build_dir, "qwen1.5-0.5b", ED_MESH,
                                    c=ED_CLI)}


def lm_train(seed: int, build_dir: Path, clis: dict | None = None) -> dict:
    """Phase 16: (a), (b) and (c), with every kernel's launch count set to
    0 just before and read just after: training runs none of them. `clis`
    (`start_train_clis`): the CLIs, started before the phase; without
    them (c) starts its own."""
    if clis is None:
        clis = {"lm": start_train_cli(build_dir)}
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    out, walls = {}, {}

    def settle():
        # (b)'s profile and steps are timed with the card and the host to
        # themselves: the CLIs run beside (a) and (b)'s fp32 pass only.
        t0 = time.perf_counter()
        for h in clis.values():
            h["thread"].join()
        walls["cli_wait"] = time.perf_counter() - t0
        print(f"   waited {walls['cli_wait']:.1f} s for the training CLIs "
              f"before (b)'s timed work", flush=True)
    for part, run in (("smoke", lambda: lm_train_smoke(seed)),
                      ("full", lambda: lm_train_full(seed, settle)),
                      ("cli", lambda: lm_train_cli(clis["lm"]))):
        t0 = time.perf_counter()
        out[part] = run()
        walls[part] = time.perf_counter() - t0
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["wall_s"] = walls
    print("   (a), (b), (c) took " + ", ".join(
        f"{walls[k]:.1f}" for k in ("smoke", "full", "cli")) +
        f" s ((b) with its {walls['cli_wait']:.1f} s wait)", flush=True)
    _need(not any(out["launches"].values()),
          f"LM training launched a kernel: {out['launches']}")
    print(f"   kernel launches in the phase: {out['launches']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: the moe, ssm and prefix families (ROADMAP A-8c)
# ---------------------------------------------------------------------------

def new_family_counters() -> dict:
    """The two kernels these families run: kernel 9 (the head's and every
    MoE router's top-k) and kernel 10 (mixtral's sliding window)."""
    c = kernel_counters()
    return {k: c[k] for k in ("blocked_topk", "banded_attention")}


@contextlib.contextmanager
def counted(launches: dict, name: str):
    """Sets kernels 9 and 10's counts to 0 just before the block and
    stores what the block launched under `name`."""
    fns = new_family_counters()
    for fn in fns.values():
        fn.launches = 0
    yield
    launches[name] = {k: fn.launches for k, fn in fns.items()}


def smoke_inputs(cfg, seed: int) -> tuple[dict, np.ndarray]:
    """Phase 17a's prefill batch and its decode tokens."""
    rng = np.random.default_rng([seed, 17])
    T = FAM_SMOKE["T_swa"] if cfg.swa_always else FAM_SMOKE["T"]
    batch = {"tokens": rng.integers(2, cfg.vocab, size=(2, T))}
    if cfg.n_prefix:
        batch["prefix"] = (0.05 * rng.normal(
            size=(2, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    return batch, rng.integers(2, cfg.vocab, size=(2, FAM_SMOKE["decode"]))


def cache_rel(a: dict, b: dict) -> dict:
    """Each cache entry's largest relative error over its layers (k/v and
    an encoder's memory k/v: relative Frobenius per layer; each recurrent state's C exp(m) for an
    mLSTM, every field for an sLSTM), float64."""
    out = {}
    if "states" in a:
        for n, (x, y) in enumerate(zip(a["states"], b["states"])):
            if hasattr(x, "C"):
                fx = x.C.double().cpu() * torch.exp(
                    x.m.double().cpu())[..., None, None]
                fy = y.C.double().cpu() * torch.exp(
                    y.m.double().cpu())[..., None, None]
                out[f"state_{n}"] = float((fx - fy).norm() / fy.norm())
            else:
                out[f"state_{n}"] = max(
                    float((u.double().cpu() - w.double().cpu()).norm() /
                          w.double().cpu().norm().clamp_min(1e-300))
                    for u, w in zip(x[:3], y[:3]))
        return out
    for key in ("k", "v", "mem_k", "mem_v"):
        if key not in a:
            continue
        x, y = a[key].double().cpu(), b[key].double().cpu()
        out[key] = max(float((x[l] - y[l]).norm() / y[l].norm())
                       for l in range(x.shape[0]))
    return out


def caches_equal(a: dict, b: dict) -> bool:
    if "states" in a:
        return all(torch.equal(u, w) for x, y in zip(a["states"],
                                                     b["states"])
                   for u, w in zip(x, y))
    return all(all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
               if isinstance(a[k], tuple) else torch.equal(a[k], b[k])
               for k in a)


def continued(cache: dict, cfg, n: int) -> dict:
    """A copy of a prefill cache with room for n more positions (a ring
    cache, recurrent states and an encoder's memory continue as they
    are)."""
    if "states" in cache:
        return {"states": [type(s)(*(t.clone() for t in s))
                           for s in cache["states"]]}
    if cfg.swa_always:
        return {k: t.clone() for k, t in cache.items()}
    return {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
            if k in ("k", "v") else t.clone() for k, t in cache.items()}


def fam_smoke_one(arch: str, seed: int) -> dict:
    """Phase 17a for one smoke config (fp32): the card against the port on
    the CPU and against itself (see FAM_SMOKE)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)
    cfg = get_config(arch, smoke=True)
    models = {"cpu": build_lm(cfg, device="cpu"), "cuda": build_lm(cfg)}
    p0 = models["cpu"].init(torch.Generator().manual_seed(seed))
    batch, dec = smoke_inputs(cfg, seed)
    # A VLM's prefix takes positions; an encoder-decoder's frames do not.
    T = batch["tokens"].shape[1] + (0 if cfg.is_encoder_decoder else
                                    cfg.n_prefix)
    sh = LM_TRAIN_SMOKE_SHAPE
    tb = lm_batches(cfg, seed, accum=sh["accum"], micro=sh["micro"],
                    T=sh["T"], steps=1)[0]
    if cfg.n_prefix:
        tb["prefix"] = train_prefix(cfg, (sh["accum"], sh["micro"]), seed)
    lr_fn = linear_warmup_cosine(*LM_TRAIN_LR)
    runs, launches = {}, {}

    def serve(dev, tag):
        m = models[dev]
        p = copy.deepcopy(p0).to(dev)
        with counted(launches, tag), moe.count_dropped() as drops:
            v, i, cache = m.prefill(p, batch, use_swa=cfg.swa_always,
                                    top_k=6)
            c = continued(cache, cfg, FAM_SMOKE["decode"])
            steps = []
            for s in range(FAM_SMOKE["decode"]):
                dv, di, c = m.decode_step(p, c, dec[:, s:s + 1], T + s,
                                          use_swa=cfg.swa_always, top_k=6)
                steps.append((dv.cpu(), di.cpu()))
        prefill_drops = [int(d) for _, d in drops[:cfg.n_layers]] \
            if cfg.family == "moe" else []
        return dict(v=v.cpu(), i=i.cpu(), cache=cache, steps=steps, end=c,
                    drops=prefill_drops)

    def train(dev):
        p = copy.deepcopy(p0).to(dev)
        mb = {k: v[0] for k, v in tb.items()}
        _, met = models[dev].train_loss(p, mb)
        loss, _, grads = loss_and_grads(models[dev], p, tb, sh["accum"])
        step = make_train_step(models[dev], lr_fn=lr_fn, accum=sh["accum"])
        st = init_train_state(p)
        p, _, _ = step(p, st.opt, st.step, tb)
        return dict(loss=float(loss), aux=float(met["aux"]), grads=grads,
                    params=[t.detach().cpu() for t in p.parameters()])

    runs["cpu"] = serve("cpu", "cpu")
    runs["cuda"] = serve("cuda", "cuda")
    again = serve("cuda", "cuda again")
    a, b = runs["cuda"], runs["cpu"]
    torch.cuda.synchronize()
    bits = (torch.equal(a["v"], again["v"]) and
            torch.equal(a["i"], again["i"]) and
            caches_equal(a["cache"], again["cache"]) and
            caches_equal(a["end"], again["end"]) and
            a["drops"] == again["drops"])
    ids = decisive_ids(a["v"], a["i"], b["v"], b["i"])
    val_err = float((a["v"] - b["v"]).abs().max())
    dec_err = max(float((x[0] - y[0]).abs().max())
                  for x, y in zip(a["steps"], b["steps"]))
    for (av, ai), (bv, bi) in zip(a["steps"], b["steps"]):
        decisive_ids(av, ai, bv, bi)
    rel = {"prefill": cache_rel(a["cache"], b["cache"]),
           "decode": cache_rel(a["end"], b["end"])}
    tr = {dev: train(dev) for dev in ("cpu", "cuda")}
    tr2 = train("cuda")
    g_err = grad_error(tr["cuda"]["grads"], tr["cpu"]["grads"])
    loss_err = abs(tr["cuda"]["loss"] - tr["cpu"]["loss"]) / \
        abs(tr["cpu"]["loss"])
    aux_err = abs(tr["cuda"]["aux"] - tr["cpu"]["aux"]) / \
        max(abs(tr["cpu"]["aux"]), 1e-30)
    train_bits = all(torch.equal(x, y) for x, y in
                     zip(tr["cuda"]["params"], tr2["params"]))
    worst = max(max(r.values()) for r in rel.values())
    row = dict(arch=cfg.name, T=T, prefill_ids=ids, prefill_val_err=val_err,
               decode_val_err=dec_err, cache_rel=rel, drops=a["drops"],
               cpu_drops=b["drops"], bit_for_bit=bits,
               train=dict(loss=tr["cuda"]["loss"], cpu_loss=tr["cpu"]["loss"],
                          loss_rel_err=loss_err, grad_err=g_err,
                          aux=tr["cuda"]["aux"], aux_rel_err=aux_err,
                          bit_for_bit=train_bits),
               launches=launches["cuda"])
    print(f"   {cfg.name} (T = {T:,}): top-5 {a['i'][0, :5].tolist()}, "
          f"values {val_err:.2e} from the CPU's, decode {dec_err:.2e}; "
          f"caches/states {worst:.2e}; drops {a['drops']} (CPU "
          f"{b['drops']}); train loss {loss_err:.2e}, gradients "
          f"{g_err:.2e}, aux {aux_err:.2e}; bit for bit {bits} / "
          f"{train_bits}; launches {launches['cuda']}", flush=True)
    tol = FAM_SMOKE_TOL
    _need(val_err <= tol["values"] and dec_err <= tol["decode"] and
          worst <= tol["cache"] and a["drops"] == b["drops"] and bits and
          loss_err <= tol["loss"] and g_err <= tol["grad"] and
          aux_err <= tol["aux"] and train_bits,
          f"phase 17a {cfg.name}: card vs CPU beyond {tol}: {row}")
    _need(launches["cuda"]["blocked_topk"] > 0,
          f"{cfg.name}: no blocked top-k launched")
    if cfg.swa_always:
        _need(launches["cuda"]["banded_attention"] == cfg.n_layers,
              f"{cfg.name}: the banded kernel ran "
              f"{launches['cuda']['banded_attention']} times in prefill, "
              f"not once a layer")
    return row


def expert_products(cfg, n: int) -> dict:
    """The MoE's expert product at a prefill of n tokens, (E, capacity, d)
    @ (E, d, f) in bf16 with a float32 result, by `moe._f32_bmm`'s two
    routes: `torch.bmm(..., out_dtype=torch.float32)` (serving) and the
    operands widened to float32 first (training: the first has no
    backward); CUDA events, cold L2, and the largest difference."""
    from repro_torch.models import moe
    C = moe.capacity(cfg, n)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((cfg.n_experts, C, cfg.d_model), generator=g,
                    device="cuda").bfloat16()
    b = (torch.randn((cfg.n_experts, cfg.d_model, cfg.moe_d_ff),
                     generator=g, device="cuda") * 0.02).bfloat16()
    flush = torch.empty(64 * 2**20, device="cuda")
    with torch.no_grad():
        direct = moe._f32_bmm(a, b)
        ms = cuda_ms(lambda: moe._f32_bmm(a, b), 10, flush)
    b.requires_grad_(True)
    wide = moe._f32_bmm(a, b)
    out = dict(shape=[cfg.n_experts, C, cfg.d_model, cfg.moe_d_ff],
               out_dtype_ms=ms,
               widened_ms=cuda_ms(lambda: moe._f32_bmm(a, b), 10, flush),
               max_abs_diff=float((direct - wide.detach()).abs().max()))
    print(f"   expert product {tuple(out['shape'])}: bmm(out_dtype=float32) "
          f"{ms:.4f} ms (serving), widened to fp32 {out['widened_ms']:.4f} "
          f"ms (training), max |diff| {out['max_abs_diff']:.3e}", flush=True)
    return out


def moe_full(seed: int, rng, launches: dict) -> dict:
    """Phase 17b: qwen2-moe-a2.7b at full width, 24 layers, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model as build_lm
    cfg = get_config(FAM_MOE)
    model = build_lm(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"   {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB), "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    B, T = FAM_MOE_PREFILL
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    model.prefill(params, {"tokens": toks[:, :64]})                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(launches, "qwen2-moe prefill"), \
            moe.count_dropped() as drops:
        t0 = time.perf_counter()
        v, i, cache = model.prefill(params, {"tokens": toks}, top_k=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = [int(d) / int(a) for a, d in drops]
    _need(launches["qwen2-moe prefill"]["blocked_topk"] ==
          cfg.n_layers + 1, f"prefill launched the top-k kernel "
          f"{launches['qwen2-moe prefill']} times, expected "
          f"{cfg.n_layers + 1} (each router and the head)")
    _need(bool(torch.isfinite(v).all()) and v.shape == (B, 6),
          f"prefill gave {v}")
    del cache
    print(f"   prefill ({B}, {T:,}): {wall:.3f} s ({B * T / wall:,.0f} "
          f"tokens/s), peak {peak:.2f} GiB; dropped per layer "
          f"{' '.join(f'{x:.3f}' for x in share)}; top-5 "
          f"{i[0, :5].tolist()}", flush=True)
    out = dict(arch=cfg.name, params=n_params,
               prefill=dict(B=B, T=T, wall_s=wall, tokens_per_s=B * T / wall,
                            peak_gib=peak, dropped_share=share),
               expert_products=expert_products(cfg, B * T))

    # Prefill against teacher-forced decode, nothing dropped.
    nodrop = build_lm(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k))
    B, T = FAM_MOE_DECODE
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    with moe.count_dropped() as drops:
        v, i, cache_p = nodrop.prefill(params, {"tokens": toks}, top_k=6)
    _need(not any(int(d) for _, d in drops), "the prefill at capacity "
          "factor n_experts / top_k dropped an assignment")
    cache_d = nodrop.init_cache(B, T)
    torch.cuda.synchronize()
    with counted(launches, "qwen2-moe decode"):
        t0 = time.perf_counter()
        for t in range(T):
            dv, di, cache_d = nodrop.decode_step(params, cache_d,
                                                 toks[:, t:t + 1], t,
                                                 top_k=6)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
    ids = decisive_ids(v, i, dv, di)
    exact = all(torch.equal(cache_p[k][0], cache_d[k][0])
                for k in ("k", "v"))
    # Layer 0's k/v come before any expert: bit for bit. Above it a bf16
    # rounding can move a token to another expert, so every layer is held
    # to LM_CACHE only.
    errs = cache_errors(cache_p, cache_d, T, 1, LM_CACHE)
    del cache_p, cache_d
    print(f"   {T} decode steps at B = {B} (capacity factor "
          f"{nodrop.cfg.capacity_factor:g}): {dwall:.2f} s, "
          f"{1e3 * dwall / T:.2f} ms a step; top-5 decisive rows "
          f"{ids['decisive']} of {ids['rows']}, agree {ids['agree']}; k/v "
          f"rel err {errs['k']:.2e} / {errs['v']:.2e} (layers 0-2 "
          f"{errs['k_first_layers']}); layer 0 bit for bit: {exact}",
          flush=True)
    out["decode"] = dict(B=B, T=T, wall_s=dwall, ms_per_step=1e3 * dwall / T,
                         top5=ids, cache_rel_err=errs, layer0_exact=exact)
    # Phase 19 (c), while these weights are here (its own generator, so
    # this phase's draws stay as they were).
    t0 = time.perf_counter()
    ms_launches: dict = {}
    res = ms_moe(model, params, np.random.default_rng([seed, 19, 3]),
                 ms_launches)
    out["mesh_serve"] = dict(result=res, launches=ms_launches,
                             wall_s=time.perf_counter() - t0)
    with counted(launches, "qwen2-moe serve_batch"):
        out["serve"] = lm_serve(model, params, rng)
    del params
    torch.cuda.empty_cache()
    out["cli"] = lm_cli(FAM_MOE)
    out["train"] = fam_train(dataclasses.replace(
        cfg, n_layers=FAM_MOE_TRAIN["layers"]), seed, FAM_MOE_TRAIN,
        launches, "qwen2-moe train")
    return out


def fam_train(cfg, seed: int, sh: dict, launches: dict, tag: str,
              prefix: int = 0) -> dict:
    """A few `make_train_step` steps of cfg in bf16 (sh: accum, micro, T,
    steps) from weights drawn from the seed: the loss finite (and, with
    `falling`, the last below the first), s a step, tokens/s, peak."""
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import init_train_state, make_train_step
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    batches = lm_batches(cfg, seed, accum=sh["accum"], micro=sh["micro"],
                         T=sh["T"], steps=sh["steps"])
    if prefix:
        for b in batches:
            b["prefix"] = np.full((sh["accum"], sh["micro"], prefix,
                                   cfg.d_model), 0.01, np.float32)
    step = make_train_step(model, lr_fn=linear_warmup_cosine(*LM_TRAIN_LR),
                           accum=sh["accum"])
    st = init_train_state(params)
    opt, s = st.opt, st.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, secs = [], []
    with counted(launches, tag):
        for b in batches:
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, s, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            s = s + 1
            hist.append({k: float(v) for k, v in met.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    _need(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"{cfg.name}: a non-finite loss: {hist}")
    if sh.get("falling"):
        _need(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: "
              f"{losses}")
    tokens = sh["accum"] * sh["micro"] * sh["T"]
    s_step = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    plus = f" + prefix {prefix}" if prefix else ""
    print(f"   {cfg.name} at {cfg.n_layers} layers, {len(hist)} steps of "
          f"{tokens:,} tokens (accum, micro, T) = ({sh['accum']}, "
          f"{sh['micro']}, {sh['T']:,}){plus}: loss {' '.join(f'{x:.2f}' for x in losses)}; "
          f"{s_step:.3f} s a step (step 0 {secs[0]:.3f} s), "
          f"{tokens / s_step:,.0f} tokens/s, peak {peak:.2f} GiB; launches "
          f"{launches[tag]}", flush=True)
    del model, params, opt
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, **sh, prefix=prefix, history=hist,
                seconds=secs, s_per_step=s_step, tokens_per_s=tokens / s_step,
                peak_gib=peak)


def mixtral_full(seed: int, rng, launches: dict) -> dict:
    """Phase 17c: mixtral-8x22b at full width cut to FAM_MIXTRAL_LAYERS
    layers, bf16: prefill on kernel 10 and on its plain version, then
    kernel 10 alone at mixtral's heads."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels.banded_attn import ops as band_ops
    from repro_torch.kernels.banded_attn import ref as band_ref
    from repro_torch.models import moe
    from repro_torch.models.model import build_model as build_lm
    cfg = dataclasses.replace(get_config(FAM_MIXTRAL),
                              n_layers=FAM_MIXTRAL_LAYERS)
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    B, T = FAM_MIXTRAL_PREFILL
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    model.prefill(params, {"tokens": toks[:, :64]}, use_swa=True)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(launches, "mixtral prefill"), moe.count_dropped() as kdrops:
        t0 = time.perf_counter()
        v, i, cache = model.prefill(params, {"tokens": toks}, use_swa=True,
                                    top_k=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = launches["mixtral prefill"]
    _need(got["banded_attention"] == cfg.n_layers and
          got["blocked_topk"] == cfg.n_layers + 1,
          f"mixtral prefill launched {got}: expected kernel 10 once a "
          f"layer and kernel 9 once a router and once for the head")
    _need(cache["k"].shape[2] == cfg.sliding_window,
          f"the cache holds {cache['k'].shape[2]} positions, not a ring of "
          f"{cfg.sliding_window}")

    def plain(q, k, v, *, window, softcap=None, q_chunk=512):
        return band_ref.banded_attention(q, k, v, window=window,
                                         q_chunk=q_chunk, softcap=softcap)
    with mock.patch.object(band_ops, "banded_attention", plain), \
            moe.count_dropped() as pdrops:
        before = band_ops.banded_attention_cuda.launches
        t0 = time.perf_counter()
        pv, pi, pcache = model.prefill(params, {"tokens": toks},
                                       use_swa=True, top_k=6)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        _need(band_ops.banded_attention_cuda.launches == before,
              "the plain prefill launched the kernel")
    ids = decisive_ids(v, i, pv, pi)
    # Layer 0's k/v come before any attention: bit for bit. A rounding in
    # its attention moves tokens across experts, and at capacity changes
    # which assignments drop, so layer 1 is held to LM_CACHE only.
    errs = cache_errors(cache, pcache, cfg.sliding_window, 1, LM_CACHE)
    drops = {"kernel": [int(d) for _, d in kdrops],
             "plain": [int(d) for _, d in pdrops]}
    del cache, pcache, params
    torch.cuda.empty_cache()
    print(f"   {cfg.name} at {cfg.n_layers} layers ({n_params / 1e9:.2f} B "
          f"parameters): prefill ({B}, {T:,}) {wall:.3f} s on the kernel "
          f"({B * T / wall:,.0f} tokens/s), {pwall:.3f} s on the plain "
          f"version; peak {peak:.2f} GiB; top-5 {i[0, :5].tolist()} vs "
          f"{pi[0, :5].tolist()} (decisive {ids['decisive']} of "
          f"{ids['rows']}); k/v rel err {errs['k']:.2e} / {errs['v']:.2e} "
          f"(layer 1 {errs['k_first_layers'][1]:.2e}); dropped assignments "
          f"by layer {drops}; launches {got}", flush=True)
    flush = torch.empty(64 * 2**20, device="cuda")
    kernel = check_banded(cfg, torch.Generator(device="cuda")
                          .manual_seed(seed), flush,
                          cases=((1, T, "bfloat16"),))
    del flush
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
                prefill=dict(B=B, T=T, wall_s=wall, plain_wall_s=pwall,
                             tokens_per_s=B * T / wall, peak_gib=peak,
                             top5=ids, cache_rel_err=errs, dropped=drops),
                kernel=kernel)


def xlstm_full(seed: int, rng, launches: dict) -> dict:
    """Phase 17d: xlstm-125m whole (12 layers), bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    cfg = get_config(FAM_XLSTM)
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    B, T = FAM_XLSTM_PREFILL
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    model.prefill(params, {"tokens": toks[:, :300]})               # warm
    torch.cuda.synchronize()
    with counted(launches, "xlstm prefill"):
        t0 = time.perf_counter()
        v, i, _ = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _need(bool(torch.isfinite(v).all()), f"xlstm prefill gave {v}")
    B, T = FAM_XLSTM_DECODE
    toks = toks[:, :T]
    v, i, cache_p = model.prefill(params, {"tokens": toks}, top_k=6)
    cache_d = model.init_cache(B, T)
    torch.cuda.synchronize()
    with counted(launches, "xlstm decode"):
        t0 = time.perf_counter()
        for t in range(T):
            dv, di, cache_d = model.decode_step(params, cache_d,
                                                toks[:, t:t + 1], t, top_k=6)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
    ids = decisive_ids(v, i, dv, di)
    rel = cache_rel(cache_p, cache_d)
    n_tok = FAM_XLSTM_PREFILL[0] * FAM_XLSTM_PREFILL[1]
    print(f"   {cfg.name} ({n_params / 1e6:.1f} M parameters): prefill "
          f"{FAM_XLSTM_PREFILL} {wall:.3f} s ({n_tok / wall:,.0f} "
          f"tokens/s); prefill {FAM_XLSTM_DECODE} against {T:,} decode "
          f"steps ({dwall:.2f} s, {1e3 * dwall / T:.2f} ms a step): top-5 "
          f"decisive {ids['decisive']} of {ids['rows']}, states rel err "
          f"max {max(rel.values()):.2e} ({rel})", flush=True)
    _need(max(rel.values()) <= LM_CACHE, f"xlstm states of prefill and "
          f"decode differ beyond {LM_CACHE}: {rel}")
    del params, cache_p, cache_d
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n_params,
                prefill=dict(B=FAM_XLSTM_PREFILL[0], T=FAM_XLSTM_PREFILL[1],
                             wall_s=wall, tokens_per_s=n_tok / wall),
                decode=dict(B=B, T=T, wall_s=dwall,
                            ms_per_step=1e3 * dwall / T, top5=ids,
                            state_rel_err=rel),
                train=fam_train(cfg, seed, FAM_XLSTM_TRAIN, launches,
                                "xlstm train"))


def internvl_full(seed: int, rng, launches: dict) -> dict:
    """Phase 17e: internvl2-26b at full width (48 layers), bf16, its 256
    patch embeddings as a prefix."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    cfg = get_config(FAM_VLM)
    model = build_lm(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"   {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB), "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    P, T = cfg.n_prefix, FAM_VLM_TOKENS
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(1, P + T))) \
        .cuda()
    model.prefill(params, {"tokens": toks[:, :64]})                # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefix = params.embed[toks[:, :P]]                # (1, 256, 6,144)
    with counted(launches, "internvl2 prefill"):
        t0 = time.perf_counter()
        v, i, cache = model.prefill(params, {"tokens": toks[:, P:],
                                             "prefix": prefix})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    v2, i2, cache2 = model.prefill(params, {"tokens": toks})
    same = (torch.equal(v, v2) and torch.equal(i, i2) and
            caches_equal(cache, cache2))
    print(f"   prefill of a ({1}, {P}, {cfg.d_model:,}) prefix and {T:,} "
          f"tokens: {wall:.3f} s ({(P + T) / wall:,.0f} positions/s), peak "
          f"{peak:.2f} GiB; top-5 {i[0].tolist()}; == prefill of the {P + T:,}"
          f" tokens, bit for bit: {same}", flush=True)
    _need(same, "prefill(tokens, prefix=embed[p]) differs from "
          "prefill(concat(p, tokens))")
    _need(launches["internvl2 prefill"]["blocked_topk"] == 1,
          f"internvl2 prefill launched {launches['internvl2 prefill']}")
    del params, cache, cache2, prefix
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n_params,
                prefill=dict(prefix=P, T=T, wall_s=wall, peak_gib=peak,
                             positions_per_s=(P + T) / wall,
                             prefix_identity_bit_for_bit=same),
                train=fam_train(dataclasses.replace(
                    cfg, n_layers=FAM_VLM_TRAIN["layers"]), seed,
                    FAM_VLM_TRAIN, launches, "internvl2 train", prefix=P))


def families(seed: int) -> dict:
    """Phase 17: (a) the four smoke configs, then (b)-(e) at full width."""
    rng = np.random.default_rng([seed, 17])
    launches: dict = {}
    out, walls = {}, {}
    for part, run in (
            ("smoke", lambda: [fam_smoke_one(a, seed) for a in FAM_ARCHS]),
            ("qwen2_moe", lambda: moe_full(seed, rng, launches)),
            ("mixtral", lambda: mixtral_full(seed, rng, launches)),
            ("xlstm", lambda: xlstm_full(seed, rng, launches)),
            ("internvl2", lambda: internvl_full(seed, rng, launches))):
        t0 = time.perf_counter()
        out[part] = run()
        walls[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["wall_s"] = walls
    print("   (a)-(e) took " + ", ".join(f"{v:.1f}" for v in walls.values())
          + " s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the encoder-decoder and LM training over a mesh (ROADMAP A-8e)
# ---------------------------------------------------------------------------

def grid(shape: tuple, device: str = "cuda:0"):
    """A mesh of `shape` whose every cell is `device`."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*shape, devices=[device] * (shape[0] * shape[1]))


def mesh_step_smoke(arch: str, seed: int) -> dict:
    """Phase 18 (a): the mesh step of a smoke config on the card's grid
    against the CPU's, and twice on the card."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)
    cfg = get_config(arch, smoke=True)
    models = {"cpu": build_lm(cfg, device="cpu"), "cuda": build_lm(cfg)}
    p0 = models["cpu"].init(torch.Generator().manual_seed(seed))
    sh = ED_MESH_SHAPE
    tb = lm_batches(cfg, seed, accum=sh["accum"], micro=sh["micro"],
                    T=sh["T"], steps=1)[0]
    if cfg.n_prefix:
        tb["prefix"] = train_prefix(cfg, (sh["accum"], sh["micro"]), seed)
    lr_fn = linear_warmup_cosine(*LM_TRAIN_LR)

    def run(dev):
        m, mesh = models[dev], grid(ED_MESH, "cpu" if dev == "cpu" else
                                    "cuda:0")
        p = copy.deepcopy(p0).to(dev)
        with torch.no_grad(), moe.count_dropped() as d:
            m.train_loss(p, {k: v[0] for k, v in tb.items()}, mesh=mesh,
                         batch_axes=ED_AXES)
        loss, _, grads = loss_and_grads(m, p, tb, sh["accum"], mesh=mesh,
                                        batch_axes=ED_AXES)
        step = make_train_step(m, lr_fn=lr_fn, mesh=mesh,
                               batch_axes=ED_AXES, accum=sh["accum"])
        st = init_train_state(p)
        p, _, met = step(p, st.opt, st.step, tb)
        return dict(loss=float(loss), grads=grads, drops=[int(x) for _, x
                                                          in d],
                    params=[t.detach().cpu() for t in p.parameters()],
                    step_loss=float(met["loss"]))
    cpu, a, b = run("cpu"), run("cuda"), run("cuda")
    loss_err = abs(a["loss"] - cpu["loss"]) / abs(cpu["loss"])
    g_err = grad_error(a["grads"], cpu["grads"])
    bits = a["step_loss"] == b["step_loss"] and all(
        torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    row = dict(arch=cfg.name, mesh=ED_MESH, loss=a["loss"],
               cpu_loss=cpu["loss"], loss_rel_err=loss_err, grad_err=g_err,
               drops=a["drops"], cpu_drops=cpu["drops"], bit_for_bit=bits)
    print(f"   {cfg.name} on {ED_MESH} cuda:0 cells: loss {a['loss']:.5f} "
          f"(CPU grid {cpu['loss']:.5f}, rel {loss_err:.2e}), gradients "
          f"{g_err:.2e} of their magnitude; drops by shard and layer "
          f"{a['drops']} (CPU {cpu['drops']}); two card steps bit for bit: "
          f"{bits}", flush=True)
    _need(loss_err <= FAM_SMOKE_TOL["loss"] and
          g_err <= FAM_SMOKE_TOL["grad"] and a["drops"] == cpu["drops"] and
          bits, f"phase 18a mesh step {cfg.name}: {row}")
    return row


def ed_full(seed: int, rng, launches: dict) -> dict:
    """Phase 18 (b): seamless-m4t-medium whole, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    cfg = get_config(ED_ARCH)
    model = build_lm(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"   {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB), "
          f"{len(params.enc_blocks)} + {len(params.dec_blocks)} layers, "
          f"vocabulary {cfg.vocab:,} padded to {cfg.padded_vocab():,}; "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    P = cfg.n_prefix

    def frames(B):
        return torch.randn((B, P, cfg.d_model), generator=gen,
                           device="cuda") * 0.05
    B, T = ED_PREFILL
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    batch = {"tokens": toks, "prefix": frames(B)}
    model.prefill(params, {"tokens": toks[:, :64], "prefix": batch["prefix"]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(launches, "seamless prefill"):
        t0 = time.perf_counter()
        v, i, cache = model.prefill(params, batch, top_k=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    _need(launches["seamless prefill"]["blocked_topk"] == 1 and
          bool(torch.isfinite(v).all()) and v.shape == (B, 6) and
          tuple(cache["mem_k"].shape) == (cfg.n_layers, B, P,
                                          cfg.n_kv_heads, cfg.head_dim),
          f"prefill: {v}, launches {launches['seamless prefill']}")
    del cache
    print(f"   prefill of {P:,} frames and ({B}, {T:,}) tokens: {wall:.3f} "
          f"s ({B * T / wall:,.0f} tokens/s), peak {peak:.2f} GiB; top-5 "
          f"{i[0, :5].tolist()}", flush=True)
    out = dict(arch=cfg.name, params=n_params,
               prefill=dict(B=B, T=T, frames=P, wall_s=wall,
                            tokens_per_s=B * T / wall, peak_gib=peak))

    # Prefill against teacher-forced decode from an empty cache that holds
    # the prefill's memory k/v.
    B, T = ED_DECODE
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    batch = {"tokens": toks, "prefix": frames(B)}
    v, i, cache_p = model.prefill(params, batch, top_k=6)
    cache_d = model.init_cache(B, T)
    cache_d["mem_k"].copy_(cache_p["mem_k"])
    cache_d["mem_v"].copy_(cache_p["mem_v"])
    torch.cuda.synchronize()
    with counted(launches, "seamless decode"):
        t0 = time.perf_counter()
        for t in range(T):
            dv, di, cache_d = model.decode_step(params, cache_d,
                                                toks[:, t:t + 1], t, top_k=6)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
    _need(launches["seamless decode"]["blocked_topk"] == T,
          f"{T} decode steps launched kernel 9 "
          f"{launches['seamless decode']['blocked_topk']} times")
    ids = decisive_ids(v, i, dv, di)
    errs = cache_errors(cache_p, cache_d, T, 1, LM_CACHE)
    del cache_p, cache_d, params
    torch.cuda.empty_cache()
    print(f"   {T} decode steps at B = {B} against prefill: {dwall:.2f} s, "
          f"{1e3 * dwall / T:.2f} ms a step; top-5 decisive rows "
          f"{ids['decisive']} of {ids['rows']}, agree {ids['agree']}; self "
          f"k/v rel err {errs['k']:.2e} / {errs['v']:.2e} (layers 0-2 "
          f"{errs['k_first_layers']}); layer 0 bit for bit", flush=True)
    out["decode"] = dict(B=B, T=T, wall_s=dwall, ms_per_step=1e3 * dwall / T,
                         top5=ids, cache_rel_err=errs)
    return out


def ed_train(seed: int, launches: dict) -> dict:
    """Phase 18 (c): seamless training at full width in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config(ED_ARCH)
    L = cfg.n_layers
    with counted(launches, "seamless train"):
        return bf16_training(cfg, seed, ED_TRAIN, groups={
            "embed": "embed", "head": "head", "enc block 0": "enc_blocks.0",
            f"dec block {L - 1}": f"dec_blocks.{L - 1}"},
            last=f"dec block {L - 1}")


def ed_mesh_full(seed: int, launches: dict) -> dict:
    """Phase 18 (d): the mesh at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model as build_lm
    from repro_torch.train.trainer import loss_and_grads
    rng = np.random.default_rng([seed, 18, 4])
    cfg = dataclasses.replace(get_config(ED_ARCH), dtype="float32")
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    B, T = ED_MESH_FULL["B"], ED_MESH_FULL["T"]
    batch = {k: v[0] for k, v in lm_batches(cfg, seed, accum=1, micro=B,
                                            T=T, steps=1)[0].items()}
    batch["prefix"] = (0.05 * rng.normal(size=(B, cfg.n_prefix,
                                               cfg.d_model))
                       ).astype(np.float32)
    mesh = grid(ED_MESH)
    with counted(launches, "seamless mesh"):
        l1, _, g1 = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l2, _, g2 = loss_and_grads(model, params, batch, mesh=mesh,
                                   batch_axes=ED_AXES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g_err = grad_error(g2, g1)
        del g1
        l3, _, g3 = loss_and_grads(model, params, batch, mesh=mesh,
                                   batch_axes=ED_AXES)
    bits = torch.equal(l2, l3) and all(torch.equal(g2[n], g3[n])
                                       for n in g2)
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    del g2, g3, params, model
    torch.cuda.empty_cache()
    print(f"   {cfg.name} fp32, (B, T) = ({B}, {T:,}) + {cfg.n_prefix:,} "
          f"frames on {ED_MESH} cuda:0 cells against one device: loss "
          f"{float(l2):.4f} vs {float(l1):.4f} (rel {loss_err:.2e}), "
          f"gradients {g_err:.2e} of their magnitude; the mesh step "
          f"{wall:.2f} s; twice bit for bit: {bits}", flush=True)
    _need(loss_err <= ED_MESH_TOL["loss"] and g_err <= ED_MESH_TOL["grad"]
          and bits, f"phase 18d: loss {loss_err:.2e}, gradients "
          f"{g_err:.2e}, bit for bit {bits}")
    out = dict(seamless=dict(B=B, T=T, mesh=ED_MESH, loss=float(l2),
                             one_device_loss=float(l1), loss_rel_err=loss_err,
                             grad_err=g_err, wall_s=wall, bit_for_bit=bits))

    mm = ED_MOE_MESH
    cfg = dataclasses.replace(get_config(mm["arch"]), n_layers=mm["layers"])
    model = build_lm(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    batch = {k: v[0] for k, v in lm_batches(cfg, seed, accum=1,
                                            micro=mm["B"], T=mm["T"],
                                            steps=1)[0].items()}
    mesh = grid(mm["mesh"])
    from repro_torch.models.sharding import row_shards
    shards = row_shards(mesh, mm["B"], ED_AXES)
    with torch.no_grad(), counted(launches, "qwen2-moe mesh"):
        with moe.count_dropped() as d:
            t0 = time.perf_counter()
            loss, met = model.train_loss(params, batch, mesh=mesh,
                                         batch_axes=ED_AXES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_mesh = np.array([int(x) for _, x in d]).reshape(len(shards),
                                                           cfg.n_layers)
        alone = []
        for s in shards:
            with moe.count_dropped() as d:
                model.train_loss(params, {k: v[s.rows]
                                          for k, v in batch.items()})
            alone.append([int(x) for _, x in d])
        with moe.count_dropped() as d:
            whole, _ = model.train_loss(params, batch)
        unsharded = [int(x) for _, x in d]
    n_tok = mm["B"] * mm["T"] // len(shards)
    print(f"   {cfg.name} at {cfg.n_layers} layers, (B, T) = ({mm['B']}, "
          f"{mm['T']:,}) on {mm['mesh']} cuda:0 cells: loss "
          f"{float(loss):.4f} (aux {float(met['aux']):.4f}; one device "
          f"{float(whole):.4f}) in {wall:.2f} s; dropped by shard and layer "
          f"{on_mesh.tolist()} of {n_tok * cfg.moe_top_k:,} assignments, "
          f"each shard alone {alone}, unsharded {unsharded}", flush=True)
    _need(bool(torch.isfinite(loss)) and on_mesh.tolist() == alone,
          f"phase 18d {cfg.name}: loss {float(loss)}, drops {on_mesh} "
          f"against {alone}")
    del params, model
    torch.cuda.empty_cache()
    out["moe"] = dict(arch=cfg.name, n_layers=cfg.n_layers, B=mm["B"],
                      T=mm["T"], mesh=mm["mesh"], loss=float(loss),
                      aux=float(met["aux"]), wall_s=wall,
                      dropped=on_mesh.tolist(), alone=alone,
                      unsharded=unsharded)
    return out


def encdec_mesh(seed: int, build_dir: Path,
                clis: dict | None = None) -> dict:
    """Phase 18: (a)-(e), with every kernel's launch count set to 0 just
    before and read just after: kernel 9 only (seamless's and the MoE
    routers' top-k), as the parts' counts say. `clis`
    (`start_train_clis`): (e)'s CLIs, started before; without them (e)
    starts its own."""
    if clis is None:
        clis = start_train_clis(build_dir)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rng = np.random.default_rng([seed, 18])
    launches: dict = {}
    out, walls = {}, {}
    for part, run in (
            ("smoke", lambda: dict(
                seamless=fam_smoke_one(ED_ARCH, seed),
                mesh=[mesh_step_smoke(a, seed) for a in ED_MESH_ARCHS])),
            ("seamless", lambda: ed_full(seed, rng, launches)),
            ("train", lambda: ed_train(seed, launches)),
            ("mesh", lambda: ed_mesh_full(seed, launches)),
            ("cli", lambda: dict(seamless=lm_train_cli(clis["seamless"]),
                                 mesh=lm_train_cli(clis["mesh"])))):
        t0 = time.perf_counter()
        out[part] = run()
        walls[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    others = {k: fn.launches for k, fn in counters.items()
              if k not in ("blocked_topk", "banded_attention")}
    out["launches"] = launches
    out["wall_s"] = walls
    print("   (a)-(e) took " + ", ".join(f"{v:.1f}" for v in walls.values())
          + f" s; kernel launches by part {launches}; kernels 1-8 {others}",
          flush=True)
    _need(not any(others.values()) and
          not any(v["banded_attention"] for v in launches.values()),
          f"phase 18 launched a kernel off its path: {others}, {launches}")
    _need(launches["seamless train"]["blocked_topk"] == 0,
          "seamless training launched the top-k kernel")
    return out


# ---------------------------------------------------------------------------
# Phase 19: LM serving over a mesh (ROADMAP A-8f)
# ---------------------------------------------------------------------------

def ms_smoke_one(arch: str, seed: int) -> dict:
    """Phase 19 (a) for one smoke config: the MS_GRID grid of cuda:0
    against the port's grid of the CPU, and twice on the card."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import moe, sharding
    from repro_torch.models.model import build_model as build_lm
    cfg = get_config(arch, smoke=True)
    models = {"cpu": build_lm(cfg, device="cpu"), "cuda": build_lm(cfg)}
    p0 = models["cpu"].init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng([seed, 19])
    B, T = MS_SMOKE["B"], MS_SMOKE["T"]
    batch = {"tokens": rng.integers(2, cfg.vocab, size=(B, T))}
    if cfg.n_prefix:
        batch["prefix"] = (0.05 * rng.normal(
            size=(B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    dec = rng.integers(2, cfg.vocab, size=(B, MS_SMOKE["decode"]))
    T_all = T + cfg.n_prefix
    launches: dict = {}

    def run(dev, tag):
        m, mesh = models[dev], grid(MS_GRID, "cpu" if dev == "cpu" else
                                    "cuda:0")
        p = copy.deepcopy(p0).to(dev)
        kw = dict(mesh=mesh, batch_axes=MS_AXES, use_swa=cfg.swa_always,
                  top_k=6)
        with counted(launches, tag), moe.count_dropped() as drops:
            v, i, cache = m.prefill(p, batch, **kw)
            pre = sharding.gather_cache(cache, "cpu")
            steps = []
            for t in range(MS_SMOKE["decode"]):
                dv, di, cache = m.decode_step(p, cache, dec[:, t:t + 1],
                                              T_all + t, **kw)
                steps.append((dv.cpu(), di.cpu()))
        n_pre = len(sharding.row_shards(mesh, B, MS_AXES)) * cfg.n_layers \
            if cfg.family == "moe" else 0
        return dict(v=v.cpu(), i=i.cpu(), cache=pre, steps=steps,
                    end=sharding.gather_cache(cache, "cpu"),
                    drops=[int(d) for _, d in drops[:n_pre]])
    b, a, again = run("cpu", "cpu"), run("cuda", "cuda"), \
        run("cuda", "cuda again")
    bits = (torch.equal(a["v"], again["v"]) and
            torch.equal(a["i"], again["i"]) and
            caches_equal(a["cache"], again["cache"]) and
            caches_equal(a["end"], again["end"]) and
            a["drops"] == again["drops"] and
            all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                for x, y in zip(a["steps"], again["steps"])))
    ids = decisive_ids(a["v"], a["i"], b["v"], b["i"])
    val_err = float((a["v"] - b["v"]).abs().max())
    dec_err = max(float((x[0] - y[0]).abs().max())
                  for x, y in zip(a["steps"], b["steps"]))
    for (av, ai), (bv, bi) in zip(a["steps"], b["steps"]):
        decisive_ids(av, ai, bv, bi)
    rel = {"prefill": cache_rel(a["cache"], b["cache"]),
           "decode": cache_rel(a["end"], b["end"])}
    worst = max(max(r.values()) for r in rel.values())
    row = dict(arch=cfg.name, B=B, T=T_all, mesh=MS_GRID, prefill_ids=ids,
               prefill_val_err=val_err, decode_val_err=dec_err,
               cache_rel=rel, drops=a["drops"], cpu_drops=b["drops"],
               bit_for_bit=bits, launches=launches["cuda"])
    print(f"   {cfg.name} on {MS_GRID} cuda:0 cells (B, T) = ({B}, {T_all}):"
          f" top-5 {a['i'][0, :5].tolist()}, values {val_err:.2e} from the "
          f"CPU grid's, decode {dec_err:.2e}; caches/states {worst:.2e}; "
          f"drops by shard and layer {a['drops']} (CPU {b['drops']}); bit "
          f"for bit {bits}; launches {launches['cuda']}", flush=True)
    tol = FAM_SMOKE_TOL
    _need(val_err <= tol["values"] and dec_err <= tol["decode"] and
          worst <= tol["cache"] and a["drops"] == b["drops"] and bits,
          f"phase 19a {cfg.name}: card grid vs CPU grid beyond {tol}: {row}")
    _need(launches["cuda"]["blocked_topk"] > 0,
          f"{cfg.name}: no blocked top-k launched")
    return row


def pad_cache(cache: dict, n: int) -> dict:
    """A copy of a full-length k/v cache with n more (zero) slots, so
    decode continues past the prefill without wrapping to slot 0."""
    return {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
            if k in ("k", "v") else type(t)(*(x.clone() for x in t))
            for k, t in cache.items()}


def ms_hymba(model, params, rng, launches: dict) -> dict:
    """Phase 19 (b): hymba-1.5b whole on the MS_GRID grid of cuda:0."""
    from repro_torch.models import sharding
    from repro_torch.models.transformer import layer_windows_static
    cfg = model.cfg
    B, T = MS_HYMBA
    mesh = grid(MS_GRID)
    M = mesh.shape["model"]
    windowed = sum(1 for w in layer_windows_static(cfg, use_swa=True)
                   if 0 < w < T)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, T))).cuda()
    dec = torch.from_numpy(rng.integers(2, cfg.vocab,
                                        size=(B, MS_DECODE))).cuda()
    kw = dict(mesh=mesh, batch_axes=MS_AXES, use_swa=True, top_k=6)
    model.prefill(params, {"tokens": toks[:, :64]}, **kw)    # the placement
    torch.cuda.synchronize()
    with counted(launches, "hymba mesh prefill"):
        t0 = time.perf_counter()
        v, i, mc = model.prefill(params, {"tokens": toks}, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = launches["hymba mesh prefill"]
    shards = sharding.row_shards(mesh, B, MS_AXES)
    _need(n["banded_attention"] == len(shards) * windowed and
          n["blocked_topk"] == M + 1,
          f"the mesh prefill launched {n}: expected kernel 10 "
          f"{len(shards)} x {windowed} times and kernel 9 {M + 1}")
    # Each row shard against its rows alone on one device: the same
    # operations at the same shapes, so its caches are equal bit for bit
    # (the head's product runs on all the rows at once).
    alone = [model.prefill(params, {"tokens": toks[s.rows]}, use_swa=True,
                           top_k=6) for s in shards]
    exact = all(caches_equal(c, a[2]) for c, a in zip(mc.shards, alone))
    _need(exact, "a row shard's caches differ from its rows prefilled "
          "alone on one device")
    top = [decisive_ids(v[s.rows], i[s.rows], a[0], a[1])
           for s, a in zip(shards, alone)]
    print(f"   prefill ({B}, {T:,}) on {MS_GRID} cuda:0 cells: {wall:.3f} s"
          f" ({B * T / wall:,.0f} tokens/s); launches {n}; each row shard's "
          f"caches bit for bit its rows alone: {exact}; top-5 against its "
          f"rows alone: decisive rows {sum(t['decisive'] for t in top)} of "
          f"{B}, max value diff {max(t['max_val_diff'] for t in top):.2e}",
          flush=True)
    mc = sharding.MeshCache(mc.rows, [pad_cache(c, MS_DECODE)
                                      for c in mc.shards])
    caches = [pad_cache(a[2], MS_DECODE) for a in alone]
    del alone
    torch.cuda.synchronize()
    with counted(launches, "hymba mesh decode"):
        t0 = time.perf_counter()
        steps = []
        for t in range(MS_DECODE):
            dv, di, mc = model.decode_step(params, mc, dec[:, t:t + 1],
                                           T + t, **kw)
            steps.append((dv, di))
        torch.cuda.synchronize()
        mesh_wall = time.perf_counter() - t0
    _need(launches["hymba mesh decode"] == {
        "blocked_topk": MS_DECODE * (M + 1), "banded_attention": 0},
        f"{MS_DECODE} mesh decode steps launched "
        f"{launches['hymba mesh decode']}")
    dtop = []                       # every step of every row shard
    for s, c in zip(shards, caches):
        for t, (sv, si) in enumerate(steps):
            av, ai, c = model.decode_step(params, c, dec[s.rows, t:t + 1],
                                          T + t, use_swa=True, top_k=6)
            dtop.append(decisive_ids(sv[s.rows], si[s.rows], av, ai))
    dexact = all(caches_equal(c, a) for c, a in zip(mc.shards, caches))
    _need(dexact, "a row shard's caches after the decode steps differ "
          "from its rows decoded alone on one device")
    del caches
    # One device on the whole batch, for the time a step.
    _, _, c1 = model.prefill(params, {"tokens": toks}, use_swa=True)
    c1 = pad_cache(c1, MS_DECODE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(MS_DECODE):
        ov, oi, c1 = model.decode_step(params, c1, dec[:, t:t + 1], T + t,
                                       use_swa=True, top_k=6)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    agree = int((oi[:, :5].sort(dim=1).values.cpu() ==
                 di[:, :5].sort(dim=1).values.cpu()).all(dim=1).sum())
    del mc, c1
    torch.cuda.empty_cache()
    print(f"   {MS_DECODE} decode steps from the mesh cache: "
          f"{1e3 * mesh_wall / MS_DECODE:.2f} ms a step (one device on "
          f"the whole batch {1e3 * one_wall / MS_DECODE:.2f}); each shard's "
          f"caches bit for bit its rows decoded alone: {dexact}; top-5 "
          f"against the rows alone: decisive rows "
          f"{sum(t['decisive'] for t in dtop)} of {B * MS_DECODE} (every "
          f"step); at the last step against the whole batch on one device:"
          f" {agree} of {B} rows the same five", flush=True)
    return dict(arch=cfg.name, mesh=MS_GRID, B=B, T=T,
                prefill=dict(wall_s=wall, tokens_per_s=B * T / wall,
                             launches=n, shards_exact=exact, top5=top),
                decode=dict(steps=MS_DECODE,
                            ms_per_step=1e3 * mesh_wall / MS_DECODE,
                            one_device_ms_per_step=1e3 * one_wall /
                            MS_DECODE, shards_exact=dexact,
                            top5_decisive=sum(t["decisive"] for t in dtop),
                            top5_rows=len(dtop), one_device_agree=agree))


def ms_moe(model, params, rng, launches: dict) -> dict:
    """Phase 19 (c), run in phase 17b: qwen2-moe-a2.7b whole on MS_MOE's
    grid of cuda:0."""
    from repro_torch.models import moe, sharding
    from repro_torch.serve.engine import generate
    cfg = model.cfg
    mm = MS_MOE
    mesh = grid(mm["mesh"])
    toks = torch.from_numpy(rng.integers(2, cfg.vocab,
                                         size=(mm["B"], mm["T"]))).cuda()
    kw = dict(mesh=mesh, batch_axes=MS_AXES)
    shards = sharding.row_shards(mesh, mm["B"], MS_AXES)
    torch.cuda.synchronize()
    with counted(launches, "qwen2-moe mesh prefill"), \
            moe.count_dropped() as d:
        t0 = time.perf_counter()
        v, i, mc = model.prefill(params, {"tokens": toks}, top_k=6, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_mesh = np.array([int(x) for _, x in d]).reshape(len(shards),
                                                       cfg.n_layers)
    n = launches["qwen2-moe mesh prefill"]
    _need(n["blocked_topk"] == len(shards) * cfg.n_layers +
          mesh.shape["model"] + 1,
          f"the mesh prefill launched kernel 9 {n} times")
    del mc
    alone, top = [], []
    for s in shards:
        with moe.count_dropped() as d:
            va, ia, _ = model.prefill(params, {"tokens": toks[s.rows]},
                                      top_k=6)
        alone.append([int(x) for _, x in d])
        top.append(decisive_ids(v[s.rows], i[s.rows], va, ia))
    _need(on_mesh.tolist() == alone, f"drops by shard and layer "
          f"{on_mesh.tolist()} against each row alone {alone}")
    prompt = rng.integers(2, cfg.vocab, size=(mm["B"], mm["prompt"]))
    with counted(launches, "qwen2-moe mesh generate"):
        t0 = time.perf_counter()
        g = generate(model, params, prompt, steps=mm["generate"], **kw)
        gwall = time.perf_counter() - t0
    g1 = generate(model, params, prompt, steps=mm["generate"])
    steps = mm["prompt"] + mm["generate"] - 1
    _need(g.shape == (mm["B"], mm["generate"]) and 0 <= g.min() and
          g.max() < cfg.padded_vocab() and
          launches["qwen2-moe mesh generate"]["blocked_topk"] ==
          steps * (len(shards) * cfg.n_layers + mesh.shape["model"] + 1),
          f"generate(mesh=) gave {g.tolist()}, launches "
          f"{launches['qwen2-moe mesh generate']}")
    agree = float((g == g1).mean())
    n_tok = mm["B"] * mm["T"]
    print(f"   mesh serving on {mm['mesh']} cuda:0 cells: prefill ({mm['B']},"
          f" {mm['T']:,}) {wall:.3f} s ({n_tok / wall:,.0f} tokens/s), "
          f"dropped by shard and layer {on_mesh.tolist()} of "
          f"{n_tok // len(shards) * cfg.moe_top_k:,} assignments = each row "
          f"alone; top-5 against each row alone: decisive "
          f"{[t['decisive'] for t in top]} of {[t['rows'] for t in top]}; "
          f"generate(mesh=) {mm['generate']} tokens in {gwall:.2f} s, "
          f"{agree:.3f} of them one device's; req[0] -> {g[0].tolist()}",
          flush=True)
    return dict(mesh=mm["mesh"], B=mm["B"], T=mm["T"], wall_s=wall,
                tokens_per_s=n_tok / wall, dropped=on_mesh.tolist(),
                alone=alone, top5=top, generate=dict(
                    steps=mm["generate"], wall_s=gwall, ids=g.tolist(),
                    one_device_agree=agree))


def mesh_serving(seed: int, model, params, moe_part: dict) -> dict:
    """Phase 19: (a) and (b), with every kernel's launch count set to 0
    just before and read just after (kernels 9 and 10 by part), and (c)
    from phase 17b (`moe_part`: its result, launches and wall)."""
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rng = np.random.default_rng([seed, 19])
    launches: dict = {}
    out, walls = {}, {}
    for part, run in (
            ("smoke", lambda: [ms_smoke_one(a, seed)
                               for a in MS_SMOKE_ARCHS]),
            ("hymba", lambda: ms_hymba(model, params, rng, launches))):
        t0 = time.perf_counter()
        out[part] = run()
        walls[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    others = {k: fn.launches for k, fn in counters.items()
              if k not in ("blocked_topk", "banded_attention")}
    out["qwen2_moe"] = moe_part["result"]
    launches.update(moe_part["launches"])
    launches.update({f"smoke {r['arch']}": r["launches"]
                     for r in out["smoke"]})
    out["launches"] = launches
    out["wall_s"] = {**walls, "qwen2_moe": moe_part["wall_s"]}
    print("   (a), (b) took " + ", ".join(f"{v:.1f}" for v in walls.values())
          + f" s ((c) {moe_part['wall_s']:.1f} s in phase 17b); kernel "
          f"launches by part {launches}; kernels 1-8 {others}", flush=True)
    _need(not any(others.values()),
          f"phase 19 launched a kernel off its path: {others}")
    return out


def train_data(seed: int):
    """Phases 5-10b's training data: Wiki10-31K's N and D."""
    from repro_torch.data.xmc import make_xmc_dataset
    data = make_xmc_dataset(n_train=TRAIN_N, n_test=TEST_N,
                            n_features=N_FEATURES, n_labels=TRAIN_LABELS,
                            beta=TRAIN_BETA, seed=seed,
                            name="wiki10_31k_width")
    st = data.stats()
    print(f"   X_train {data.X_train.shape} "
          f"({data.X_train.nbytes / 1e9:.2f} GB fp32), feature "
          f"density {st['feat_density']:.2e}, labels per row "
          f"{st['ALpP']:.2f}, rows per label {st['APpL']:.2f}, tail "
          f"labels (<= 5 rows) {st['tail_leq5']:.3f}", flush=True)
    return data


def planted_faults(seed: int, build_dir: Path, smi: str) -> None:
    """`--planted-faults`: phase 8's fit, then phase 10b's (2, 1)
    `shard_data` fit under each of PLANTED_FAULTS against it, with the
    served ids' margin at FAULT_MARGIN (phase 3, which sets the main
    run's, does not run here)."""
    with phase("train data: Wiki10-31K width"):
        data = train_data(seed)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ref = os.path.join(root, "ref")
        with phase("train: fit(X, Y, spec, dir) on the card"), \
                tron_counters() as calls:
            train(data, ref, None)
        with phase("planted faults: (2, 1) shard_data"):
            out = train_meshes(data, ref, calls, FAULT_MARGIN, root, seed,
                               faults=True)
    print(json.dumps({"planted_faults": out}))
    print(smi)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planted-faults", action="store_true",
                    help="run only phase 8's fit and phase 10b's (2, 1) "
                    "shard_data fit under each planted fault, and report "
                    "the checks each fails")
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

    # The nvcc processes run beside the model's making (host numpy): the
    # kernels are first needed in phase 3.
    nvcc = in_background(_build.build, "nvcc")

    def built():
        with phase("build: the kernels (nvcc beside the model's making)"):
            nvcc.result()
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

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    if args.planted_faults:
        built()
        planted_faults(args.seed, build_dir, smi)
        return
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(N_FEATURES)
    # The serving checkpoint stays until the server phase: saving it again
    # would take another 80 s.
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        with phase("model: Wiki10-31K width, packed batch by batch"):
            t0 = time.perf_counter()
            model = build_model(rng)
            t_gen = time.perf_counter() - t0
            print(f"   {model.n_blocks} blocks ({model.density:.4f} of the "
                  f"grid), {4 * model.blocks.numel() / 1e6:.1f} MB fp32; "
                  f"padded shape {model.shape}; made and packed in "
                  f"{t_gen:.1f} s; saving on a thread beside phase 3")
            # The compressed write keeps one core busy for ~70 s and reads
            # the model only: it runs beside phase 3, which does not read
            # the checkpoint (its kernel and library times are the same
            # alone: `tools/chip_smoke_parts.py phase3-beside-save`).

            def save():
                t = time.perf_counter()
                save_block_sparse(model, ckpt, meta={
                    "n_labels": N_LABELS, "n_features": N_FEATURES,
                    "seed": args.seed, "xmc_spec": XMCSpec().to_dict()})
                return time.perf_counter() - t
            saver = in_background(save, "save_block_sparse")
        built()

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
            int8_designs = check_int8_designs(gpu_model, X, flush)
            del gpu_model, scores, x, flush
            torch.cuda.empty_cache()
            smi_run = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                 "temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            print(f"   after timing: clocks.sm, power.draw, temperature: "
                  f"{smi_run}")

        # Phases 5-10b's training data (host numpy) is made beside the
        # rest of the save; both end before phase 4's timed requests.
        data_job = in_background(lambda: train_data(args.seed), "train data")
        with phase("model saved; train data: Wiki10-31K width, beside it"):
            t0 = time.perf_counter()
            save_s = saver.result()
            print(f"   saved in {save_s:.1f} s, "
                  f"{time.perf_counter() - t0:.1f} s of it after phase 3",
                  flush=True)
            data = data_job.result()
        with phase("serve: CheckpointHandle.open(dir).engine(), bsr"):
            requests = [tfidf_rows(rng, n, perm) for n in REQUEST_ROWS]
            requests[ZERO_REQUEST][:] = 0.0
            err = max(r["max_abs_err"] for r in bsr["sweep"])
            served = serve(ckpt, requests, max(1e-7, 10 * err))

        with phase("shortlist and int8 kernels vs plain versions"):
            from repro_torch.checkpoint.io import load_shortlist
            from repro_torch.core.pruning import quantize_block_sparse
            flush = torch.empty(64 * 2**20, device="cuda")   # 256 MB
            gpu_model = model.to("cuda")
            t0 = time.perf_counter()
            q = quantize_block_sparse(gpu_model)
            print(f"   int8 artifact: {q.payload_bytes() / 1e6:.1f} MB "
                  f"(blocks and scales), quantized in "
                  f"{time.perf_counter() - t0:.1f} s")
            centroids = torch.as_tensor(load_shortlist(ckpt).centroids,
                                        device="cuda")
            sl = check_shortlist_int8(gpu_model, q, centroids, X, flush)
            pq_sweep = check_pq_sweep(gpu_model, q, centroids, X, flush)
            del gpu_model, q, centroids, flush
            torch.cuda.empty_cache()

        with phase("serve: shortlist, shortlist per-query, shortlist int8, "
                   "shortlist int8 per-query, int8"):
            served_cfg = serve_configs(ckpt, requests, max(1e-7, 10 * err),
                                       served["labels"])
        del model, X

        from repro_torch.kernels.hinge.ops import aligned_rows

        with phase("train kernels vs plain versions "
                   "(1,024, 14,146, 101,938)"):
            flush = torch.empty(64 * 2**20, device="cuda")       # 256 MB
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            Xd = aligned_rows(data.X_train, "cuda")   # as fit places it
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

        with tempfile.TemporaryDirectory(dir=build_dir) as trained_ckpt:
            with phase("train: fit(X, Y, spec, dir) on the card"), \
                    tron_counters() as single_calls:
                trained = train(data, trained_ckpt,
                            {k: v["ms"] for k, v in train_k["times"].items()})
            with phase("serve trained: bsr, shortlist, shortlist per-query"):
                served_t = serve_trained(trained_ckpt, data,
                                         max(1e-7, 10 * err))
            with phase("server: ModelRouter, Poisson load, hot swap"):
                server = serve_async(ckpt, trained_ckpt, rng, perm,
                                     max(1e-7, 10 * err))
            with phase("mesh train: fit on (1, 2), (2, 1) shard_data, "
                       "(2, 2) shard_data balance and the default mesh"), \
                    tempfile.TemporaryDirectory(dir=build_dir) as mesh_root:
                mesh_train = train_meshes(data, trained_ckpt, single_calls,
                                          max(1e-7, 10 * err), mesh_root,
                                          args.seed)
            # Phase 12b sets L1-SVM beside this model's first label batch.
            dismec_W = packed_weights(trained_ckpt)[:TRAIN_BATCH].cpu()
            torch.cuda.empty_cache()
        with phase("mesh serve: sharded on (1, 4) and the default mesh"):
            mesh_serve = serve_sharded(ckpt, requests, max(1e-7, 10 * err),
                                       served["labels"])
            del requests

        cpu_ref = cpu_baselines()                   # phase 12b's reference
        with tempfile.TemporaryDirectory(dir=build_dir) as out_root:
            with phase("sweep: lifecycle.sweep on the card"):
                swept = run_sweep(data, out_root)
            with phase("CLI: launch.serve --xmc --server, SIGTERM"):
                cli = run_cli(out_root)
        with phase("baselines: Table 2 on the paper-like datasets; L1-SVM "
                   "and FastXML at Wiki10-31K width"):
            base = run_baselines(data, dismec_W, build_dir,
                                 max(1e-7, 10 * err), cpu_ref)
        del data, dismec_W
        torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    lm_rng = np.random.default_rng([args.seed, 15])
    with phase(f"LM: {LM_ARCH} at full width, bf16, weights from the seed"):
        lm_cfg = get_config(LM_ARCH)
        lm = build_lm(lm_cfg)
        t0 = time.perf_counter()
        lm_params = lm.init(torch.Generator(device="cuda")
                            .manual_seed(args.seed))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in lm_params.parameters())
        print(f"   {n_params / 1e9:.3f} B parameters "
              f"({sum(p.nbytes for p in lm_params.parameters()) / 1e9:.2f}"
              f" GB), drawn in {time.perf_counter() - t0:.1f} s; windows "
              f"{lm_cfg.sliding_window} except layers "
              f"{lm_cfg.global_attn_layers}", flush=True)
    with phase("lm kernel: banded attention vs plain version"):
        flush = torch.empty(64 * 2**20, device="cuda")       # 256 MB
        banded = check_banded(lm_cfg, torch.Generator(device="cuda")
                              .manual_seed(args.seed), flush)
        del flush
        torch.cuda.empty_cache()
    with phase(f"lm prefill: {LM_PREFILL} on the kernel and on the plain "
               "version"):
        lm_pre = lm_prefill(lm, lm_params, lm_rng)
    with phase(f"lm decode: prefill {LM_DECODE} vs {LM_DECODE[1]:,} "
               f"teacher-forced decode steps, {LM_DECODE_LAYERS} layers"):
        cut = build_lm(dataclasses.replace(
            lm_cfg, n_layers=LM_DECODE_LAYERS,
            global_attn_layers=LM_DECODE_GLOBAL))
        lm_dec = lm_decode(cut, cut.init(torch.Generator(device="cuda")
                                         .manual_seed(args.seed)), lm_rng)
        del cut
    with phase("lm serve: serve_batch, ragged prompts"):
        lm_srv = lm_serve(lm, lm_params, lm_rng)
    torch.cuda.empty_cache()              # lm_params stay for phase 19 (b)
    with phase(f"lm CLI: launch.serve --arch {LM_ARCH}"):
        lm_cli_out = lm_cli()
    # Phase 16 (c)'s and 18 (e)'s training CLIs run beside phase 16 (a) and
    # (b)'s fp32 pass.
    clis = start_train_clis(build_dir)
    with phase(f"lm train: smoke configs card vs CPU; {LM_ARCH} at full "
               f"width, T = {LM_TRAIN_FULL['T']:,}; launch.train --arch"):
        lm_tr = lm_train(args.seed, build_dir, clis)
    with phase("lm families: smoke configs card vs CPU; qwen2-moe-a2.7b, "
               "mixtral-8x22b (2 layers), xlstm-125m, internvl2-26b at full "
               "width"):
        fam = families(args.seed)
    with phase(f"encoder-decoder and the LM mesh: smoke configs card vs "
               f"CPU; {ED_ARCH} at full width; training on a {ED_MESH} "
               f"grid"):
        ed = encdec_mesh(args.seed, build_dir, clis)
    with phase(f"LM serving over a mesh: smoke configs on a {MS_GRID} grid "
               f"of cuda:0 vs the CPU's; {LM_ARCH} whole on {MS_GRID}; "
               f"qwen2-moe-a2.7b (in phase 17b) on {MS_MOE['mesh']}"):
        ms = mesh_serving(args.seed, lm, lm_params,
                          fam["qwen2_moe"]["mesh_serve"])
    del lm_params
    torch.cuda.empty_cache()

    head = next(r for r in bsr["sweep"] if r["n"] == HEADLINE_N)
    kernels = [
        dict(name="bsr_predict", route="cuda",
             source="src/repro_torch/csrc/bsr_predict.cu",
             replaces="src/repro/kernels/bsr_predict/kernel.py:31",
             launches=served["launches"]["bsr_predict"],
             max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
             bound_ms=head["bound_ms"], bound_by=head["bound_by"],
             library_ms=head["library_ms"], library=bsr["library"],
             at=f"n={HEADLINE_N}", sweep=bsr["sweep"],
             design="ex_kernel (TMA ring, producer warp, swizzled boxes) "
             "at every n", redesigned=True),
        dict(name="blocked_topk", route="cuda",
             source="src/repro_torch/csrc/topk.cu",
             replaces="src/repro/kernels/topk/kernel.py:25",
             launches=served["launches"]["blocked_topk"],
             max_abs_err=topk["max_abs_err"], ms=topk["ms"],
             plain_ms=topk["plain_ms"], bound_ms=topk["bound_ms"],
             bound_by=topk["bound_by"], library_ms=topk["library_ms"],
             library="torch.topk(scores, 5).values",
             at=f"({topk['n']}, {topk['L']}) k={K}, unpadded",
             design="a warp per (row, 512-score block), scores in "
             "registers, rounds as two warp reductions", redesigned=True,
             cases=topk["cases"], launches_mesh={
                 f"sharded {k}": v["launches"]["blocked_topk"]
                 for k, v in mesh_serve.items()},
             launches_baselines=base["topk_launches"],
             launches_families={k: v["blocked_topk"]
                                for k, v in fam["launches"].items()},
             launches_encdec_mesh={k: v["blocked_topk"]
                                   for k, v in ed["launches"].items()},
             launches_mesh_serve={k: v["blocked_topk"]
                                  for k, v in ms["launches"].items()}),
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
            library="the two torch.matmul products, TF32 off", at=at,
            bound_note="TF32 products of split fp32 (3 per fp32 product) "
            "at 495 TFLOP/s", bound_ffma_ms=t["bound_ffma_ms"],
            hgmma=train_k["hgmma"][key], fp64_share=t["fp64_share"],
            launches_mesh={k: v["launches"][name]
                           for k, v in mesh_train.items()
                           if k != "control"}))
    config_of = {kernel: name for name, _, kernel in SERVE_CONFIGS}
    for name, replaces in (("bsr_predict_int8", 70), ("bsr_gather", 122),
                           ("bsr_gather_int8", 192), ("bsr_gather_pq", 256),
                           ("bsr_gather_pq_int8", 339)):
        sweep = sl["sweeps"][name]
        h = next(r for r in sweep if r["n"] == HEADLINE_N)
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/bsr_predict.cu",
            replaces=f"src/repro/kernels/bsr_predict/kernel.py:{replaces}",
            launches=served_cfg[config_of[name]]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in sweep), ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"],
            library="none: no single PyTorch call gives each query its own "
            "gathered scores" if h["library_ms"] is None else
            "torch.sparse_bsr_tensor @ x.T over the " +
            ("dequantized " if "int8" in name else "") +
            ("selected blocks" if "gather" in name else "blocks"),
            at=f"n={HEADLINE_N}, B={sl['B']} of {sl['R']} row blocks"
            if "gather" in name else f"n={HEADLINE_N}", sweep=sweep))
    k4 = next(k for k in kernels if k["name"] == "bsr_predict_int8")
    k4.update(design=f"gather_kernel (each row block its own slot) at n <= "
              f"{int8_designs['switch']}, bsr_kernel above", redesigned=True,
              designs=int8_designs["rows"])
    for k in kernels:
        if "pq" in k["name"]:
            k.update(design="pq_kernel (a CTA per row block, chunk of up "
                     "to 64 of its (query, slot) pairs and label tile)",
                     redesigned=True, timed=[
                         r for r in pq_sweep if r["name"] == k["name"]])
    band = banded["rows"][0]
    kernels.append(dict(
        name="banded_attention", route="cuda",
        source="src/repro_torch/csrc/banded_attn.cu",
        replaces="src/repro/kernels/banded_attn/kernel.py:38",
        launches=lm_pre["launches"]["banded_attention"],
        max_abs_err=max(r["max_abs_err"] for r in banded["rows"]),
        ms=band["ms"], plain_ms=band["plain_ms"], bound_ms=band["bound_ms"],
        bound_by=band["bound_by"], library_ms=band["library_ms"],
        library="F.scaled_dot_product_attention (efficient kernel) with a "
        "boolean band mask, k and v repeated to the query heads",
        at="(B, T, H, KV, hd, window) = ({}, {}, {}, {}, {}, {}), {}".format(
            band["B"], band["T"], *banded["shape"], band["dtype"]),
        design="bf16: wgmma (m64n64k16 Q.K^T, P.V with P from registers) on "
        "TMA tiles; fp32: FFMA", redesigned=True, hgmma=banded["hgmma"],
        sweep=banded["rows"], launches_families={
            k: v["banded_attention"] for k, v in fam["launches"].items()},
        launches_mesh_serve={k: v["banded_attention"]
                             for k, v in ms["launches"].items()},
        mixtral=dict(shape=fam["mixtral"]["kernel"]["shape"],
                     **fam["mixtral"]["kernel"]["rows"][0])))
    print(json.dumps({"kernels": kernels, "serve": {
        k: served[k] for k in ("p50_ms", "p99_ms", "p99_limit_ms",
                               "meets_limit", "large_requests", "load_s",
                               "warmup_s", "peak_mib", "agree", "decisive",
                               "request_64_ms")}, "serve_configs": served_cfg}))
    print(json.dumps({"train": {**trained, "tron": tron,
                                "serve_trained": served_t}}))
    print(json.dumps({"server": server, "sweep": swept, "cli": cli}))
    print(json.dumps({"mesh": {"train": mesh_train, "serve": mesh_serve}}))
    print(json.dumps({"lm": {"arch": LM_ARCH, "params": n_params,
                             "prefill": lm_pre, "decode": lm_dec,
                             "serve": lm_srv, "cli": lm_cli_out,
                             "train": lm_tr}}))
    print(json.dumps({"baselines": base}))
    print(json.dumps({"lm_families": fam}))
    print(json.dumps({"encdec_mesh": ed}))
    print(json.dumps({"mesh_serve": ms}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
