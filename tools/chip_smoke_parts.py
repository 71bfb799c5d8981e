#!/usr/bin/env python3
"""Parts of `chip_smoke.py` run alone on one card, for a short call:

    python3 tools/chip_smoke_parts.py phase19 [--seed 0]
    python3 tools/chip_smoke_parts.py phase3-beside-save [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card; the
kernels are built first, as the script builds them.

phase19: phase 19 (LM serving over a mesh) with the script's own
functions: (c) qwen2-moe-a2.7b whole, then (a) the smoke configs and (b)
hymba-1.5b whole, the weights drawn from the seed on the card.

phase3-beside-save: phase 3's kernel timings (kernels 3 and 9 against
their plain versions and library calls, kernel 4's two designs) on the
serving model at Wiki10-31K width, three times in one process: alone,
while `save_block_sparse` writes that model on a thread (as the script
overlaps them), and alone again; then each run's kernel and library
times side by side.

The last line is one JSON object of the results.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def phase19(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model as build_lm
    with cs.phase("19 (c): qwen2-moe-a2.7b whole"):
        m = build_lm(get_config(cs.FAM_MOE))
        p = m.init(torch.Generator(device="cuda").manual_seed(seed))
        launches: dict = {}
        t0 = time.perf_counter()
        res = cs.ms_moe(m, p, np.random.default_rng([seed, 19, 3]),
                        launches)
        part = dict(result=res, launches=launches,
                    wall_s=time.perf_counter() - t0)
        del m, p
        torch.cuda.empty_cache()
    with cs.phase("19 (a), (b)"):
        lm = build_lm(get_config(cs.LM_ARCH))
        lp = lm.init(torch.Generator(device="cuda").manual_seed(seed))
        return cs.mesh_serving(seed, lm, lp, part)


def phase3_beside_save(seed: int) -> dict:
    from repro_torch.checkpoint.io import save_block_sparse
    from repro_torch.kernels.bsr_predict import ops as bsr_ops
    rng = np.random.default_rng(seed)
    perm = rng.permutation(cs.N_FEATURES)
    model = cs.build_model(rng)
    X = cs.tfidf_rows(rng, max(cs.BSR_N), perm)

    def timings() -> dict:
        flush = torch.empty(64 * 2**20, device="cuda")     # 256 MB
        gpu = model.to("cuda")
        bsr = cs.check_bsr(gpu, X, flush)
        scores = bsr_ops.bsr_predict(torch.from_numpy(X).cuda(), gpu)
        scores[:, cs.N_LABELS:] = -3.0e38
        topk = cs.check_topk(scores, flush)
        int8 = cs.check_int8_designs(gpu, X, flush)
        del gpu, scores, flush
        torch.cuda.empty_cache()
        return dict(bsr=[{k: r[k] for k in ("n", "ms", "plain_ms",
                                            "library_ms")}
                         for r in bsr["sweep"]],
                    topk={k: topk[k] for k in ("ms", "plain_ms",
                                               "library_ms")},
                    int8=int8)

    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        with cs.phase("phase 3 alone"):
            out["alone"] = timings()
        saved: dict = {}

        def save():
            t = time.perf_counter()
            save_block_sparse(model, ckpt, meta={"n_labels": cs.N_LABELS})
            saved["s"] = time.perf_counter() - t
        saver = threading.Thread(target=save, name="save_block_sparse")
        saver.start()
        with cs.phase("phase 3 beside save_block_sparse"):
            out["beside_save"] = timings()
        out["save_running_at_the_end"] = saver.is_alive()
        saver.join()
        out["save_s"] = saved["s"]
        with cs.phase("phase 3 alone again"):
            out["alone_again"] = timings()
    for k in ("alone", "beside_save", "alone_again"):
        o = out[k]
        print(f"   {k}: kernel 3 ms {[r['ms'] for r in o['bsr']]}, library "
              f"{[r['library_ms'] for r in o['bsr']]}; kernel 9 "
              f"{o['topk']['ms']}, torch.topk {o['topk']['library_ms']}",
              flush=True)
    print(f"   the save ran through the whole of the second run: "
          f"{out['save_running_at_the_end']}; it took {out['save_s']:.1f} s",
          flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("part", choices=("phase19", "phase3-beside-save"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke_parts: no CUDA device; this runs on the card")
    from repro_torch.kernels import _build
    with cs.phase("build"):
        _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"   nvidia-smi: {smi}", flush=True)
    run = phase19 if args.part == "phase19" else phase3_beside_save
    print(json.dumps(run(args.seed), default=str))


if __name__ == "__main__":
    main()
