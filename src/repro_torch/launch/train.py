"""Training launcher: LM training or the streaming XMC pipeline, with the
PyTorch port.

LM mode (`--arch`: build_model -> TokenPipeline batches -> train_loop with
AdamW and the DiSMEC one-vs-rest head, or `--head softmax`; the history
as JSON lines, then `save_pytree` to --out in the JAX package's layout):

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --smoke --steps 20 --seq-len 128 --batch 8 --out /tmp/lm_ckpt

Every family trains: a VLM config takes the JAX launcher's prefix batches
(patch embeddings of 0.01), and so does the encoder-decoder (its frame
embeddings). `--mesh DxM` trains over a (data, model) grid of devices
driven from this one process, the batch over "data" as the JAX launcher
passes it, the DiSMEC head label-sharded over "model" (the distinct cards,
or D*M entries of one device: `--device cpu`, or `--device cuda:0` for a
grid on one card):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --mesh 2x2 --device cpu --steps 10

XMC mode (flags -> XMCSpec -> repro_torch.xmc_api.fit: streaming
label-batch pipeline -> servable sparse checkpoint with the spec in its
manifest; re-running with the same --out resumes a killed job,
--init-from warm starts from a prior checkpoint's weights):

  PYTHONPATH=src python -m repro_torch.launch.train --xmc --labels 512 \\
      --label-batch 128 --out /tmp/xmc_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --xmc --labels 512 \\
      --delta 0.02 --out /tmp/xmc_d02 --init-from /tmp/xmc_ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --xmc --ckpt /tmp/xmc_ckpt

Several workers on one --out (`--workers 2 --worker-id node0`, ...) claim
label batches through the manifest's lease table and drain one queue into
one checkpoint. `--mesh DxM [--shard-data] [--balance]` shards each
batch's solve over a (data, model) grid of devices driven from this one
process: the distinct cards cuda:0 ... cuda:D*M-1 (it raises when there
are fewer), or D*M entries of the one device `--device` names (cpu, or
cuda:0):

  PYTHONPATH=src python -m repro_torch.launch.train --xmc --mesh 2x4 \
      --shard-data --balance --device cpu --out /tmp/xmc_mesh

Everything runs on the card unless `--device cpu` is given. A port of
the JAX package's launcher of the same name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch


def _mesh(args):
    """--mesh DxM: the distinct cards cuda:0 ... cuda:D*M-1 (--device
    cuda), or D*M entries of the one device --device names (cpu, or a
    card: cuda:0); None without the flag."""
    from repro_torch.launch.mesh import make_host_mesh
    if not args.mesh:
        return None
    d, m = (int(x) for x in args.mesh.split("x"))
    return make_host_mesh(d, m, devices=None if args.device == "cuda"
                          else [args.device] * (d * m))


def train_lm(args) -> None:
    """--arch: train an LM from random weights (drawn from --seed) on the
    synthetic token pipeline's batches (drawn from --seed)."""
    from repro_torch.checkpoint.io import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.data.lm import make_lm_batch_iterator
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import train_loop

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.head:
        cfg = dataclasses.replace(cfg, head_type=args.head)
    mesh = _mesh(args)
    model = build_model(cfg, device=mesh.first if mesh else args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    tokens = make_lm_batch_iterator(cfg.vocab, args.seq_len, args.batch,
                                    seed=args.seed)
    # The JAX launcher's stand-in patch (or frame) embeddings for a prefix
    # config.
    prefix = np.ones((args.batch, cfg.n_prefix, cfg.d_model),
                     np.float32) * 0.01

    def batches():
        for b in tokens:
            yield {**b, "prefix": prefix} if cfg.n_prefix else b

    t0 = time.time()
    params, hist = train_loop(model, params, batches(), steps=args.steps,
                              lr=args.lr, mesh=mesh,
                              batch_axes=("data",) if mesh else ())
    for h in hist:
        print(json.dumps(h))
    print(f"# trained {args.steps} steps in {time.time() - t0:.1f}s on "
          f"{model.device.type}; loss {hist[0]['loss']:.2f} -> "
          f"{hist[-1]['loss']:.2f}")
    if args.out:
        save_pytree(params, args.out)
        print(f"# checkpoint saved to {args.out}")


def train_xmc(args) -> None:
    """--xmc: one declarative session — args become an XMCSpec, `fit()`
    streams the checkpoint, the handle quick-evals it."""
    from repro_torch.core.prediction import evaluate, predict_topk
    from repro_torch.data.xmc import make_xmc_dataset
    from repro_torch.specs import ScheduleSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, fit

    if args.out is None:
        args.out = os.path.join(tempfile.gettempdir(),
                                "repro_torch_xmc_train_ckpt")
    mesh = _mesh(args)
    data = make_xmc_dataset(n_train=args.train_n, n_test=args.test_n,
                            n_features=args.features, n_labels=args.labels,
                            seed=args.seed)
    # fit() normalizes the spec: a label batch that is not a multiple of the
    # BSR block height is rounded up with a warning.
    spec = XMCSpec(
        solver=SolverSpec(C=args.C, delta=args.delta),
        schedule=ScheduleSpec(label_batch=args.label_batch,
                              shard_data=args.shard_data,
                              balance=args.balance, workers=args.workers,
                              lease_ttl=args.lease_ttl))

    t0 = time.time()
    handle = fit(data.X_train, data.Y_train, spec, args.out,
                 resume=not args.fresh, init_from=args.init_from,
                 worker=args.worker_id, device=args.device, mesh=mesh,
                 on_batch=lambda b, n: print(
                     f"[xmc] batch {b + 1}/{n} done "
                     f"({time.time() - t0:.1f}s)"))
    wall = time.time() - t0
    res = handle.result
    print(f"[xmc] {len(res.solved)} batches solved, {len(res.skipped)} "
          f"resumed from manifest in {wall:.1f}s on {handle.device} -> "
          f"{args.out}"
          + (f" (warm-started from {args.init_from})"
             if args.init_from else ""))

    if not res.complete:
        # A normal run (cooperative or not) returns complete — workers
        # wait out co-worker leases. Reaching here means the run was cut
        # short; re-running the same command resumes it.
        print(f"[xmc] checkpoint not complete ({len(res.solved)} batches "
              f"by this worker); re-run this command to finish {args.out}")
        return

    nnz = sum(s["nnz"] for s in res.manifest["shards"].values())
    total = args.labels * args.features
    print(f"[xmc] model: {nnz} nonzeros / {total} "
          f"({100.0 * nnz / total:.2f}% dense)")

    # Quick-eval only at smoke scale: to_dense() would rebuild the full
    # (L, D) matrix the streaming pipeline just avoided materializing.
    if args.labels * args.features <= 50_000_000:
        model, _ = handle.model()
        W = model.to_dense()[:args.labels, :args.features]
        X_test = torch.as_tensor(data.X_test, device=handle.device)
        _, idx = predict_topk(X_test, W, 5)
        ev = evaluate(torch.as_tensor(data.Y_test, device=handle.device),
                      idx)
        print(f"[xmc] test P@1={ev['P@1']:.3f} P@5={ev['P@5']:.3f}")
    else:
        print("[xmc] model too large for dense quick-eval; serve it with "
              "the bsr backend instead")
    print(f"[xmc] serve it: PYTHONPATH=src python -m "
          f"repro_torch.launch.serve --xmc --ckpt {args.out} --features "
          f"{args.features} --labels {args.labels} --device {args.device}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--xmc", action="store_true",
                    help="run the streaming XMC pipeline")
    ap.add_argument("--arch", default=None,
                    help="LM mode: architecture to train")
    ap.add_argument("--smoke", action="store_true",
                    help="LM mode: the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--head", choices=["dismec", "softmax"], default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 (data x model): shard each XMC batch's "
                         "solve, or each LM step, over that grid of "
                         "devices")
    ap.add_argument("--out", default=None, help="checkpoint directory")
    ap.add_argument("--labels", type=int, default=512)
    ap.add_argument("--features", type=int, default=4096)
    ap.add_argument("--train-n", type=int, default=1000)
    ap.add_argument("--test-n", type=int, default=300)
    ap.add_argument("--label-batch", type=int, default=128)
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--delta", type=float, default=0.01)
    ap.add_argument("--balance", action="store_true",
                    help="frequency-balanced label->shard dealing per batch")
    ap.add_argument("--shard-data", action="store_true",
                    help="also shard instances over the mesh data axis")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore any existing manifest (no resume)")
    ap.add_argument("--init-from", default=None,
                    help="warm start: prior sparse checkpoint whose rows "
                         "seed each batch's TRON as W0")
    ap.add_argument("--workers", type=int, default=1,
                    help="cooperative worker count: >1 claims label batches "
                         "via the manifest lease table, so N processes "
                         "sharing --out drain one queue into one checkpoint")
    ap.add_argument("--worker-id", default=None,
                    help="stable identity of this worker in a multi-host "
                         "drain (default: hostname-pid); implies lease-"
                         "based claiming even with --workers 1")
    ap.add_argument("--lease-ttl", type=float, default=300.0,
                    help="seconds before an unrefreshed batch lease expires "
                         "and the batch is re-dealt (crash recovery)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (the card, the "
                         "default; with --mesh, the distinct cards), a "
                         "card by index (cuda:0: with --mesh, every cell "
                         "on it) or cpu")
    args = ap.parse_args()

    if args.xmc:
        train_xmc(args)
    elif args.arch is None:
        ap.error("--arch is required in LM mode (or pass --xmc)")
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
