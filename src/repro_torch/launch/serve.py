"""Serving launcher: LM decode or XMC top-k label serving with the
PyTorch port.

LM mode (batched greedy decode of ragged prompts; random weights from
--seed, `use_swa` as the architecture has it):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --steps 16 --batch 4                  # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --device cpu                  # the smoke config, on the CPU

The text-only archs serve (dense, hybrid, moe, ssm). The modality-prefix
(VLM) and encoder-decoder archs exit, as the JAX package's CLI does: their
prompts go in through `model.prefill(params, {"tokens", "prefix"})`, the
prefix being the patch or frame embeddings.

XMC mode (the paper's distributed prediction as a service; trains and
checkpoints a small sparse model first if --ckpt does not exist yet, then
opens it as a CheckpointHandle — the spec rides in the manifest — and
overrides just its ServeSpec with the CLI flags):

  PYTHONPATH=src python -m repro_torch.launch.serve --xmc --backend bsr \
      --ckpt /tmp/xmc_ckpt --requests 64 --k 5

`--backend sharded` serves the densified model label-sharded over a (1,
n) mesh of every card (one shard on the CPU with `--device cpu`), and
prints the same `req[0]` labels as `dense` and `bsr`.

XMC server mode (the continuous-batching async request path: deadline-
launched buckets, admission control, and a multi-model router in one
process; each --model carries its own per-model ServeSpec overrides and
an open-loop Poisson load generator drives the router):

  PYTHONPATH=src python -m repro_torch.launch.serve --xmc --server \
      --model wiki=/tmp/ckpt_a,backend=bsr,k=5,delay=2,max_queue=256 \
      --model amazon=/tmp/ckpt_b,backend=shortlist,int8=1,k=10 \
      --rate 200 --requests 400

With no --model, a single model named "default" is built from the plain
XMC flags (--ckpt/--backend/--k/--max-batch-delay-ms/--max-queue).
Everything runs on the card unless `--device cpu` is given. A port of the
JAX package's launcher of the same name.
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import threading
import time
from contextlib import contextmanager

import numpy as np

#: --model value: NAME=CKPT_DIR[,key=value...]; these keys override the
#: checkpoint's own ServeSpec for that model's server.
MODEL_KEYS = ("backend", "k", "delay", "max_queue", "shortlist_blocks",
              "int8")


def parse_model_flag(value: str) -> tuple[str, str, dict]:
    """'wiki=/tmp/ckpt,backend=bsr,k=5' -> (name, ckpt_dir, overrides)."""
    head, *opts = value.split(",")
    if "=" not in head:
        raise argparse.ArgumentTypeError(
            f"--model must look like NAME=CKPT_DIR[,key=value...], "
            f"got {value!r}")
    name, ckpt = head.split("=", 1)
    overrides: dict = {}
    for opt in opts:
        if "=" not in opt:
            raise argparse.ArgumentTypeError(
                f"--model option {opt!r} is not key=value")
        key, val = opt.split("=", 1)
        if key not in MODEL_KEYS:
            raise argparse.ArgumentTypeError(
                f"--model key {key!r} unknown; valid: {MODEL_KEYS}")
        overrides[key] = val
    return name, ckpt, overrides


def serve_xmc(args) -> None:
    from repro_torch.train.xmc import train_demo_checkpoint
    from repro_torch.xmc_api import CheckpointHandle

    # Shared demo setup: dataset + streamed sparse checkpoint through the
    # spec-driven session, reused if already on disk.
    d, index = train_demo_checkpoint(
        args.ckpt, n_train=600, n_test=max(args.requests * 4, 64),
        n_features=args.features, n_labels=args.labels,
        label_batch=min(128, args.labels), seed=args.seed,
        device=args.device)
    # Validate the request shape against the checkpoint meta BEFORE paying
    # for engine load + per-bucket warm-up compiles.
    ckpt_features = index["meta"].get(
        "n_features", index.get("orig_shape", index["shape"])[1])
    if ckpt_features != args.features:
        raise SystemExit(
            f"--features {args.features} does not match the checkpoint's "
            f"feature dim {ckpt_features}; re-run with --features "
            f"{ckpt_features} or point --ckpt elsewhere")

    t0 = time.time()
    # The manifest carries the full spec; CLI flags override just the
    # serving half of it for this session.
    handle = CheckpointHandle.open(args.ckpt, device=args.device)
    engine = handle.engine(
        handle.spec.serve.replace(backend=args.backend, k=args.k,
                                  shortlist_blocks=args.shortlist_blocks,
                                  int8=args.int8))
    print(f"[xmc] backend={args.backend} int8={args.int8} on "
          f"{handle.device} loaded+warmed in "
          f"{time.time() - t0:.1f}s "
          f"(L={engine.backend.n_labels}, k={engine.backend.k})")

    rng = np.random.default_rng(args.seed)
    pool = np.asarray(d.X_test, np.float32)
    requests = []
    for _ in range(args.requests):
        n_i = int(rng.integers(1, args.max_request_rows + 1))
        rows = rng.integers(0, pool.shape[0], size=n_i)
        requests.append(pool[rows])

    results = engine.serve(requests)
    stats = engine.latency_summary()
    n_inst = sum(r.labels.shape[0] for r in results)
    print(f"[xmc] served {len(results)} requests ({n_inst} instances): "
          f"p50={stats['p50_ms']:.2f}ms p99={stats['p99_ms']:.2f}ms "
          f"mean={stats['mean_ms']:.2f}ms")
    sample = results[0]
    print(f"[xmc] req[0] top-{args.k} labels per instance: "
          f"{sample.labels[:2].tolist()}")


@contextmanager
def drain_on_signals(router):
    """SIGTERM/SIGINT (main thread only) raise SystemExit(128+sig) so the
    enclosing `with router:` force-drains — every accepted future resolves
    before the process exits — instead of dying with dispatcher threads
    mid-batch. Prior handlers are restored on the way out."""
    if threading.current_thread() is not threading.main_thread():
        yield []                       # signals only reach the main thread
        return
    caught: list[int] = []

    def _handler(signum, frame):
        caught.append(signum)
        raise SystemExit(128 + signum)

    prev = [(s, signal.signal(s, _handler))
            for s in (signal.SIGTERM, signal.SIGINT)]
    try:
        yield caught
    finally:
        for s, h in prev:
            signal.signal(s, h)
        if caught:
            print(f"[server] caught signal {caught[0]}; router drained — "
                  "every accepted request resolved", flush=True)


def serve_xmc_server(args) -> None:
    """Multi-model continuous-batching server under open-loop Poisson load.

    Builds one async `XMCServer` per --model (training a small demo
    checkpoint first when the directory has none), routes a Poisson
    request stream across them through `ModelRouter`, and reports
    per-model arrival-to-completion percentiles, queue wait, goodput, and
    reject rate. `--watch` attaches a `CheckpointWatcher` per model: a
    newer finalized checkpoint generation in that model's directory is
    hot-swapped in without dropping a request. SIGTERM/SIGINT at any point —
    including mid-load — drain the router (every accepted future resolves)
    before the process exits.
    """
    from repro_torch.serve.server import ModelRouter, Rejected
    from repro_torch.train.xmc import train_demo_checkpoint
    from repro_torch.xmc_api import CheckpointHandle

    model_flags = args.model or [
        (f"default={args.ckpt},backend={args.backend},k={args.k}")]
    router = ModelRouter()
    pools: dict[str, np.ndarray] = {}
    t0 = time.time()
    # The signal scope opens BEFORE models load: a SIGTERM during engine
    # warm-up still drains whatever servers are already routed. `with
    # router` guarantees the drain on every exit path (normal, exception,
    # or signal-raised SystemExit).
    with drain_on_signals(router), router:
        for flag in model_flags:
            name, ckpt, ov = parse_model_flag(flag) \
                if isinstance(flag, str) else flag
            d, _ = train_demo_checkpoint(
                ckpt, n_train=600, n_test=max(args.requests, 64),
                n_features=args.features, n_labels=args.labels,
                label_batch=min(128, args.labels), seed=args.seed,
                device=args.device)
            handle = CheckpointHandle.open(ckpt, device=args.device)
            serve = handle.spec.serve.replace(
                backend=ov.get("backend", args.backend),
                k=int(ov.get("k", args.k)),
                max_batch_delay_ms=float(ov.get("delay",
                                                args.max_batch_delay_ms)),
                max_queue=(int(ov["max_queue"]) if "max_queue" in ov
                           else args.max_queue),
                shortlist_blocks=(int(ov["shortlist_blocks"])
                                  if "shortlist_blocks" in ov
                                  else args.shortlist_blocks),
                int8=(ov["int8"].lower() in ("1", "true", "yes")
                      if "int8" in ov else args.int8))
            router.add(name, handle.server(serve, name=name))
            pools[name] = np.asarray(d.X_test, np.float32)
            print(f"[server] model {name!r}: backend={serve.backend} "
                  f"k={serve.k} delay={serve.max_batch_delay_ms}ms "
                  f"max_queue={serve.max_queue} ({ckpt})")
            if args.watch:
                router.watch(name, ckpt, serve_override=serve,
                             poll_interval_s=args.watch_interval)
                print(f"[server] watching {ckpt} for newer generations "
                      f"every {args.watch_interval}s")
        print(f"[server] {len(router)} model(s) loaded+warmed in "
              f"{time.time() - t0:.1f}s; offering ~{args.rate} req/s "
              f"({args.requests} requests, Poisson arrivals)", flush=True)

        rng = np.random.default_rng(args.seed)
        names = router.models()
        futures = []
        t_start = time.monotonic()
        t_next = t_start
        for _ in range(args.requests):
            t_next += rng.exponential(1.0 / args.rate)
            now = time.monotonic()
            if t_next > now:
                time.sleep(t_next - now)
            name = names[int(rng.integers(len(names)))]
            pool = pools[name]
            n_i = int(rng.integers(1, args.max_request_rows + 1))
            futures.append((name, router.submit(
                name, pool[rng.integers(0, pool.shape[0], size=n_i)])))
        router.stop()                 # flush: every accepted future resolves
        wall = time.monotonic() - t_start

        for name in names:
            st = router[name].stats()
            lat, qw = st["latency"], st["queue_wait"]
            print(f"[server] {name}: completed={st['completed']} "
                  f"rejected={st['rejected']} "
                  f"(reject_rate={st['reject_rate']:.3f}) "
                  f"swaps={st['swaps']} "
                  f"p50={lat.get('p50_ms', float('nan')):.2f}ms "
                  f"p99={lat.get('p99_ms', float('nan')):.2f}ms "
                  f"queue_wait_p99={qw.get('p99_ms', float('nan')):.2f}ms")
        done = sum(1 for _, f in futures
                   if not isinstance(f.result(0), Rejected))
        print(f"[server] goodput {done / wall:.1f} req/s over {wall:.2f}s "
              f"wall across {len(names)} model(s)")


def serve_lm(args) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import serve_batch

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder_decoder or cfg.n_prefix:
        raise SystemExit("serve CLI drives text-only archs, as the JAX "
                         "package's does; an encoder-decoder or VLM prompt "
                         "takes its frame or patch prefix through "
                         "model.prefill(params, {'tokens', 'prefix'})")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(2, cfg.vocab, size=rng.integers(4, 12))
            for _ in range(args.batch)]
    t0 = time.perf_counter()
    outs = serve_batch(model, params, reqs, steps=args.steps,
                       use_swa=cfg.swa_always)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"req[{i}] -> {o.tolist()}")
    n_tok = args.batch * args.steps
    print(f"# {n_tok} tokens in {dt:.1f}s ({1e3 * dt / n_tok:.1f} ms/tok) "
          f"on {model.device.type}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--xmc", action="store_true",
                    help="serve XMC top-k label queries instead of LM decode")
    ap.add_argument("--server", action="store_true",
                    help="XMC mode: run the async continuous-batching "
                         "multi-model server under Poisson load instead of "
                         "the synchronous engine demo")
    ap.add_argument("--model", action="append", default=None,
                    metavar="NAME=CKPT[,key=val...]",
                    help="server mode, repeatable: route NAME to CKPT with "
                         f"per-model ServeSpec overrides {MODEL_KEYS}")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="server mode: offered load, requests/s (Poisson)")
    ap.add_argument("--max-batch-delay-ms", type=float, default=2.0,
                    help="server mode: bucket launch deadline")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="server mode: admission bound on queued requests "
                         "(default unbounded)")
    ap.add_argument("--watch", action="store_true",
                    help="server mode: poll each model's checkpoint dir and "
                         "hot-swap newer finalized generations in without "
                         "dropping a request "
                         "(lifecycle.refresh.CheckpointWatcher)")
    ap.add_argument("--watch-interval", type=float, default=2.0,
                    help="server mode: --watch poll interval, seconds")
    from repro_torch.configs.registry import ARCH_IDS
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS),
                    help="LM mode: architecture to serve")
    ap.add_argument("--smoke", action="store_true",
                    help="LM mode: the architecture's reduced config")
    ap.add_argument("--steps", type=int, default=16,
                    help="LM mode: tokens to generate per request")
    ap.add_argument("--batch", type=int, default=4,
                    help="LM mode: ragged prompts of 4-11 tokens")
    from repro_torch.serve.xmc import available_backends
    ap.add_argument("--backend", default="dense",
                    choices=available_backends(),
                    help="XMC mode: predict backend (registry kinds)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_xmc_ckpt"),
                    help="XMC mode: sparse checkpoint directory")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--shortlist-blocks", type=int, default=None,
                    help="XMC mode, shortlist backend: candidate row blocks "
                         "B per micro-batch (default: artifact's ~1/8)")
    ap.add_argument("--int8", action="store_true",
                    help="XMC mode: serve the per-block int8 weight "
                         "artifact (~0.25x weight HBM traffic; composes "
                         "with --backend shortlist's gathered fine stage)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-request-rows", type=int, default=8)
    ap.add_argument("--features", type=int, default=4096)
    ap.add_argument("--labels", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the models train and serve: cuda (the "
                         "card, the default) or cpu")
    args = ap.parse_args()

    if args.xmc:
        if args.server:
            serve_xmc_server(args)
        else:
            serve_xmc(args)
    elif args.server:
        ap.error("--server requires --xmc (the LM path has no async server)")
    elif args.arch is None:
        ap.error("pass --xmc (XMC serving) or --arch ID (LM decode)")
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
