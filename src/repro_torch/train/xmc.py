"""Streaming label-batch training engine for DiSMEC (Algorithm 1 at
scale), on one GPU or a mesh of devices.

The public way to train is the session API:

    from repro_torch.xmc_api import XMCSpec, fit
    handle = fit(X, Y, XMCSpec(...), out_dir)        # on the card
    engine = handle.engine()                          # serving XMCEngine

`fit()` builds an `XMCTrainJob` from the spec and runs it here. The
mapping to the algorithm's steps 3-11 is the JAX package's:

  step 3     `for b in 0..B` over label batches -> the host-side scheduler
             loop in `run()`: contiguous label ranges of `label_batch`
             labels, the last one padded with all-negative sign rows so
             every batch has one shape;
  steps 4-6  train the batch's binary problems in parallel -> one batched
             TRON solve on the card (`core.dismec.make_batch_solver`), or
             one per label shard of a mesh (`launch/mesh.py`): labels
             split over the mesh's `model` axis, optionally instances
             over `data`. `balance=True` deals each batch's labels to the
             shards with `balance_permutation` and un-deals the solved
             rows on the host before the pack;
  step 7     prune ambiguous weights -> on the card, inside the solve;
  steps 8-10 write batch b's sparse model file -> the pruned rows are
             copied to the host, packed to append-form BSR and appended to
             the multi-shard checkpoint (`checkpoint.io.BlockSparseWriter`);
  step 11    assemble W -> never during training: the manifest is the
             model, and `load_block_sparse` stitches the shards.

`overlap=True` (the default) moves the BSR pack and the compressed shard
write to a bounded background worker, so they run while the next batch
solves. The solved rows are copied to the host at the end of each
dispatch, on the main thread: PyTorch's TRON loop blocks the main thread at
every per-iteration bool, and a copy issued from the worker thread on the
shared stream would wait behind the next batch's kernels. The checkpoint
bytes are the same as with `overlap=False`.

Resume: the manifest lists finished batches; a restarted job skips them.
Cooperative workers (`ScheduleSpec(workers=N)` or an explicit `worker=`
id) claim batches through the manifest's lease table, so N processes on one
`out_dir` drain one queue into one checkpoint, bit-identical to a
single-worker run.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.io import (BSR_ARRAYS, BlockSparseWriter,
                                       has_block_sparse_checkpoint,
                                       label_range_reader,
                                       load_block_sparse_meta)
from repro_torch.core.dismec import (DiSMECConfig, DiSMECModel,
                                     balance_permutation, make_batch_solver)
from repro_torch.core.pruning import to_block_sparse
from repro_torch.device import resolve_device, to_numpy
from repro_torch.launch.mesh import Mesh
from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec


def default_worker_id() -> str:
    """This trainer process's identity in a cooperative drain: unique per
    (host, process), stable for the process lifetime."""
    return f"{socket.gethostname()}-{os.getpid()}"


def solver_impl(device: torch.device) -> str:
    """The manifest's `impl` key: which implementation solved the shards.
    Shards of the card's kernels, the CPU's plain versions and the JAX
    package (which has no such key) are never stitched together."""
    return f"repro_torch/{'cuda' if device.type == 'cuda' else 'cpu'}"


def _init_fingerprint(init_from: str) -> dict:
    """Content identity of a warm-start source: a streamed source carries
    its own solver+data fingerprint in its manifest; a one-shot artifact's
    packed values are digested directly."""
    index = load_block_sparse_meta(init_from)
    if index.get("layout") == "stream":
        return {"solver": index["manifest"].get("solver"),
                "n_blocks": index["n_blocks"]}
    with np.load(os.path.join(init_from, BSR_ARRAYS)) as data:
        blocks = data["blocks"]
    return {"shape": list(index["shape"]), "n_blocks": index["n_blocks"],
            "nnz": int(np.count_nonzero(blocks)),
            "sum": float(blocks.sum()),
            "abs_sum": float(np.abs(blocks).sum())}


@dataclasses.dataclass
class XMCTrainResult:
    """What one `XMCTrainJob.run` did (and, if materialized, the model)."""
    model: Optional[DiSMECModel]   # only when materialize=True and complete
    out_dir: Optional[str]         # streamed checkpoint directory (if any)
    n_batches: int                 # total label batches of the job
    solved: list[int]              # batch ids solved by THIS run
    skipped: list[int]             # batch ids resumed from the manifest
    complete: bool                 # all batches present (servable)
    manifest: Optional[dict]       # final manifest when streamed + complete


@dataclasses.dataclass(frozen=True)
class XMCTrainJob:
    """Algorithm 1's outer loop as a restartable streaming pipeline.

    cfg.label_batch is the layer-1 batch size; when streaming it must be a
    multiple of the BSR block height. `mesh` (a `launch.mesh.Mesh`) turns
    on layer-2 sharding of each batch's solve, `shard_data` splits the
    instances over its data axis as well, and `balance` deals each batch's
    labels to the shards frequency-balanced (no-op without a mesh).
    `overlap` / `max_inflight` bound the background writer; `workers` /
    `lease_ttl` drive the cooperative lease-based drain (see the module
    docstring).
    """
    cfg: DiSMECConfig
    mesh: Optional[Mesh] = None
    label_axis: str = "model"
    data_axis: str = "data"
    shard_data: bool = False
    balance: bool = False
    block_shape: tuple[int, int] = (128, 128)
    overlap: bool = True
    max_inflight: int = 2
    workers: int = 1
    lease_ttl: float = 300.0

    def label_batches(self, n_labels: int) -> list[tuple[int, int]]:
        """Contiguous [start, stop) label ranges of the scheduler loop."""
        lb = min(self.cfg.label_batch, n_labels)
        return [(s, min(s + lb, n_labels)) for s in range(0, n_labels, lb)]

    def specs(self) -> tuple[SolverSpec, ScheduleSpec]:
        """This job as (SolverSpec, ScheduleSpec)."""
        return SolverSpec.from_config(self.cfg), ScheduleSpec.from_job(self)

    @obs.spanned("train.run")
    def run(self, X, Y, out_dir: Optional[str] = None, *,
            resume: bool = True, materialize: Optional[bool] = None,
            max_batches: Optional[int] = None, meta: Optional[dict] = None,
            on_batch: Optional[Callable[[int, int], None]] = None,
            init_from: Optional[str] = None, worker: Optional[str] = None,
            label_order=None, device=None) -> XMCTrainResult:
        """Train X (N, D), Y (N, L) (numpy arrays or tensors) into `out_dir`
        (streamed multi-shard checkpoint) and/or an in-memory model, on
        `device` (None: the card, or the first device of the job's mesh;
        "cpu" runs the plain solver ops). With a mesh, `device` must be
        of the mesh's kind: the solve runs on the mesh's devices.

        resume       : skip batches already in out_dir's manifest (False
                       starts the checkpoint fresh).
        materialize  : assemble W host-side and return a DiSMECModel;
                       defaults to True only when not streaming.
        max_batches  : stop after solving this many new batches (the
                       checkpoint is left incomplete: the preemption story).
        on_batch     : callback (batch_id, n_batches) after each written
                       batch; with overlap=True it runs on the writer thread,
                       in batch order, and an exception aborts the run.
        init_from    : warm start from a prior checkpoint's rows, read
                       label range by label range; the stopping tolerance
                       stays anchored at the cold-start gradient, so a
                       converged same-spec source is a fixed point.
        worker       : this process's identity in a cooperative drain;
                       passing it (or workers > 1) switches to lease-based
                       batch claiming over the shared manifest.
        label_order  : pack-time label permutation (trains Y[:, order]),
                       recorded in the manifest.

        While a profiler records, the call records a `train.run` span and
        its children (`repro_torch.obs`).
        """
        if self.mesh is not None:
            home = self.mesh.first
            if device is not None and torch.device(device).type != \
                    home.type:
                raise ValueError(f"device {device} is not of the kind of "
                                 f"the mesh's devices ({home})")
            device = home if device is None else device
        device = resolve_device(device)
        with obs.span("train.x_to_host") as sp:
            X_host = to_numpy(X)
            sp.set(bytes=X_host.nbytes)
        Yn = to_numpy(Y)
        if label_order is not None:
            label_order = np.asarray(label_order, np.int64).reshape(-1)
            Yn = Yn[:, label_order]
        N, L = Yn.shape
        D = int(X_host.shape[1])
        batches = self.label_batches(L)
        lb = batches[0][1] - batches[0][0]
        n_shards = self.mesh.shape[self.label_axis] if self.mesh else 1
        # Every batch is padded to one shape: lb rounded up to the label
        # shard count.
        lb_solve = -(-lb // n_shards) * n_shards
        bl, _ = self.block_shape
        if materialize is None:
            materialize = out_dir is None
        init_read = None
        if init_from is not None:
            init_D = load_block_sparse_meta(init_from)["orig_shape"][1]
            if init_D != D:
                raise ValueError(
                    f"init_from checkpoint has feature dim {init_D}, "
                    f"dataset has {D}; warm start needs matching features")
            init_read = label_range_reader(init_from)

        solver_spec, schedule_spec = self.specs()
        writer = None
        done: set[int] = set()
        if out_dir is not None:
            if lb % bl != 0 and len(batches) > 1:
                raise ValueError(
                    f"label_batch={lb} must be a multiple of the BSR block "
                    f"height {bl} to stream batches without re-tiling "
                    "(round label_batch up, or shrink block_shape; "
                    "repro_torch.xmc_api.fit normalizes this itself)")
            # What the solved weights depend on: the spec, the data, any
            # warm-start source, and the implementation that solved them.
            # The data sum is numpy's over the float32 array, as the JAX
            # package computes it, so the two packages' keys agree.
            solver_id = {
                "spec": {"solver": solver_spec.fingerprint(),
                         "schedule": schedule_spec.fingerprint()},
                "init": (None if init_from is None
                         else _init_fingerprint(init_from)),
                "data": [int(N), int(D),
                         float(np.asarray(X_host, np.float32).sum()),
                         int(Yn.sum())],
                "impl": solver_impl(device)}
            meta_full = {"n_labels": L, "n_features": D,
                         "delta": self.cfg.delta, **(meta or {})}
            meta_full.setdefault("xmc_spec", {
                "solver": solver_spec.to_dict(),
                "schedule": schedule_spec.canonical().to_dict(),
                "serve": ServeSpec().to_dict()})
            writer = BlockSparseWriter(
                out_dir, n_labels=L, n_features=D,
                block_shape=self.block_shape, label_batch=lb,
                n_batches=len(batches), resume=resume, solver=solver_id,
                meta=meta_full, label_order=label_order)
            done = writer.done_batches

        solver = make_batch_solver(
            X if isinstance(X, torch.Tensor) else X_host, self.cfg,
            self.mesh, label_axis=self.label_axis, data_axis=self.data_axis,
            shard_data=self.shard_data, warm=init_from is not None,
            device=device)

        host_blocks: dict[int, np.ndarray] = {}
        solved: list[int] = []
        skipped: list[int] = []
        coordinate = writer is not None and (self.workers > 1
                                             or worker is not None)
        worker_id = worker or default_worker_id()
        held: set[int] = set()               # leases this worker holds now
        held_lock = threading.Lock()
        # First failure of the background writer; the claim loop stops on
        # it, or a failed batch's heartbeated lease would wedge everyone.
        failed: list[BaseException] = []

        def inputs(start: int, stop: int):
            """A batch's sign rows (and a warm start's rows), dealt to the
            shards and padded to the solve's shape, on the device."""
            rows = stop - start
            signs = (2.0 * Yn[:, start:stop].T - 1.0).astype(np.float32)
            perm = None
            if self.balance and self.mesh is not None and rows > n_shards:
                perm = balance_permutation(Yn[:, start:stop], n_shards)
                signs = signs[perm]
            W0 = None
            if init_read is not None:
                W0r = init_read(start, stop)
                if perm is not None:     # W0 rows follow the shard dealing
                    W0r = W0r[perm]
                if rows < lb_solve:
                    W0r = np.concatenate(
                        [W0r, np.zeros((lb_solve - rows, D), np.float32)])
                W0 = torch.from_numpy(W0r).to(device)
            if rows < lb_solve:                           # shape-constant pad
                signs = np.concatenate(
                    [signs, -np.ones((lb_solve - rows, N), np.float32)])
            return torch.from_numpy(signs).to(device), W0, perm

        def dispatch(b: int, start: int, stop: int):
            """Solve one batch on the device and copy its rows to the host
            (on the main thread, before the next batch starts)."""
            rows = stop - start
            with obs.span("train.batch", batch=b):
                with obs.span("train.signs", batch=b) as sp:
                    S, W0, perm = inputs(start, stop)
                    sp.set(bytes=S.nbytes)
                with obs.span("train.solve", batch=b):
                    W_dev = solver(S, W0)
                with obs.span("train.rows_d2h", batch=b, bytes=rows * D * 4):
                    W_b = W_dev[:rows].cpu().numpy()
            if perm is not None:
                W_b = W_b[np.argsort(perm)]               # undo the dealing
            return b, start, rows, W_b

        def drain(item) -> None:
            """BSR pack + shard write of one solved batch (steps 8-10)."""
            b, start, rows, W_b = item
            with obs.span("train.drain", batch=b):
                if writer is not None:
                    with obs.span("train.pack", batch=b):
                        part = to_block_sparse(W_b, self.block_shape,
                                               row_block_offset=start // bl,
                                               sentinel_if_empty=False,
                                               device="cpu")
                    # The manifest commit also releases this batch's lease.
                    writer.write_batch(b, part, row_start=start, n_rows=rows)
                with held_lock:
                    held.discard(b)
                if materialize:
                    host_blocks[b] = W_b
                solved.append(b)
                if on_batch is not None:
                    on_batch(b, len(batches))

        def leased_batches() -> Iterable[tuple[int, int, int]]:
            """Claim the next unleased (or expired) batch right before
            dispatching it; when everything left is leased by live
            co-workers, back off until the earliest lease could expire."""
            n_claimed = 0
            while max_batches is None or n_claimed < max_batches:
                if failed:
                    return
                with held_lock:
                    in_flight = set(held)
                b = writer.claim_next_batch(worker_id, ttl=self.lease_ttl,
                                            exclude=in_flight)
                if b is None:
                    wait = writer.claim_wait_seconds()
                    if wait is None:            # every batch is written
                        return
                    time.sleep(min(max(wait, 0.05), 1.0))
                    continue
                with held_lock:
                    held.add(b)
                n_claimed += 1
                yield (b, *batches[b])

        if coordinate:
            skipped.extend(sorted(done))
            if materialize:
                for b in skipped:
                    host_blocks[b] = writer.read_batch_dense(b)
            work_iter: Iterable[tuple[int, int, int]] = leased_batches()
        else:
            to_solve: list[tuple[int, int, int]] = []
            for b, (start, stop) in enumerate(batches):   # paper's step 3
                if b in done:
                    skipped.append(b)
                    if materialize:
                        host_blocks[b] = writer.read_batch_dense(b)
                    continue
                if max_batches is not None and len(to_solve) >= max_batches:
                    break
                to_solve.append((b, start, stop))
            work_iter = to_solve

        hb_stop = threading.Event()
        hb_thread = None
        if coordinate:
            def _heartbeat():
                interval = max(0.05, self.lease_ttl / 4.0)
                while not hb_stop.wait(interval):
                    with held_lock:
                        current = sorted(held)
                    try:
                        writer.heartbeat(worker_id, current)
                    except OSError:       # transient fs hiccup: next tick
                        pass
            hb_thread = threading.Thread(target=_heartbeat, daemon=True,
                                         name="xmc-lease-heartbeat")
            hb_thread.start()

        try:
            if not self.overlap:
                for item in work_iter:
                    drain(dispatch(*item))
            else:
                # A slot is taken before a batch is claimed and dispatched
                # and given back once it is written, so at most
                # max_inflight solved batches (and held leases) wait on the
                # single writer, which drains them in dispatch order.
                slots = threading.Semaphore(max(1, self.max_inflight))
                inflight: queue.Queue = queue.Queue()

                def _drain_loop():
                    while True:
                        item = inflight.get()
                        if item is None:
                            return
                        try:
                            if not failed:
                                drain(item)
                        except BaseException as e:   # to the main loop
                            failed.append(e)
                        finally:
                            slots.release()

                it = iter(work_iter)
                t = threading.Thread(target=_drain_loop, daemon=True,
                                     name="xmc-checkpoint-writer")
                t.start()
                try:
                    while True:
                        with obs.span("train.slot_wait"):
                            slots.acquire()
                        if failed:
                            slots.release()
                            break
                        item = next(it, None)
                        if item is None:
                            slots.release()
                            break
                        inflight.put(dispatch(*item))
                finally:
                    inflight.put(None)
                    t.join()
                if failed:
                    raise failed[0]
        finally:
            if coordinate:
                hb_stop.set()
                hb_thread.join()
                with held_lock:
                    leftover = sorted(held)
                writer.release_leases(worker_id, leftover)

        if coordinate:
            manifest = writer.try_finalize()
            complete = manifest is not None
            if materialize and complete:
                for b in range(len(batches)):     # co-workers' batches
                    if b not in host_blocks:
                        host_blocks[b] = writer.read_batch_dense(b)
        else:
            complete = len(solved) + len(skipped) == len(batches)
            manifest = writer.finalize() if (writer and complete) else None
        model = None
        if materialize and complete:
            with obs.span("train.materialize") as sp:
                W = np.concatenate([host_blocks[b]
                                    for b in range(len(batches))])
                sp.set(bytes=W.nbytes)
                model = DiSMECModel(W=torch.from_numpy(W).to(device),
                                    delta=self.cfg.delta, n_labels=L)
        return XMCTrainResult(model=model, out_dir=out_dir,
                              n_batches=len(batches), solved=solved,
                              skipped=skipped, complete=complete,
                              manifest=manifest)


def train_streaming(X, Y, cfg: DiSMECConfig, out_dir: str,
                    **job_kwargs) -> XMCTrainResult:
    """DEPRECATED shim: stream-train into a servable multi-shard
    checkpoint. Use `repro_torch.xmc_api.fit(X, Y, spec, out_dir)`; this
    drives the same engine, so the checkpoints are bit-identical."""
    import warnings
    warnings.warn(
        "train_streaming is deprecated; build an XMCSpec and call "
        "repro_torch.xmc_api.fit(X, Y, spec, out_dir) instead",
        DeprecationWarning, stacklevel=2)
    run_kwargs = {k: job_kwargs.pop(k)
                  for k in ("resume", "materialize", "max_batches", "meta",
                            "on_batch", "init_from", "device")
                  if k in job_kwargs}
    return XMCTrainJob(cfg=cfg, **job_kwargs).run(X, Y, out_dir,
                                                  **run_kwargs)


def train_demo_checkpoint(ckpt_dir: str, *, n_train: int = 800,
                          n_test: int = 512, n_features: int = 4096,
                          n_labels: int = 256, label_batch: int = 128,
                          block_shape: tuple[int, int] = (128, 128),
                          data_kwargs: dict | None = None,
                          C: float = 1.0, delta: float = 0.01,
                          seed: int = 0, reuse: bool = True,
                          verbose: bool = True, device=None):
    """Train-and-checkpoint a small DiSMEC model for demos, on `device`
    (None: the card).

    The shared setup behind `launch/serve.py --xmc`: builds the synthetic
    dataset (the JAX generator's, bit for bit), fits a model into
    `ckpt_dir` (unless a servable checkpoint is already there and
    `reuse`), and returns `(dataset, index)` where `index` is the
    checkpoint's metadata (`checkpoint.io.load_block_sparse_meta`).
    `data_kwargs` forwards extra knobs to `make_xmc_dataset`.
    """
    from repro_torch.data.xmc import make_xmc_dataset
    data = make_xmc_dataset(n_train=n_train, n_test=n_test,
                            n_features=n_features, n_labels=n_labels,
                            seed=seed, **(data_kwargs or {}))
    if not (reuse and has_block_sparse_checkpoint(ckpt_dir)):
        if verbose:
            print(f"[xmc] no servable checkpoint at {ckpt_dir}; streaming a "
                  f"{n_labels}-label model in batches of {label_batch}...")
        from repro_torch.xmc_api import XMCSpec, fit      # deferred: no cycle
        spec = XMCSpec(solver=SolverSpec(C=C, delta=delta),
                       schedule=ScheduleSpec(label_batch=label_batch,
                                             block_shape=tuple(block_shape)))
        fit(data.X_train, data.Y_train, spec, ckpt_dir, device=device)
        if verbose:
            index = load_block_sparse_meta(ckpt_dir)
            print(f"[xmc] saved sparse checkpoint: {index['n_blocks']} "
                  "blocks across "
                  f"{len(index['manifest']['shards'])} shards")
    return data, load_block_sparse_meta(ckpt_dir)
