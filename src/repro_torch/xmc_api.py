"""One declarative XMC API: spec-driven fit -> checkpoint -> serve.

    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, CheckpointHandle, fit

    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, ops="pallas"),
                   schedule=ScheduleSpec(label_batch=1024),
                   serve=ServeSpec(backend="bsr", k=5))
    handle = fit(X, Y, spec, "/ckpts/wiki10-31k")    # trains on the card
    engine = handle.engine()                         # serves as spec says
    results = engine.serve(requests)
    server = handle.server()                         # the async path
    result = server.submit(x).result()

    handle = CheckpointHandle.open("/ckpts/wiki10-31k")   # from disk alone

`XMCSpec` is the JAX package's frozen, JSON-round-trippable experiment
description, field for field, so a spec embedded in a checkpoint manifest
by either package reads back in the other. `fit(..., init_from=dir)`
warm-starts every label batch from a prior checkpoint's rows. Entry points
run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy
from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
from repro_torch.specs.base import Spec


@dataclasses.dataclass(frozen=True)
class XMCSpec(Spec):
    """The whole experiment as one frozen, serializable value.

    solver   — what is solved per label (C, Delta, eps, ops kind).
    schedule — how the label space is walked and sharded.
    serve    — how the resulting checkpoint is served (backend kind, k,
               buckets).
    """
    solver: SolverSpec = SolverSpec()
    schedule: ScheduleSpec = ScheduleSpec()
    serve: ServeSpec = ServeSpec()

    def validate(self) -> "XMCSpec":
        self.solver.validate()
        self.schedule.validate()
        self.serve.validate()
        return self

    def normalized(self) -> "XMCSpec":
        """Validated spec with the schedule's label_batch rounded up to a
        BSR-block multiple (warns when it changes)."""
        self.validate()
        schedule = self.schedule.normalized()
        return self if schedule is self.schedule else dataclasses.replace(
            self, schedule=schedule)

    def canonical(self) -> "XMCSpec":
        """The manifest-stored form: runtime scheduling knobs reset to
        their defaults."""
        return dataclasses.replace(self, schedule=self.schedule.canonical())


def spec_from_config(cfg, *, label_axis: str = "model",
                     data_axis: str = "data", shard_data: bool = False,
                     balance: bool = False,
                     serve: Optional[ServeSpec] = None) -> XMCSpec:
    """Adapter: a `DiSMECConfig` (+ sharding kwargs) as an XMCSpec."""
    return XMCSpec(
        solver=SolverSpec.from_config(cfg),
        schedule=ScheduleSpec(label_batch=cfg.label_batch,
                              label_axis=label_axis, data_axis=data_axis,
                              shard_data=shard_data, balance=balance),
        serve=serve or ServeSpec())


def job_from_spec(spec: XMCSpec, *, mesh=None):
    """The streaming training engine (`XMCTrainJob`) a spec names. `mesh`
    (a `launch.mesh.Mesh`) overrides the schedule's declarative mesh with
    an existing grid of devices; otherwise the mesh is built from
    `spec.schedule.mesh` (over the distinct cards, raising when there are
    fewer)."""
    from repro_torch.train.xmc import XMCTrainJob
    sch = spec.schedule
    return XMCTrainJob(
        cfg=spec.solver.to_config(label_batch=sch.label_batch),
        mesh=mesh if mesh is not None else sch.make_mesh(),
        label_axis=sch.label_axis, data_axis=sch.data_axis,
        shard_data=sch.shard_data, balance=sch.balance,
        block_shape=tuple(sch.block_shape), overlap=sch.overlap,
        max_inflight=sch.max_inflight, workers=sch.workers,
        lease_ttl=sch.lease_ttl)


def fit(X, Y, spec: XMCSpec, out_dir: str, *,
        init_from: Optional[str] = None, resume: bool = True,
        max_batches: Optional[int] = None, meta: Optional[dict] = None,
        on_batch: Optional[Callable[[int, int], None]] = None,
        worker: Optional[str] = None, device=None,
        mesh=None) -> "CheckpointHandle":
    """Train X (N, D), Y (N, L) (numpy arrays or tensors) under `spec`
    into a servable sparse checkpoint at `out_dir`, on `device` (None: the
    card; "cpu" runs the plain solver ops), and return its handle.

    mesh : a `launch.mesh.Mesh` to shard each label batch's solve over
           (`job_from_spec(spec, mesh=)`): it overrides the schedule's
           mesh, whose shape the manifest then records. `device` defaults
           to the mesh's first device, where the model is gathered.

    The spec is normalized first (label_batch rounded up to a BSR-block
    multiple, with a warning), embedded in the manifest and enforced on
    resume: a second `fit` into the same directory with another
    solver/schedule spec, other data or another implementation (card or
    CPU, this package or the JAX one) raises.

    init_from : prior checkpoint directory; every label batch's TRON starts
                from its rows. A converged checkpoint of the same spec is a
                fixed point: the warm fit reproduces it bit for bit.
    resume / max_batches / on_batch / worker : as `XMCTrainJob.run`.

    Two spec knobs act at fit time beyond the solve itself, as in the JAX
    package: `schedule.reorder_labels` packs the label space under the
    co-occurrence permutation (trained as `Y[:, order]`, recorded in the
    manifest, unmapped at serve time), and `serve.shortlist_kind` other
    than "centroid" replaces the finalize-time centroid shortlist with a
    learned one-vs-rest classifier (solved on `device`) or a routing tree
    built from the run's own data.
    """
    spec = spec.normalized()
    if mesh is not None:
        sch = spec.schedule
        spec = dataclasses.replace(spec, schedule=dataclasses.replace(
            sch, mesh=(mesh.shape[sch.data_axis],
                       mesh.shape[sch.label_axis])))
        device = mesh.first if device is None else device
    device = resolve_device(device)
    label_order = None
    if spec.schedule.reorder_labels:
        from repro_torch.serve.shortlist import cooccurrence_label_order
        label_order = cooccurrence_label_order(
            to_numpy(Y), block_rows=int(spec.schedule.block_shape[0]))
    res = job_from_spec(spec, mesh=mesh).run(
        X, Y, out_dir, resume=resume, init_from=init_from,
        max_batches=max_batches, on_batch=on_batch, worker=worker,
        device=device, label_order=label_order,
        meta={**(meta or {}), "xmc_spec": spec.canonical().to_dict()})
    if res.complete and spec.serve.shortlist_kind != "centroid":
        _upgrade_coarse_stage(out_dir, spec, X, Y, label_order, device)
    return CheckpointHandle(directory=out_dir, spec=spec, device=device,
                            result=res)


def _upgrade_coarse_stage(out_dir: str, spec: XMCSpec, X, Y, label_order,
                          device: torch.device) -> None:
    """Swap the finalize-time centroid shortlist for the coarse artifact
    `spec.serve.shortlist_kind` names, trained from the run's own data
    with Y in packed label order (the writer's finalize, which any worker
    may win, knows nothing of X and Y)."""
    from repro_torch.checkpoint.io import load_block_sparse, upgrade_shortlist
    from repro_torch.serve.shortlist import (build_learned_shortlist,
                                             build_tree_shortlist)
    model, _ = load_block_sparse(out_dir, device=device)
    Yn = to_numpy(Y)
    if label_order is not None:
        Yn = Yn[:, np.asarray(label_order)]
    build = (build_learned_shortlist
             if spec.serve.shortlist_kind == "learned"
             else build_tree_shortlist)
    upgrade_shortlist(out_dir, build(model, X, Yn))


def _spec_from_index(index: dict) -> XMCSpec:
    """Recover the spec from a checkpoint's index/manifest: the embedded
    `xmc_spec` when present, else a best-effort rebuild from the legacy
    fingerprint keys, else defaults."""
    meta = index.get("meta", {})
    if "xmc_spec" in meta:
        return XMCSpec.from_dict(meta["xmc_spec"])
    manifest = index.get("manifest")
    solver = dict(manifest.get("solver", {})) if manifest else {}
    if "spec" in solver:                     # spec fingerprint, no meta copy
        return XMCSpec(
            solver=SolverSpec.from_dict(solver["spec"]["solver"]),
            schedule=ScheduleSpec.from_dict(solver["spec"]["schedule"]))
    solver_kw = {k: solver[k] for k in
                 ("C", "delta", "eps", "max_newton", "max_cg")
                 if k in solver}
    if solver.get("use_pallas"):
        solver_kw["ops"] = "pallas"
        solver_kw["pallas_interpret"] = solver.get("pallas_interpret")
    mesh = solver.get("mesh")
    schedule_kw: dict = {}
    if manifest is not None:
        schedule_kw["label_batch"] = manifest["label_batch"]
        schedule_kw["block_shape"] = tuple(manifest["block_shape"])
    if mesh:
        schedule_kw["mesh"] = (int(mesh.get("data", 1)),
                               int(mesh.get("model", 1)))
    for k in ("shard_data", "balance"):
        if k in solver:
            schedule_kw[k] = solver[k]
    return XMCSpec(solver=SolverSpec(**solver_kw),
                   schedule=ScheduleSpec(**schedule_kw))


@dataclasses.dataclass
class CheckpointHandle:
    """A servable sparse checkpoint, the spec that produced it, and the
    device it serves on.

    Returned by `fit` (with the run's `XMCTrainResult` as `result`);
    `open` re-creates it from disk alone (the spec travels inside the
    manifest). `engine()` turns it into a serving `XMCEngine` exactly as
    `spec.serve` describes, `server()` into the async `XMCServer` around
    one; `model()` loads the packed BSR artifact.
    """
    directory: str
    spec: XMCSpec
    device: torch.device
    result: Optional[object] = None          # XMCTrainResult when from fit()
    allow_incomplete: bool = False           # opened for inspection only

    @classmethod
    def open(cls, directory: str, *, allow_incomplete: bool = False,
             device=None) -> "CheckpointHandle":
        """Re-open a checkpoint, recovering its spec from the manifest.

        `device` None means the card, and raises when none is present;
        pass device="cpu" to serve on the CPU. A still-streaming directory
        raises unless `allow_incomplete=True`, which allows `index()` and
        `model()` over the solved prefix; `engine()` still requires a
        finished checkpoint.
        """
        from repro_torch.checkpoint.io import load_block_sparse_meta
        device = resolve_device(device)
        index = load_block_sparse_meta(directory,
                                       allow_incomplete=allow_incomplete)
        return cls(directory=directory, spec=_spec_from_index(index),
                   device=device, allow_incomplete=allow_incomplete)

    # -- introspection ----------------------------------------------------

    @property
    def complete(self) -> bool:
        from repro_torch.checkpoint.io import has_block_sparse_checkpoint
        return has_block_sparse_checkpoint(self.directory)

    @property
    def generation(self) -> Optional[int]:
        """Generation counter of the servable checkpoint (None while the
        stream is still being written)."""
        from repro_torch.checkpoint.io import checkpoint_generation
        return checkpoint_generation(self.directory)

    def index(self) -> dict:
        """Metadata (shapes, block counts, user meta) without the arrays."""
        from repro_torch.checkpoint.io import load_block_sparse_meta
        return load_block_sparse_meta(
            self.directory, allow_incomplete=self.allow_incomplete)

    def model(self):
        """Load the packed `BlockSparseModel` (+ meta dict) on the handle's
        device."""
        from repro_torch.checkpoint.io import load_block_sparse
        return load_block_sparse(self.directory,
                                 allow_incomplete=self.allow_incomplete,
                                 device=self.device)

    # -- serving ----------------------------------------------------------

    def engine(self, serve_override: Optional[ServeSpec] = None, *,
               mesh=None):
        """Build the serving engine this checkpoint's spec describes;
        `serve_override` replaces the whole `ServeSpec` for this session,
        and `mesh` supplies a grid of devices to mesh-sharded backends.
        `ServeSpec.interpret` has no meaning here and is ignored."""
        from repro_torch.serve.xmc import XMCEngine
        serve = (serve_override or self.spec.serve).validate()
        return XMCEngine.from_checkpoint(
            self.directory, backend=serve.backend, k=serve.k, mesh=mesh,
            buckets=tuple(serve.buckets), warmup=serve.warmup,
            device=self.device, shortlist_blocks=serve.shortlist_blocks,
            int8=serve.int8, shortlist_per_query=serve.shortlist_per_query)

    def server(self, serve_override: Optional[ServeSpec] = None, *,
               mesh=None, name: Optional[str] = None, start: bool = True):
        """Build the async continuous-batching server this checkpoint's
        spec describes (`serve.server.XMCServer`) on the handle's device:
        `submit` returns futures, buckets launch on fill or
        `ServeSpec.max_batch_delay_ms`, and `ServeSpec.max_queue`
        admission control sheds overload with `Rejected` results. Several
        handles' servers compose into one process through
        `serve.server.ModelRouter`. The synchronous `engine()` path is
        unchanged."""
        from repro_torch.serve.server import XMCServer
        serve = (serve_override or self.spec.serve).validate()
        return XMCServer(self.engine(serve, mesh=mesh),
                         max_batch_delay_ms=serve.max_batch_delay_ms,
                         max_queue=serve.max_queue, name=name, start=start)
