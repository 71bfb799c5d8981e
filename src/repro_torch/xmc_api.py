"""One declarative XMC API: spec-driven fit -> checkpoint -> serve.

    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import XMCSpec, CheckpointHandle, fit

    spec = XMCSpec(solver=SolverSpec(C=1.0, delta=0.01, ops="pallas"),
                   schedule=ScheduleSpec(label_batch=1024),
                   serve=ServeSpec(backend="bsr", k=5))
    handle = fit(X, Y, spec, "/ckpts/wiki10-31k")    # trains on the card
    engine = handle.engine()                         # serves as spec says
    results = engine.serve(requests)

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

import torch

from repro_torch.device import resolve_device
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


def job_from_spec(spec: XMCSpec):
    """The streaming training engine (`XMCTrainJob`) a spec names. A
    schedule with a mesh raises: several GPUs are not ported yet."""
    from repro_torch.train.xmc import XMCTrainJob
    sch = spec.schedule
    sch.make_mesh()                      # raises for a mesh
    return XMCTrainJob(
        cfg=spec.solver.to_config(label_batch=sch.label_batch),
        mesh=None, label_axis=sch.label_axis, data_axis=sch.data_axis,
        shard_data=sch.shard_data, balance=sch.balance,
        block_shape=tuple(sch.block_shape), overlap=sch.overlap,
        max_inflight=sch.max_inflight, workers=sch.workers,
        lease_ttl=sch.lease_ttl)


def fit(X, Y, spec: XMCSpec, out_dir: str, *,
        init_from: Optional[str] = None, resume: bool = True,
        max_batches: Optional[int] = None, meta: Optional[dict] = None,
        on_batch: Optional[Callable[[int, int], None]] = None,
        worker: Optional[str] = None, device=None) -> "CheckpointHandle":
    """Train X (N, D), Y (N, L) (numpy arrays or tensors) under `spec`
    into a servable sparse checkpoint at `out_dir`, on `device` (None: the
    card; "cpu" runs the plain solver ops), and return its handle.

    The spec is normalized first (label_batch rounded up to a BSR-block
    multiple, with a warning), embedded in the manifest and enforced on
    resume: a second `fit` into the same directory with another
    solver/schedule spec, other data or another implementation (card or
    CPU, this package or the JAX one) raises.

    init_from : prior checkpoint directory; every label batch's TRON starts
                from its rows. A converged checkpoint of the same spec is a
                fixed point: the warm fit reproduces it bit for bit.
    resume / max_batches / on_batch / worker : as `XMCTrainJob.run`.

    A `reorder_labels` schedule or a non-centroid `shortlist_kind` raises
    NotImplementedError: the label reordering and the learned/tree coarse
    stages are not ported yet (ROADMAP Queue A item 4).
    """
    spec = spec.normalized()
    if spec.schedule.reorder_labels or spec.serve.shortlist_kind != \
            "centroid":
        raise NotImplementedError(
            "fit: reorder_labels and the learned/tree shortlists are not "
            "ported yet; see ROADMAP Queue A item 4 (shortlist)")
    device = resolve_device(device)
    res = job_from_spec(spec).run(
        X, Y, out_dir, resume=resume, init_from=init_from,
        max_batches=max_batches, on_batch=on_batch, worker=worker,
        device=device,
        meta={**(meta or {}), "xmc_spec": spec.canonical().to_dict()})
    return CheckpointHandle(directory=out_dir, spec=spec, device=device,
                            result=res)


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
    `spec.serve` describes; `model()` loads the packed BSR artifact.
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

    def engine(self, serve_override: Optional[ServeSpec] = None):
        """Build the serving engine this checkpoint's spec describes;
        `serve_override` replaces the whole `ServeSpec` for this session.
        `ServeSpec.interpret` has no meaning here and is ignored."""
        from repro_torch.serve.xmc import XMCEngine
        serve = (serve_override or self.spec.serve).validate()
        if serve.int8:
            raise ValueError("int8 serving is not ported yet; serve the fp32 "
                             "blocks with ServeSpec(int8=False)")
        return XMCEngine.from_checkpoint(
            self.directory, backend=serve.backend, k=serve.k,
            buckets=tuple(serve.buckets), warmup=serve.warmup,
            device=self.device)
