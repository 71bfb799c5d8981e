"""One declarative XMC API, serving half: checkpoint -> spec -> engine.

    from repro_torch.xmc_api import CheckpointHandle
    handle = CheckpointHandle.open("/ckpts/wiki10-31k")   # on the card
    engine = handle.engine()                              # as the spec says
    results = engine.serve(requests)

`XMCSpec` is the JAX package's frozen, JSON-round-trippable experiment
description, field for field, so the spec embedded in a checkpoint manifest
by the JAX package's `fit` reads back here. `fit` and warm starts belong to
the training half of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    `open` re-creates it from disk alone (the spec travels inside the
    manifest). `engine()` turns it into a serving `XMCEngine` exactly as
    `spec.serve` describes; `model()` loads the packed BSR artifact.
    """
    directory: str
    spec: XMCSpec
    device: torch.device
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
