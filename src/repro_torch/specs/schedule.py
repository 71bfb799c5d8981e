"""ScheduleSpec: how the label space is walked and laid out on hardware.

The same fields, validation, normalization, canonical form and resume
fingerprint as the JAX package's `ScheduleSpec`. A mesh (several GPUs)
is not ported yet: `make_mesh` raises for one (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.specs.base import Spec


@dataclasses.dataclass(frozen=True)
class ScheduleSpec(Spec):
    """Label-batch scheduling + mesh layout of one training run.

    label_batch  : paper's per-node batch size (layer 1); `normalized()`
                   rounds it up to a multiple of the BSR block height.
    block_shape  : (bl, bd) BSR tile of the streamed checkpoint.
    mesh         : None for single-device, else (data_size, model_size).
    label_axis / data_axis : mesh axis names.
    shard_data   : also shard instances over the data axis.
    balance      : frequency-balanced label->shard dealing per batch.
    overlap / max_inflight : double-buffering of the training scheduler.
    workers / lease_ttl : cooperative multi-host drain.
    reorder_labels : pack the label space under a co-occurrence
                   permutation recorded in the manifest as `label_order`;
                   serving maps top-k ids back through it.
    """
    label_batch: int = 1024
    block_shape: tuple[int, int] = (128, 128)
    mesh: Optional[tuple[int, int]] = None
    label_axis: str = "model"
    data_axis: str = "data"
    shard_data: bool = False
    balance: bool = False
    overlap: bool = True
    max_inflight: int = 2
    workers: int = 1
    lease_ttl: float = 300.0
    reorder_labels: bool = False

    def validate(self) -> "ScheduleSpec":
        if self.label_batch < 1:
            raise ValueError(f"label_batch must be >= 1, got "
                             f"{self.label_batch}")
        if any(b < 1 for b in self.block_shape):
            raise ValueError(f"block_shape must be positive, got "
                             f"{self.block_shape}")
        if self.mesh is not None and any(int(s) < 1 for s in self.mesh):
            raise ValueError(f"mesh axis sizes must be >= 1, got {self.mesh}")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{self.max_inflight}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.lease_ttl <= 0.0:
            raise ValueError(f"lease_ttl must be positive, got "
                             f"{self.lease_ttl}")
        return self

    def normalized(self) -> "ScheduleSpec":
        """Round `label_batch` up to a multiple of the BSR block height
        (with a warning): streamed shards must be row-block-aligned."""
        self.validate()
        bl = self.block_shape[0]
        if self.label_batch % bl == 0:
            return self
        rounded = -(-self.label_batch // bl) * bl
        warnings.warn(
            f"label_batch={self.label_batch} is not a multiple of the BSR "
            f"block height {bl}; rounding up to {rounded} so streamed "
            "shards stay block-aligned", UserWarning, stacklevel=2)
        return dataclasses.replace(self, label_batch=rounded)

    def make_mesh(self):
        """The device mesh this spec names: None when unsharded. A mesh
        over several GPUs is not ported yet."""
        if self.mesh is None:
            return None
        raise NotImplementedError(
            f"ScheduleSpec(mesh={self.mesh}): sharding over several GPUs is "
            "not ported yet; see ROADMAP Queue A item 6 (multi-GPU)")

    @classmethod
    def from_job(cls, job) -> "ScheduleSpec":
        """Duck-typed: the spec of an `XMCTrainJob`'s fields (`job.mesh` is
        None or a (data, model) shape)."""
        mesh = None if job.mesh is None else tuple(int(s) for s in job.mesh)
        return cls(label_batch=job.cfg.label_batch,
                   block_shape=tuple(job.block_shape), mesh=mesh,
                   label_axis=job.label_axis, data_axis=job.data_axis,
                   shard_data=job.shard_data, balance=job.balance,
                   overlap=job.overlap, max_inflight=job.max_inflight,
                   workers=job.workers, lease_ttl=job.lease_ttl)

    # Runtime knobs that never change the solved checkpoint (any buffering
    # and any worker count write the same bytes): excluded from the resume
    # fingerprint and reset to their defaults in the manifest-stored form.
    RUNTIME_FIELDS = ("overlap", "max_inflight", "workers", "lease_ttl")

    def canonical(self) -> "ScheduleSpec":
        """This schedule with the runtime knobs reset to their defaults —
        the form embedded in checkpoint manifests."""
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        return dataclasses.replace(
            self, **{k: defaults[k] for k in self.RUNTIME_FIELDS})

    def fingerprint(self) -> dict:
        """Resume-identity subset: everything that can change the solved
        weights or the shard layout (not RUNTIME_FIELDS). A False
        `reorder_labels` is dropped, as the JAX package drops it, so the
        two packages' fingerprints agree."""
        d = self.to_dict()
        for k in self.RUNTIME_FIELDS:
            d.pop(k)
        if not d.get("reorder_labels"):
            d.pop("reorder_labels", None)
        return d
