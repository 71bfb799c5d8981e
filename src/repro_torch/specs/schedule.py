"""ScheduleSpec: how the label space is walked and laid out on hardware.

The same fields, validation, normalization and canonical form as the JAX
package's `ScheduleSpec`. Building a device mesh from it is not here: the
multi-GPU half of the port owns that.
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

    # Runtime knobs that never change the solved checkpoint; reset to their
    # defaults in the manifest-stored form.
    RUNTIME_FIELDS = ("overlap", "max_inflight", "workers", "lease_ttl")

    def canonical(self) -> "ScheduleSpec":
        """This schedule with the runtime knobs reset to their defaults —
        the form embedded in checkpoint manifests."""
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        return dataclasses.replace(
            self, **{k: defaults[k] for k in self.RUNTIME_FIELDS})
