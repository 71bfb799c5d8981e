"""Model lifecycle: sweep sessions and serving refresh with no dropped requests.

The layer between training and serving that a deployment actually runs:

  sweep.py    — `sweep()`: DiSMEC's Fig. 5 Delta/C sweep as a warm-start
                session (base fit, arms fanned out across workers, per-arm
                size/precision report, declarative winner policy).
  refresh.py  — `CheckpointWatcher`: poll a checkpoint directory's
                generation counter and hot-swap a live `XMCServer` when a
                newer finalized model lands; rollback via the server's
                retained `previous_engine`.

`ModelRouter.refresh` / `.watch` (repro_torch.serve.server) and
`launch/serve.py --watch` are the serving-side entry points; the
generation counter itself lives in `repro_torch.checkpoint.io`.
"""

from repro_torch.lifecycle.refresh import CheckpointWatcher
from repro_torch.lifecycle.sweep import (SweepArm, SweepReport,
                                         models_bit_identical, sweep)

__all__ = ["CheckpointWatcher", "SweepArm", "SweepReport",
           "models_bit_identical", "sweep"]
