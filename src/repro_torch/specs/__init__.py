"""Sub-specs of the declarative XMC experiment description.

`SolverSpec`, `ScheduleSpec` and `ServeSpec` compose into
`repro_torch.xmc_api.XMCSpec`, the frozen, JSON-round-trippable object that
rides inside every BSR checkpoint manifest; `SweepPolicy` picks a sweep's
winner (`repro_torch.lifecycle.sweep`). A leaf package: importable
without torch.
"""

from repro_torch.specs.base import Spec
from repro_torch.specs.schedule import ScheduleSpec
from repro_torch.specs.serve import DEFAULT_BUCKETS, ServeSpec
from repro_torch.specs.solver import (SOLVER_OPS_JNP, SOLVER_OPS_PALLAS,
                                      SolverSpec)
from repro_torch.specs.sweep import (SWEEP_POLICIES, SweepPolicy,
                                     register_sweep_policy)

__all__ = ["Spec", "SolverSpec", "ScheduleSpec", "ServeSpec",
           "DEFAULT_BUCKETS", "SOLVER_OPS_JNP", "SOLVER_OPS_PALLAS",
           "SweepPolicy", "SWEEP_POLICIES", "register_sweep_policy"]
