"""SolverSpec: everything that determines the per-label TRON solution.

The same fields and validation as the JAX package's `SolverSpec`, so a
checkpoint manifest's embedded spec reads back here unchanged. The
manifest-resume identity (`fingerprint`) and the adapters to a solver
config belong to the training half of the port and are not here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.specs.base import Spec

#: Built-in solver-ops kinds of the JAX package (names kept for manifests).
SOLVER_OPS_JNP = "jnp"
SOLVER_OPS_PALLAS = "pallas"


@dataclasses.dataclass(frozen=True)
class SolverSpec(Spec):
    """Hyper-parameters of one per-label binary solve (paper Eq. 2.2).

    C / delta / eps / max_newton / max_cg are Algorithm 1's knobs; `ops`
    names the solver-ops implementation and `pallas_interpret` the JAX
    package's Pallas mode. Both ride along for manifest round-trips.
    """
    C: float = 1.0
    delta: float = 0.01
    eps: float = 0.01
    max_newton: int = 50
    max_cg: int = 40
    ops: str = SOLVER_OPS_JNP
    pallas_interpret: Optional[bool] = None

    def validate(self) -> "SolverSpec":
        if self.C <= 0.0:
            raise ValueError(f"C must be positive, got {self.C}")
        if self.delta < 0.0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        if self.eps <= 0.0:
            raise ValueError(f"eps must be positive, got {self.eps}")
        if self.max_newton < 1 or self.max_cg < 1:
            raise ValueError("max_newton and max_cg must be >= 1")
        return self
