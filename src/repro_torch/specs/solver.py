"""SolverSpec: everything that determines the per-label TRON solution.

The same fields and validation as the JAX package's `SolverSpec`, so a
checkpoint manifest's embedded spec reads back here unchanged. `ops` names
an entry of the solver-ops registry (`repro_torch.core.dismec`): "jnp" the
plain ops on `torch.matmul`, "pallas" the hand-written CUDA kernels (their
plain versions on the CPU). The kinds keep the JAX package's names, so a
spec means the same thing in both packages.
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
    package's Pallas mode, which the port has no use for and keeps for
    manifest round-trips.
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

    # -- adapters to/from the core config --------------------------------

    @classmethod
    def from_config(cls, cfg) -> "SolverSpec":
        """Duck-typed: reads the `DiSMECConfig` attribute names."""
        ops = getattr(cfg, "ops", None) or (
            SOLVER_OPS_PALLAS if cfg.use_pallas else SOLVER_OPS_JNP)
        return cls(C=cfg.C, delta=cfg.delta, eps=cfg.eps,
                   max_newton=cfg.max_newton, max_cg=cfg.max_cg,
                   ops=ops, pallas_interpret=cfg.pallas_interpret)

    def to_config(self, *, label_batch: int):
        """The `repro_torch.core.dismec.DiSMECConfig` this spec describes
        (deferred import: specs stay importable without torch)."""
        from repro_torch.core.dismec import DiSMECConfig
        return DiSMECConfig(
            C=self.C, delta=self.delta, eps=self.eps,
            max_newton=self.max_newton, max_cg=self.max_cg,
            label_batch=label_batch,
            use_pallas=self.ops == SOLVER_OPS_PALLAS,
            pallas_interpret=self.pallas_interpret, ops=self.ops)

    def fingerprint(self) -> dict:
        """The manifest-resume identity of this solver, with the JAX
        package's keys so both packages parse each other's manifests.
        `pallas_interpret` is None: the port has no Pallas mode. Which
        implementation solved the shards (the card's kernels or the CPU's
        plain versions) is the writer's sibling `impl` key, so shards of
        different implementations are never stitched together."""
        d = self.to_dict()
        d["pallas_interpret"] = None
        return d
