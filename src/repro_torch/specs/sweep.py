"""SweepPolicy: declarative winner selection for Delta/C sweep sessions.

DiSMEC's Fig. 5 is a frontier — model size against precision@k as the
capacity-control threshold Delta (and C) move. Picking the deployed point
on that frontier is an operational decision, so it is a *spec*, not code:
`SweepPolicy` is frozen and JSON-round-trippable like every other spec,
rides in sweep reports, and selects over arm records by a registered rule.

Arms are anything with `.name`, `.model_mb`, `.int8_mb`, and `.metrics`
(a `{"P@1": ..., "P@3": ...}` dict) — `lifecycle.sweep.SweepArm` in
practice. The registry is open like the predict-backend registry: plug in
a new rule with `@register_sweep_policy("kind")`.

Like the rest of `repro_torch.specs`, this module imports no torch: a
copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.specs.base import Spec

#: kind -> selector(policy, arms) -> winning arm. Selectors may assume
#: `arms` is non-empty and `policy.validate()` passed.
SWEEP_POLICIES: dict[str, Callable] = {}


def register_sweep_policy(kind: str):
    """Register a winner-selection rule under `SweepPolicy(kind=...)`."""
    def wrap(fn: Callable) -> Callable:
        SWEEP_POLICIES[kind] = fn
        return fn
    return wrap


@dataclasses.dataclass(frozen=True)
class SweepPolicy(Spec):
    """One declarative winner-selection rule over sweep arms.

    kind   : registry entry (see `SWEEP_POLICIES`):
             "min_size" — smallest model, metrics ignored (the only
               meaningful rule when a sweep ran without a holdout);
             "max_precision" — highest `metric`, ties to the smaller model;
             "max_precision_under_size_mb" — highest `metric` among arms
               whose size fits `size_mb`; when nothing fits, the smallest
               model wins (the budget is a hard deployment constraint, so
               the closest-to-feasible arm is the only honest answer);
             "min_size_at_precision" — smallest model whose `metric` is
               >= `precision_floor`; when nothing reaches the floor, the
               most precise arm wins.
    metric : which `metrics` column drives precision comparisons ("P@1" /
             "P@3" / "P@5" ...).
    size_mb : model-size budget for "max_precision_under_size_mb".
    precision_floor : precision floor for "min_size_at_precision".
    int8   : judge size by the int8 serving payload (`int8_mb`) instead of
             the fp32 (value, index) size (`model_mb`).
    """
    kind: str = "max_precision"
    metric: str = "P@5"
    size_mb: Optional[float] = None
    precision_floor: Optional[float] = None
    int8: bool = False

    def validate(self) -> "SweepPolicy":
        if self.kind not in SWEEP_POLICIES:
            raise ValueError(f"unknown sweep policy kind {self.kind!r}; "
                             f"registered: {sorted(SWEEP_POLICIES)}")
        if self.kind == "max_precision_under_size_mb" and (
                self.size_mb is None or self.size_mb <= 0):
            raise ValueError("max_precision_under_size_mb needs a positive "
                             f"size_mb budget, got {self.size_mb}")
        if self.kind == "min_size_at_precision" and \
                self.precision_floor is None:
            raise ValueError("min_size_at_precision needs a "
                             "precision_floor")
        return self

    # -- selection --------------------------------------------------------

    def size_of(self, arm) -> float:
        return float(arm.int8_mb if self.int8 else arm.model_mb)

    def metric_of(self, arm) -> float:
        try:
            return float(arm.metrics[self.metric])
        except KeyError:
            raise ValueError(
                f"arm {arm.name!r} has no metric {self.metric!r}; "
                f"available: {sorted(arm.metrics)}") from None

    def select(self, arms):
        """The winning arm under this policy (`validate`d first)."""
        arms = list(arms)
        if not arms:
            raise ValueError("cannot select a winner from zero arms")
        return SWEEP_POLICIES[self.validate().kind](self, arms)


@register_sweep_policy("min_size")
def _min_size(policy: SweepPolicy, arms):
    return min(arms, key=policy.size_of)


@register_sweep_policy("max_precision")
def _max_precision(policy: SweepPolicy, arms):
    # Ties go to the smaller model: same precision, cheaper to serve.
    return max(arms, key=lambda a: (policy.metric_of(a),
                                    -policy.size_of(a)))


@register_sweep_policy("max_precision_under_size_mb")
def _max_precision_under_size(policy: SweepPolicy, arms):
    fits = [a for a in arms if policy.size_of(a) <= policy.size_mb]
    if not fits:
        return min(arms, key=policy.size_of)
    return max(fits, key=lambda a: (policy.metric_of(a),
                                    -policy.size_of(a)))


@register_sweep_policy("min_size_at_precision")
def _min_size_at_precision(policy: SweepPolicy, arms):
    ok = [a for a in arms if policy.metric_of(a) >= policy.precision_floor]
    if not ok:
        return max(arms, key=policy.metric_of)
    return min(ok, key=lambda a: (policy.size_of(a),
                                  -policy.metric_of(a)))
