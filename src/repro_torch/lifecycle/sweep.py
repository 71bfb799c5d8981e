"""Warm-start sweep sessions: DiSMEC's Fig. 5 as one call, not a script.

The paper's capacity-control story is a sweep: train once, then re-train
under different Delta (and C) values and read the model-size/precision
frontier. The repo already has every primitive — `fit(init_from=...)`
warm-starts from a prior checkpoint (bit-identical fixed point for an
unchanged spec), each out_dir is its own lease-aware manifest, and the
serving engines report exact model sizes. `sweep()` composes them:

    base arm   fit(X, Y, base_spec, out_root/base)           (cold)
    arm i      fit(X, Y, spec_i,    out_root/<name>, init_from=base)

Arms fan out over a pool of `workers` threads; each arm is an independent
manifest, so per-arm multi-host scaling still works by pointing extra
`fit` processes at that arm's out_dir (the lease table coordinates them,
regardless of what `sweep` is doing). Arm results are deterministic
in (spec, data) — worker count and scheduling order never change any
checkpoint byte, which `tests/test_torch_lifecycle.py` pins.

The **fixed-point check** is the correctness anchor: an arm whose
canonical solver+schedule equals the base's must reproduce the base
checkpoint bit-for-bit (warm start from a converged model re-derives it).
`sweep` verifies this on every such arm and records it in the report; a
False there means the warm-start path drifted and every other arm's
numbers are suspect.

The `SweepReport` carries per-arm model_mb (fp32 (value, index) pairs,
the fig5 accounting) / int8_mb (serving payload) / nnz fraction / holdout
P@k, and a declarative `SweepPolicy` (repro_torch.specs) picks the winner —
feed it to `ModelRouter.refresh` and the sweep becomes a deployment.

A port of the JAX package's module of the same name: every fit and every
engine runs on `device` (None: the card). The fixed point holds on the
card too, the training kernels summing in a fixed order with no atomics.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy
from repro_torch.specs import ServeSpec, SweepPolicy


@dataclasses.dataclass
class SweepArm:
    """One fitted sweep arm and its frontier coordinates."""
    name: str
    out_dir: str
    spec: object                       # XMCSpec
    C: float
    delta: float
    nnz: int
    nnz_frac: float                    # nnz / (L * D)
    model_mb: float                    # fp32 (value, index) pairs, fig5 style
    int8_mb: float                     # int8 serving payload (+ scales etc.)
    n_blocks: int
    metrics: dict                      # {"P@1": ..., "nDCG@5": ...} or {}
    train_s: float
    warm_started: bool
    fixed_point: Optional[bool] = None  # bit-identical to base (same-spec
    #                                     arms only; None otherwise)

    def row(self) -> dict:
        """JSON-ready summary (spec collapsed to its dict form)."""
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        return d


@dataclasses.dataclass
class SweepReport:
    """Everything a sweep produced: arms (base first), policy, winner."""
    out_root: str
    policy: SweepPolicy
    arms: list                          # [SweepArm, ...]; arms[0] is base
    winner: str                         # arm name the policy selected

    @property
    def base(self) -> SweepArm:
        return self.arms[0]

    def arm(self, name: str) -> SweepArm:
        for a in self.arms:
            if a.name == name:
                return a
        raise KeyError(f"no sweep arm {name!r}; have "
                       f"{[a.name for a in self.arms]}")

    @property
    def winner_dir(self) -> str:
        """Checkpoint directory of the winning arm — hand this to
        `ModelRouter.refresh` / `CheckpointHandle.open` to deploy it."""
        return self.arm(self.winner).out_dir

    def to_dict(self) -> dict:
        return {"out_root": self.out_root,
                "policy": self.policy.to_dict(),
                "winner": self.winner,
                "arms": [a.row() for a in self.arms]}


def models_bit_identical(dir_a: str, dir_b: str) -> bool:
    """True iff two checkpoints hold byte-for-byte the same packed model
    (blocks, block coordinates, row_ptr, shapes). The warm-start
    fixed-point test, as an equality instead of an assertion. Read on the
    host."""
    from repro_torch.checkpoint.io import load_block_sparse  # no cycle
    a, _ = load_block_sparse(dir_a, device="cpu")
    b, _ = load_block_sparse(dir_b, device="cpu")
    if (a.shape != b.shape or a.block_shape != b.block_shape
            or a.orig_shape != b.orig_shape):
        return False
    return all(np.array_equal(to_numpy(x), to_numpy(y))
               for x, y in ((a.blocks, b.blocks),
                            (a.block_rows, b.block_rows),
                            (a.block_cols, b.block_cols),
                            (a.row_ptr, b.row_ptr)))


def _arm_spec(base_spec, variation):
    """An arm's full spec: an explicit XMCSpec passes through; a dict is
    solver-field overrides on the base (the common Delta/C sweep form)."""
    if isinstance(variation, dict):
        return base_spec.replace(
            solver=base_spec.solver.replace(**variation))
    return variation


def _same_solution(spec_a, spec_b) -> bool:
    """Whether two specs pin the same solved weights: canonical solver +
    schedule equal (serving and runtime knobs never touch the solution)."""
    ca, cb = spec_a.normalized().canonical(), spec_b.normalized().canonical()
    return ca.solver == cb.solver and ca.schedule == cb.schedule


def _measure_arm(name, handle, spec, *, holdout, eval_ks, train_s,
                 warm_started) -> SweepArm:
    """Frontier coordinates of one fitted arm, from its checkpoint."""
    from repro_torch.checkpoint.io import load_block_sparse_int8
    model, meta = handle.model()
    int8_model, _ = load_block_sparse_int8(handle.directory, model=model)
    blocks = to_numpy(model.blocks)
    n_nz = int(np.count_nonzero(blocks))
    L, D = model.orig_shape
    metrics: dict = {}
    if holdout is not None:
        Xh, Yh = holdout
        engine = handle.engine(ServeSpec(
            backend="bsr", k=max(eval_ks), warmup=False))
        labels = engine.serve([np.asarray(Xh, np.float32)])[0].labels
        from repro_torch.core.prediction import evaluate
        metrics = evaluate(torch.as_tensor(np.asarray(Yh)),
                           torch.as_tensor(labels), ks=eval_ks)
    return SweepArm(
        name=name, out_dir=handle.directory, spec=spec,
        C=float(spec.solver.C), delta=float(spec.solver.delta),
        nnz=n_nz, nnz_frac=n_nz / float(L * D),
        model_mb=n_nz * 8 / 1e6,                 # (value, index) pairs
        int8_mb=int8_model.payload_bytes() / 1e6,
        n_blocks=int(model.n_blocks),
        metrics=metrics, train_s=train_s, warm_started=warm_started)


def sweep(X, Y, base_spec, variations: dict[str, Union[dict, object]],
          out_root: str, *, workers: int = 1,
          policy: Optional[SweepPolicy] = None,
          holdout: Optional[tuple] = None,
          eval_ks: tuple[int, ...] = (1, 3, 5),
          resume: bool = True, device=None) -> SweepReport:
    """Fit a warm-start sweep and pick a winner.

    X, Y       : training data, as `fit` takes them.
    base_spec  : the anchor experiment; fitted (cold) into
                 `out_root/base` first, then every arm warm-starts from
                 it (`fit(..., init_from=<base dir>)`).
    variations : arm name -> either a dict of `SolverSpec` overrides
                 (`{"delta": 0.05}` — the Fig. 5 form) or a full XMCSpec.
                 Each arm trains into `out_root/<name>`.
    workers    : arms fitted concurrently by `sweep`. Results are
                 deterministic in (spec, data) — the worker count and
                 completion order cannot change a checkpoint byte. For
                 *within-arm* multi-host scaling, point extra `fit`
                 processes at an arm's out_dir; its lease table does the
                 rest.
    policy     : declarative winner rule (`repro_torch.specs.SweepPolicy`);
                 default picks max precision when a holdout is given,
                 else the smallest model (without labels there is nothing
                 else to rank by).
    holdout    : optional (X_test, Y_test) — per-arm P@k / nDCG@k on it.
    eval_ks    : precision depths to evaluate.
    resume     : passed to every `fit` — a killed sweep re-run skips
                 arms/batches already in their manifests.
    device     : where every fit solves and every arm is served (None:
                 the card; "cpu" runs the plain versions of the kernels).

    Any arm whose canonical solver+schedule equals the base's gets the
    warm-start **fixed-point check**: its checkpoint must be bit-identical
    to the base (`SweepArm.fixed_point`).
    """
    if "base" in variations:
        raise ValueError("arm name 'base' is reserved for the warm-start "
                         "source")
    for name in variations:
        if not name or os.sep in name or name != name.strip():
            raise ValueError(f"arm name {name!r} must be a plain directory "
                             "name")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if policy is None:
        policy = (SweepPolicy(kind="max_precision",
                              metric=f"P@{max(eval_ks)}")
                  if holdout is not None else SweepPolicy(kind="min_size"))
    policy.validate()
    device = resolve_device(device)

    from repro_torch.xmc_api import fit          # deferred: no cycle
    base_dir = os.path.join(out_root, "base")
    t0 = time.monotonic()
    base_handle = fit(X, Y, base_spec, base_dir, resume=resume,
                      device=device)
    base_arm = _measure_arm(
        "base", base_handle, base_spec, holdout=holdout, eval_ks=eval_ks,
        train_s=time.monotonic() - t0, warm_started=False)

    specs = {name: _arm_spec(base_spec, v) for name, v in variations.items()}

    def run_arm(name: str) -> SweepArm:
        spec = specs[name]
        t_arm = time.monotonic()
        handle = fit(X, Y, spec, os.path.join(out_root, name),
                     init_from=base_dir, resume=resume, device=device)
        arm = _measure_arm(name, handle, spec, holdout=holdout,
                           eval_ks=eval_ks,
                           train_s=time.monotonic() - t_arm,
                           warm_started=True)
        if _same_solution(spec, base_spec):
            arm.fixed_point = models_bit_identical(handle.directory,
                                                   base_dir)
        return arm

    names = list(variations)
    if workers == 1 or len(names) <= 1:
        arms = [run_arm(n) for n in names]
    else:
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="sweep-arm") as pool:
            arms = list(pool.map(run_arm, names))

    all_arms = [base_arm] + arms
    winner = policy.select(all_arms).name
    return SweepReport(out_root=out_root, policy=policy, arms=all_arms,
                       winner=winner)
