"""DiSMEC training on one GPU: Algorithm 1's layer-2 engine.

Paper Algorithm 1 has two layers of parallelism:

  layer 1 — label batches over nodes: the sequential (or leased,
            multi-process) batch loop of train/xmc.py (`XMCTrainJob`);
  layer 2 — one label per core: here one batched TRON loop
            (core/tron.py) over a whole label batch on the card.

X is never replicated per label (paper §2.1): every binary problem of a
batch shares one device buffer. `make_batch_solver` is the reusable layer-2
solve (signs in, Delta-pruned weights out) behind `train` and the streaming
scheduler. The obj-grad/Hv pair comes from a solver-ops registry whose
kinds keep the JAX package's names, so a spec written by either package
means the same thing in both:

  "jnp"    — core/losses.py on `torch.matmul`, the plain solver ops;
  "pallas" — kernels/hinge and kernels/hvp, which launch the CUDA kernels
             (csrc/hinge.cu, csrc/hvp.cu) for CUDA tensors.

Both speak core/tron.py's margin-caching protocol: `obj_grad(W) -> (f,
grad, act)` derives the active mask from the score pass it already ran,
and `hvp(V, act)` consumes it. Sharding the label or instance axis over
several GPUs (the JAX package's `mesh` / `shard_data`) is not ported yet
(ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.pruning import prune
from repro_torch.core.tron import TronResult, tron_solve


@dataclasses.dataclass(frozen=True)
class DiSMECConfig:
    """Hyper-parameters of Algorithm 1 (the JAX package's fields)."""
    C: float = 1.0               # error/regularization trade-off (Eq. 2.2)
    delta: float = 0.01          # ambiguity threshold Delta (paper fixes 0.01)
    eps: float = 0.01            # TRON relative gradient tolerance
    max_newton: int = 50
    max_cg: int = 40
    label_batch: int = 1000      # paper's per-node batch size (layer 1)
    use_pallas: bool = False     # route obj/grad + Hv through the kernels
    # The JAX package's Pallas mode; kept so specs round-trip. The port's
    # kernels run on the card, their plain versions on the CPU.
    pallas_interpret: Optional[bool] = None
    # Solver-ops registry kind; None derives it from `use_pallas`.
    ops: Optional[str] = None

    def ops_kind(self) -> str:
        return self.ops or ("pallas" if self.use_pallas else "jnp")


# kind -> factory(X, S, cfg) -> (obj_grad, hvp), the margin-caching pair.
SOLVER_OPS: dict[str, Callable] = {}


def register_solver_ops(kind: str):
    """Decorator: plug an obj-grad/Hv implementation into the solver. The
    factory receives (X (N, D), S (L, N), cfg) and returns the pair; select
    it with `DiSMECConfig(ops=kind)` / `SolverSpec(ops=kind)`."""
    def deco(factory):
        if kind in SOLVER_OPS:
            raise ValueError(f"solver ops {kind!r} already registered")
        SOLVER_OPS[kind] = factory
        return factory
    return deco


def available_solver_ops() -> tuple[str, ...]:
    return tuple(sorted(SOLVER_OPS))


@register_solver_ops("jnp")
def _plain_solver_ops(X: torch.Tensor, S: torch.Tensor, cfg: DiSMECConfig):
    obj_grad = lambda W: losses.objective_grad_act(W, X, S, cfg.C)  # noqa
    hvp = lambda V, act: losses.hessian_vp(V, X, act, cfg.C)        # noqa
    return obj_grad, hvp


@register_solver_ops("pallas")
def _kernel_solver_ops(X: torch.Tensor, S: torch.Tensor, cfg: DiSMECConfig):
    from repro_torch.kernels.hinge import ops as hinge_ops
    from repro_torch.kernels.hvp import ops as hvp_ops
    obj_grad = lambda W: hinge_ops.objective_grad_act(W, X, S,  # noqa: E731
                                                      cfg.C)
    hvp = lambda V, act: hvp_ops.hessian_vp(V, X, act, cfg.C)   # noqa: E731
    return obj_grad, hvp


def _make_fns(X: torch.Tensor, S: torch.Tensor, cfg: DiSMECConfig):
    """The (obj_grad, hvp) pair of the registered kind `cfg.ops_kind()`."""
    kind = cfg.ops_kind()
    try:
        factory = SOLVER_OPS[kind]
    except KeyError:
        raise ValueError(f"unknown solver ops {kind!r}; registered kinds: "
                         f"{available_solver_ops()}") from None
    return factory(X, S, cfg)


@dataclasses.dataclass
class DiSMECModel:
    """Learnt matrix W (L, D) (the paper's W transposed), stored pruned:
    exact zeros where |w| < delta."""
    W: torch.Tensor
    delta: float
    n_labels: int               # true L before padding

    @property
    def nnz(self) -> int:
        return int((self.W != 0.0).sum())

    def size_bytes(self, bytes_per_weight: int = 8) -> int:
        """Sparse storage cost: (value, index) pairs, as the paper counts."""
        return self.nnz * bytes_per_weight


def signs_from_labels(Y: torch.Tensor) -> torch.Tensor:
    """Y (N, L) in {0,1} -> S (L, N) in {+1,-1} (paper's s_l vectors)."""
    return (2.0 * Y.T.float() - 1.0).float()


def train_label_batch(X: torch.Tensor, S: torch.Tensor, cfg: DiSMECConfig,
                      W0: Optional[torch.Tensor] = None) -> TronResult:
    """Solve all labels in S at once (layer 2). A non-None W0 is a warm
    start: the relative stopping rule is anchored at the cold-start
    gradient ||g(0)|| (one extra obj/grad evaluation)."""
    L = S.shape[0]
    D = X.shape[1]
    obj_grad, hvp = _make_fns(X, S, cfg)
    gnorm_ref = None
    if W0 is None:
        W0 = torch.zeros((L, D), dtype=torch.float32, device=X.device)
    else:
        _, g_zero, _ = obj_grad(torch.zeros_like(W0))
        gnorm_ref = torch.linalg.vector_norm(g_zero, dim=-1)
    return tron_solve(obj_grad, hvp, W0, eps=cfg.eps,
                      max_newton=cfg.max_newton, max_cg=cfg.max_cg,
                      gnorm_ref=gnorm_ref)


def train(X, Y, cfg: DiSMECConfig = DiSMECConfig(), *,
          device=None) -> DiSMECModel:
    """Algorithm 1 on one device: sequential label batches, batched TRON
    per batch, Delta-pruning per batch, assembled in memory. A thin adapter
    over the spec path (`repro_torch.xmc_api`); use `fit` to stream the
    batches to a servable checkpoint instead."""
    from repro_torch.xmc_api import job_from_spec, spec_from_config
    return job_from_spec(spec_from_config(cfg)).run(X, Y,
                                                    device=device).model


def balance_permutation(Y, n_shards: int) -> np.ndarray:
    """Frequency-balanced label -> shard assignment (beyond the paper).

    The batched TRON loop runs until the slowest label of a shard
    converges, and head labels take more Newton steps than tail labels.
    Greedy capacity-constrained balancing (LPT): biggest label first,
    always into the lightest shard with room. Returns `perm` with label
    perm[i] in slot i (shards are contiguous slot blocks)."""
    counts = np.asarray(Y).sum(axis=0)
    order = np.argsort(-counts, kind="stable")       # head labels first
    per = (len(order) + n_shards - 1) // n_shards
    mass = np.zeros(n_shards)
    members: list[list[int]] = [[] for _ in range(n_shards)]
    for lab in order:
        open_shards = [s for s in range(n_shards) if len(members[s]) < per]
        s = min(open_shards, key=lambda i: (mass[i], i))
        members[s].append(int(lab))
        mass[s] += counts[lab]
    return np.asarray([lab for m in members for lab in m], dtype=np.int64)


def make_batch_solver(X: torch.Tensor, cfg: DiSMECConfig, mesh=None, *,
                      shard_data: bool = False, warm: bool = False):
    """Layer 2 of Algorithm 1 as a reusable solver: (S (rows, N), W0 (rows,
    D) or None) -> Delta-pruned W (rows, D), on X's device.

    warm=True: the solver expects warm-start W0s (a prior checkpoint's
    rows) and anchors TRON's relative stopping rule at ||g(0)||, the
    cold-start tolerance, with one extra obj/grad evaluation at W = 0 per
    batch; without it a warm W0's small gradient would tighten the
    tolerance and un-converge every label.

    Only the single-device solve is ported: a `mesh` or `shard_data=True`
    raises NotImplementedError (multi-GPU sharding is ROADMAP Queue A
    item 6).
    """
    if mesh is not None or shard_data:
        raise NotImplementedError(
            "make_batch_solver: label/instance sharding over several GPUs "
            "(mesh, shard_data) is not ported yet; see ROADMAP Queue A "
            "item 6 (multi-GPU)")
    X = X.float().contiguous()
    D = X.shape[1]

    def solve(S: torch.Tensor, W0: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        S = S.to(X.device, torch.float32).contiguous()
        obj_grad, hvp = _make_fns(X, S, cfg)
        ref = None
        if W0 is None:
            W0 = torch.zeros((S.shape[0], D), dtype=torch.float32,
                             device=X.device)
        else:
            W0 = W0.to(X.device, torch.float32)
            if warm:
                _, g_zero, _ = obj_grad(torch.zeros_like(W0))
                ref = torch.linalg.vector_norm(g_zero, dim=-1)
        res = tron_solve(obj_grad, hvp, W0, eps=cfg.eps,
                         max_newton=cfg.max_newton, max_cg=cfg.max_cg,
                         gnorm_ref=ref)
        return prune(res.W, cfg.delta)                  # step 7 on the card
    return solve
