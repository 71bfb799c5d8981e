"""DiSMEC training: Algorithm 1's layer-2 engine, on one device or a mesh.

Paper Algorithm 1 has two layers of parallelism:

  layer 1 — label batches over nodes: the sequential (or leased,
            multi-process) batch loop of train/xmc.py (`XMCTrainJob`);
  layer 2 — one label per core: here one batched TRON loop
            (core/tron.py) over a whole label batch on the card.

X is never replicated per label (paper §2.1): every binary problem of a
batch shares one device buffer. `make_batch_solver` is the reusable layer-2
solve (signs in, Delta-pruned weights out) behind `train`,
`train_sharded` and the streaming scheduler. The obj-grad/Hv pair comes
from a solver-ops registry whose kinds keep the JAX package's names, so a
spec written by either package means the same thing in both:

  "jnp"    — core/losses.py on `torch.matmul`, the plain solver ops;
  "pallas" — kernels/hinge and kernels/hvp, which launch the CUDA kernels
             (csrc/hinge.cu, csrc/hvp.cu) for CUDA tensors.

Both speak core/tron.py's margin-caching protocol: `obj_grad(W) -> (f,
grad, act)` derives the active mask from the score pass it already ran,
and `hvp(V, act)` consumes it.

On a mesh (`launch/mesh.py`, a grid of devices with axes "data" and
"model") the batch's labels are split into one contiguous shard per
column of the grid, each solved by its own TRON loop on a thread of its
own, and gathered in shard order on the mesh's first device. With
`shard_data=False` (the paper's layout) each label shard runs the
registered solver ops on its own device, over all of X. With
`shard_data=True` the instances are split over the data axis as well:
each label shard computes its objective, gradient and Hessian-vector
partial sums on every data device and adds them in the fixed order d = 0,
1, ... on its first device, so the result is deterministic. Those
closures are the JAX package's psum closures in torch ops (the JAX
package computes them in jnp, outside any Pallas kernel). X is placed once
per distinct device of the grid; a device may repeat in the grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
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


def solver_x(X, cfg: DiSMECConfig, device=None) -> torch.Tensor:
    """X (N, D), a tensor or an array, as float32 on `device` (X's own when
    None) in the layout the solver ops of `cfg` read in place: rows that
    start 16-byte aligned for the kernels on the card (`aligned_rows`; a
    host array goes over in pieces, with no second device copy),
    contiguous otherwise. Placed once per solver, so no launch copies X."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X))
    dev = X.device if device is None else torch.device(device)
    if dev.type == "cuda" and cfg.ops_kind() == "pallas":
        from repro_torch.kernels.hinge.ops import aligned_rows
        return aligned_rows(X, dev)
    return X.to(dev, torch.float32).contiguous()


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
    X = solver_x(X, cfg)
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


def _run_tron(obj_grad, hvp, W0: torch.Tensor, cfg: DiSMECConfig,
              anchor: bool) -> torch.Tensor:
    """One batched TRON solve from W0, Delta-pruned on its device. With
    `anchor` the relative stopping rule is anchored at ||g(0)||."""
    ref = None
    if anchor:
        _, g_zero, _ = obj_grad(torch.zeros_like(W0))
        ref = torch.linalg.vector_norm(g_zero, dim=-1)
    res = tron_solve(obj_grad, hvp, W0, eps=cfg.eps,
                     max_newton=cfg.max_newton, max_cg=cfg.max_cg,
                     gnorm_ref=ref)
    return prune(res.W, cfg.delta)                      # step 7 on-device


def make_batch_solver(X, cfg: DiSMECConfig, mesh=None, *,
                      label_axis: str = "model", data_axis: str = "data",
                      shard_data: bool = False, warm: bool = False,
                      device=None):
    """Layer 2 of Algorithm 1 as a reusable solver: (S (rows, N), W0 (rows,
    D) or None) -> Delta-pruned W (rows, D).

    mesh=None        : one batched TRON on `device` (X's own when None),
                       X placed once in the solver ops' layout
                       (`solver_x`).
    shard_data=False : X on each label shard's device (once per distinct
                       device), the registered solver ops per shard; rows
                       must be a multiple of the mesh's label-axis extent.
    shard_data=True  : X's rows split over the data axis as well (see the
                       module docstring). N not divisible by the data axis
                       is padded with zero rows of X and -1 columns of S:
                       a zero instance adds nothing to the gradient or the
                       Hessian-vector product, and its constant C (z = 1,
                       active) is subtracted from f, so the padded
                       objective is exactly the unpadded one.
    warm=True        : the solver expects warm-start W0s (a prior
                       checkpoint's rows) and anchors TRON's relative
                       stopping rule at ||g(0)||, the cold-start
                       tolerance, with one extra obj/grad evaluation at W
                       = 0 per batch; without it a warm W0's small
                       gradient would tighten the tolerance and
                       un-converge every label.

    A mesh returns the result on its first device; a shard's exception
    propagates to the caller.
    """
    if mesh is not None:
        return _meshed_solver(X, cfg, mesh, label_axis=label_axis,
                              data_axis=data_axis, shard_data=shard_data,
                              warm=warm)
    X = solver_x(X, cfg, device)
    D = X.shape[1]

    def solve(S: torch.Tensor, W0: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        S = S.to(X.device, torch.float32).contiguous()
        obj_grad, hvp = _make_fns(X, S, cfg)
        if W0 is None:
            W0 = torch.zeros((S.shape[0], D), dtype=torch.float32,
                             device=X.device)
            return _run_tron(obj_grad, hvp, W0, cfg, False)
        return _run_tron(obj_grad, hvp, W0.to(X.device, torch.float32),
                         cfg, warm)
    return solve


def _place_rows(X, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of X padded with zero rows past its end, as a
    contiguous float32 tensor on `device`."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X))
    out = torch.zeros((hi - lo, X.shape[1]), dtype=torch.float32,
                      device=device)
    real = max(0, min(hi, X.shape[0]) - lo)
    if real:
        out[:real].copy_(X[lo:lo + real])
    return out


def _data_sharded_ops(pieces, C: float, n_pad: int, home: torch.device):
    """The margin-caching pair over instance pieces [(X_i, S_i)], each on
    its own device, in data order: every partial sum is taken on its
    piece's device and added on `home` in the order d = 0, 1, ... The
    active payload is the tuple of the pieces' local masks."""
    def obj_grad(W):
        f_sum = g_sum = None
        acts = []
        for X_i, S_i in pieces:
            W_i = W.to(X_i.device)
            scores = W_i @ X_i.T
            z = 1.0 - S_i * scores
            act = (z > 0.0).to(scores.dtype)
            r = act * (scores - S_i)
            f_loc = (C * (act * z * z).sum(-1)).to(home)
            g_loc = (2.0 * C * (r @ X_i)).to(home)
            f_sum = f_loc if f_sum is None else f_sum + f_loc
            g_sum = g_loc if g_sum is None else g_sum + g_loc
            acts.append(act)
        f = (W * W).sum(-1) + f_sum - C * n_pad
        return f, 2.0 * W + g_sum, tuple(acts)

    def hvp(V, act):
        total = None
        for (X_i, _), a in zip(pieces, act):
            loc = (2.0 * C * ((a * (V.to(X_i.device) @ X_i.T)) @ X_i)
                   ).to(home)
            total = loc if total is None else total + loc
        return 2.0 * V + total
    return obj_grad, hvp


def _meshed_solver(X, cfg: DiSMECConfig, mesh, *, label_axis: str,
                   data_axis: str, shard_data: bool, warm: bool):
    """`make_batch_solver` on a mesh: one TRON loop per label shard (a
    column of the grid), each on a thread of its own."""
    n_shards = mesh.shape[label_axis]
    n_data = mesh.shape[data_axis] if shard_data else 1
    # cells[j][i]: the device of label shard j's data piece i.
    cells = [[mesh.device(**{label_axis: j, data_axis: i})
              for i in range(n_data)] for j in range(n_shards)]
    N, D = X.shape
    n_pad = (-N) % n_data
    n_loc = (N + n_pad) // n_data
    if not shard_data:
        placed = {}
        for col in cells:
            if col[0] not in placed:
                placed[col[0]] = solver_x(X, cfg, col[0])
        x_of = [[placed[col[0]]] for col in cells]
    else:
        # Each distinct device holds the hull of the pieces it serves,
        # once; the pieces are views of it.
        need: dict[torch.device, list[int]] = {}
        for col in cells:
            for i, dev in enumerate(col):
                need.setdefault(dev, []).append(i)
        held = {dev: (min(ix), _place_rows(X, min(ix) * n_loc,
                                           (max(ix) + 1) * n_loc, dev))
                for dev, ix in need.items()}
        x_of = [[held[dev][1][(i - held[dev][0]) * n_loc:
                              (i - held[dev][0] + 1) * n_loc]
                 for i, dev in enumerate(col)] for col in cells]

    def solve_shard(j: int, S_j: torch.Tensor,
                    W0_j: Optional[torch.Tensor]) -> torch.Tensor:
        home = cells[j][0]
        with (torch.cuda.device(home) if home.type == "cuda"
              else contextlib.nullcontext()):
            anchor = warm and W0_j is not None
            W0_j = (torch.zeros((S_j.shape[0], D), dtype=torch.float32,
                                device=home) if W0_j is None
                    else W0_j.to(home, torch.float32))
            if not shard_data:
                obj_grad, hvp = _make_fns(
                    x_of[j][0], S_j.to(home, torch.float32).contiguous(),
                    cfg)
            else:
                if n_pad:
                    S_j = torch.cat([S_j, -torch.ones(
                        (S_j.shape[0], n_pad), dtype=S_j.dtype,
                        device=S_j.device)], dim=1)
                pieces = [(x_of[j][i], S_j[:, i * n_loc:(i + 1) * n_loc]
                           .to(dev, torch.float32).contiguous())
                          for i, dev in enumerate(cells[j])]
                obj_grad, hvp = _data_sharded_ops(pieces, cfg.C, n_pad,
                                                  home)
            return _run_tron(obj_grad, hvp, W0_j, cfg, anchor)

    def solve_meshed(S: torch.Tensor, W0: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        rows = S.shape[0]
        if rows % n_shards:
            raise ValueError(f"{rows} label rows do not split into "
                             f"{n_shards} label shards; pad the batch")
        per = rows // n_shards
        args = [(j, S[j * per:(j + 1) * per],
                 None if W0 is None else W0[j * per:(j + 1) * per])
                for j in range(n_shards)]
        if n_shards == 1:
            outs = [solve_shard(*args[0])]
        else:
            with ThreadPoolExecutor(max_workers=n_shards) as ex:
                futures = [ex.submit(solve_shard, *a) for a in args]
                outs = [f.result() for f in futures]
        return torch.cat([o.to(mesh.first) for o in outs])
    return solve_meshed


def train_sharded(X, Y, cfg: DiSMECConfig, mesh, *,
                  label_axis: str = "model", data_axis: str = "data",
                  shard_data: bool = False,
                  balance: bool = False) -> DiSMECModel:
    """Double parallelization on a mesh: the label-batch loop
    (cfg.label_batch) over the mesh-sharded solve, assembled in memory on
    the mesh's first device. A thin adapter over the spec path, as `train`
    is.

    shard_data=True : instances split over the data axis as well.
    balance=True    : frequency-balanced label shards (`balance_
                      permutation`): labels are dealt and un-dealt, so the
                      solution is the same up to the shards' summation
                      order.
    """
    from repro_torch.xmc_api import job_from_spec, spec_from_config
    spec = spec_from_config(cfg, label_axis=label_axis, data_axis=data_axis,
                            shard_data=shard_data, balance=balance)
    return job_from_spec(spec, mesh=mesh).run(X, Y).model
